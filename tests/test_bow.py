import numpy as np
import jax.numpy as jnp
import pytest

from srba_slam_tpu.models.bow import BoWDatabase, Vocabulary
from srba_slam_tpu.ops import bits as bitops


def _rand_packed(rng, n):
    return jnp.asarray(rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32))


def _flip_bits(rng, desc, k):
    bits = np.asarray(bitops.unpack_bits(desc)).copy()
    for i in range(bits.shape[0]):
        idx = rng.choice(256, size=k, replace=False)
        bits[i, idx] ^= 1
    return bitops.pack_bits(jnp.asarray(bits))


@pytest.fixture(scope="module")
def voc():
    rng = np.random.default_rng(0)
    train = np.asarray(
        rng.integers(0, 2**32, size=(2000, 8), dtype=np.uint64).astype(np.uint32)
    )
    return Vocabulary.train(train, k=4, L=3, seed=1)


def test_train_vocabulary(voc):
    assert voc.n_words > 10
    assert voc.n_pad % 128 == 0
    assert (voc.weights[: voc.n_words] > 0).all()
    assert voc.weights[voc.n_words:].sum() == 0


def test_bow_vector_normalized(voc):
    rng = np.random.default_rng(2)
    db = BoWDatabase(voc, max_kfs=16)
    desc = _rand_packed(rng, 64)
    v = np.asarray(db.compute_bow(desc, jnp.ones(64, bool)))
    assert abs(v.sum() - 1.0) < 1e-5
    assert (v >= 0).all()


def test_self_query_is_top_with_score_1(voc):
    rng = np.random.default_rng(3)
    db = BoWDatabase(voc, max_kfs=16)
    frames = [_rand_packed(rng, 64) for _ in range(5)]
    valid = jnp.ones(64, bool)
    for f in frames:
        db.insert(f, valid)
    s, i = db.query(frames[2], valid, max_results=4)
    assert i[0] == 2
    np.testing.assert_allclose(s[0], 1.0, atol=1e-5)
    assert s[1] <= s[0]


def test_noisy_revisit_ranks_first(voc):
    rng = np.random.default_rng(4)
    db = BoWDatabase(voc, max_kfs=16)
    frames = [_rand_packed(rng, 64) for _ in range(6)]
    valid = jnp.ones(64, bool)
    for f in frames:
        db.insert(f, valid)
    noisy = _flip_bits(rng, frames[1], 10)  # revisit of KF 1 with noise
    s, i = db.query(noisy, valid, max_results=3)
    assert i[0] == 1
    assert s[0] > s[1] + 0.05


def test_query_ignores_unfilled_slots(voc):
    rng = np.random.default_rng(5)
    db = BoWDatabase(voc, max_kfs=16)
    db.insert(_rand_packed(rng, 64), jnp.ones(64, bool))
    s, i = db.query(_rand_packed(rng, 64), jnp.ones(64, bool), max_results=4)
    assert i[0] == 0
    assert (s[1:] == -1.0).all()  # only one stored KF


def test_entry_id_equals_kf_id(voc):
    rng = np.random.default_rng(6)
    db = BoWDatabase(voc, max_kfs=8)
    ids = [db.insert(_rand_packed(rng, 32), jnp.ones(32, bool)) for _ in range(4)]
    assert ids == [0, 1, 2, 3]


def test_load_reference_vocabulary_smoke():
    # full parse of the 14MB reference vocabulary; structure checks
    voc = Vocabulary.load_dbow2("/root/reference/demo/voc.yml.gz")
    assert voc.k == 8 and voc.L == 5
    assert voc.n_words == 32273
    assert voc.leaf_bits.shape[1] == 256
    # leaf weights are idf-like: positive for most words
    assert (voc.weights[: voc.n_words] >= 0).all()
    assert (voc.weights[: voc.n_words] > 0).mean() > 0.9
    # descriptors are proper bit arrays
    assert set(np.unique(voc.leaf_bits)) <= {0, 1}


def test_multiframe_vocabulary_beats_single_frame():
    """The fallback vocabulary trained from the first N
    frames' descriptors (estimator ``ensure_vocabulary``, voc_train_frames)
    generalizes better than the old 1-frame bootstrap on the street
    workload: lower quantization distance on UNSEEN frames, and correct
    nearest-keyframe retrieval."""
    from srba_slam_tpu.models.vo import StereoVOEngine
    from srba_slam_tpu.config import VOOptions
    from srba_slam_tpu.utils.framesource import SyntheticSource
    from tests.test_estimator import small_cam

    cam = small_cam()
    frames = list(SyntheticSource(cam, n_frames=14, seed=11, step=0.6,
                                  scene="street"))
    eng = StereoVOEngine(cam, VOOptions(fast_th=12, n_feats=256),
                         capacity=256)
    descs = []
    for l, r in frames:
        eng.process_stereo_pair(l, r)
        f = eng.last_frame()
        descs.append(np.asarray(f.desc_l)[np.asarray(f.m_valid)])

    voc1 = Vocabulary.train(descs[0], k=8, L=3, seed=0)
    multi = np.concatenate(descs[:8])
    vocN = Vocabulary.train(multi, k=8, L=4 if len(multi) >= 2048 else 3,
                            seed=0)

    def mean_quant_dist(voc, desc):
        bits = np.asarray(bitops.unpack_bits(jnp.asarray(desc)), np.int16)
        lb = voc.leaf_bits[: voc.n_words].astype(np.int16)
        d = np.abs(bits[:, None, :] - lb[None, :, :]).sum(-1)
        return float(d.min(axis=1).mean())

    held_out = np.concatenate(descs[10:])
    q1 = mean_quant_dist(voc1, held_out)
    qN = mean_quant_dist(vocN, held_out)
    assert qN < q1, (qN, q1)

    # retrieval on unseen frames: KFs at frames 0/4/8/11, query frame 12 —
    # the multi-frame vocabulary must rank the nearest KF (frame 11) first
    kf_frames = [0, 4, 8, 11]
    db = BoWDatabase(vocN, max_kfs=8)
    for fi in kf_frames:
        d = jnp.asarray(descs[fi])
        db.insert(d, jnp.ones(len(descs[fi]), bool))
    s, ids = db.query(jnp.asarray(descs[12]),
                      jnp.ones(len(descs[12]), bool), max_results=4)
    assert int(ids[0]) == kf_frames.index(11), (s, ids)
