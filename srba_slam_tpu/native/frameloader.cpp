// Native stereo frame loader with background prefetch.
//
// Replacement for the I/O role MRPT's CCameraSensor image_dir
// grabber plays in the reference (src/CSRBAStereoSLAMEstimator.cpp:1194-1197,
// frame pull at :44): decodes numbered stereo PNG/PGM pairs off the hot path
// on a worker thread, double-buffering ahead of the consumer so the SLAM loop
// never blocks on disk or PNG inflation.
//
// Exposed as a tiny C ABI consumed from Python via ctypes
// (srba_slam_tpu/native/loader.py). Build: srba_slam_tpu/native/build.sh.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <png.h>

namespace {

struct Frame {
  int index = -1;
  int width = 0;
  int height = 0;
  std::vector<uint8_t> left;   // grayscale 0..255
  std::vector<uint8_t> right;
  bool ok = false;
};

bool decode_png_gray(const char* path, std::vector<uint8_t>* out, int* w, int* h) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  std::vector<png_byte> row(png_get_rowbytes(png, info));
  out->resize(static_cast<size_t>(width) * height);
  for (png_uint_32 y = 0; y < height; ++y) {
    png_read_row(png, row.data(), nullptr);
    std::memcpy(out->data() + static_cast<size_t>(y) * width, row.data(),
                width);
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  *w = static_cast<int>(width);
  *h = static_cast<int>(height);
  return true;
}

bool decode_pgm(const char* path, std::vector<uint8_t>* out, int* w, int* h) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  char magic[3] = {0};
  int width, height, maxval;
  if (std::fscanf(fp, "%2s %d %d %d", magic, &width, &height, &maxval) != 4 ||
      std::strcmp(magic, "P5") != 0) {
    std::fclose(fp);
    return false;
  }
  std::fgetc(fp);  // single whitespace after maxval
  std::vector<uint8_t> buf(static_cast<size_t>(width) * height);
  if (std::fread(buf.data(), 1, buf.size(), fp) != buf.size()) {
    std::fclose(fp);
    return false;
  }
  std::fclose(fp);
  *out = std::move(buf);
  *w = width;
  *h = height;
  return true;
}

bool decode_any(const std::string& path, std::vector<uint8_t>* out, int* w, int* h) {
  if (path.size() >= 4 && path.compare(path.size() - 4, 4, ".pgm") == 0)
    return decode_pgm(path.c_str(), out, w, h);
  return decode_png_gray(path.c_str(), out, w, h);
}

class Prefetcher {
 public:
  Prefetcher(std::string dir, std::string left_fmt, std::string right_fmt,
             int start, int end, int queue_depth)
      : dir_(std::move(dir)),
        left_fmt_(std::move(left_fmt)),
        right_fmt_(std::move(right_fmt)),
        end_(end),
        depth_(queue_depth > 0 ? queue_depth : 4),
        next_(start) {
    worker_ = std::thread([this] { Run(); });
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    worker_.join();
  }

  // Returns nullptr when the sequence is exhausted.
  std::unique_ptr<Frame> Next() {
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait(lk, [this] { return !queue_.empty() || done_; });
    if (queue_.empty()) return nullptr;
    auto f = std::move(queue_.front());
    queue_.pop_front();
    cv_.notify_all();
    return f;
  }

 private:
  std::string PathFor(const std::string& fmt, int i) {
    char buf[1024];
    std::snprintf(buf, sizeof(buf), fmt.c_str(), i);
    return dir_.empty() ? std::string(buf) : dir_ + "/" + buf;
  }

  void Run() {
    for (int i = next_;; ++i) {
      if (end_ > 0 && i > end_) break;
      auto f = std::make_unique<Frame>();
      f->index = i;
      int w2, h2;
      if (!decode_any(PathFor(left_fmt_, i), &f->left, &f->width, &f->height) ||
          !decode_any(PathFor(right_fmt_, i), &f->right, &w2, &h2) ||
          w2 != f->width || h2 != f->height)
        break;
      f->ok = true;
      std::unique_lock<std::mutex> lk(mu_);
      cv_.wait(lk, [this] {
        return stop_ || queue_.size() < static_cast<size_t>(depth_);
      });
      if (stop_) return;
      queue_.push_back(std::move(f));
      cv_.notify_all();
    }
    std::lock_guard<std::mutex> lk(mu_);
    done_ = true;
    cv_.notify_all();
  }

  std::string dir_, left_fmt_, right_fmt_;
  int end_, depth_, next_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<std::unique_ptr<Frame>> queue_;
  std::thread worker_;
  bool stop_ = false;
  bool done_ = false;
};

}  // namespace

// one in-flight frame between fl_next and fl_copy (single-consumer API)
static thread_local std::unique_ptr<Frame> pending_;

extern "C" {

void* fl_open(const char* dir, const char* left_fmt, const char* right_fmt,
              int start, int end, int queue_depth) {
  return new Prefetcher(dir, left_fmt, right_fmt, start, end, queue_depth);
}

// Returns 1 and fills (index, width, height) if a frame is available; caller
// then claims the pixel data with fl_copy. Returns 0 at end of sequence.
int fl_next(void* handle, int* index, int* width, int* height) {
  auto* p = static_cast<Prefetcher*>(handle);
  auto f = p->Next();
  if (!f) return 0;
  pending_ = std::move(f);
  *index = pending_->index;
  *width = pending_->width;
  *height = pending_->height;
  return 1;
}

// Frames are handed to Python as native 8-bit grayscale (device programs
// cast on the device; keeping the host copy at 1 byte/px quarters the
// host->device bytes).
void fl_copy(void* handle, uint8_t* left_out, uint8_t* right_out) {
  (void)handle;
  if (!pending_) return;
  std::memcpy(left_out, pending_->left.data(), pending_->left.size());
  std::memcpy(right_out, pending_->right.data(), pending_->right.size());
  pending_.reset();
}

void fl_close(void* handle) { delete static_cast<Prefetcher*>(handle); }

}  // extern "C"
