// Native threaded frame loader of the port: decode (PNG/JPEG) -> grayscale
// float -> optional inverse-affine bilinear warp -> ordered ring buffer.
//
// Copy of onepose_tpu/native/frame_loader.cpp (the port keeps its own). The
// reference feeds frames through cv2.imread + cv2.warpAffine on the Python
// thread (src/datasets/normalized_dataset.py:8-44,
//  src/local_feature_2D_detector/local_feature_2D_detector.py:160-186);
// here a C++ worker pool overlaps file IO + decode + warp with device
// compute, and Python receives frames in order via ctypes with zero copies
// beyond the decode buffer.
//
// Semantics contracts (tested against the Python/cv2 paths):
//   - grayscale = BT.601 (0.299 R + 0.587 G + 0.114 B), cv2.IMREAD_GRAYSCALE
//   - warp: out(y, x) = img(A @ (x, y, 1)) with A the OUTPUT->SOURCE 2x3
//     affine, bilinear, zero border, pixel centers at integer coordinates
//     (cv2.warpAffine WARP_INVERSE_MAP | INTER_LINEAR semantics, computed
//     in float rather than cv2's 5-bit fixed point)
//   - output float32 in [0, 1]
//
// Pure C ABI, loaded via ctypes (onepose_tpu_torch/native/frame_loader.py).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <setjmp.h>

namespace {

struct Image {
  int h = 0, w = 0;
  std::vector<float> gray;  // h * w, [0, 1]
};

// ---------------------------------------------------------------- decode

bool decode_png(FILE* f, Image* out) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_stdio(&image, f)) return false;
  image.format = PNG_FORMAT_RGB;  // explicit RGB; BT.601 below for parity
  std::vector<uint8_t> buf(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, buf.data(), 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  out->h = image.height;
  out->w = image.width;
  out->gray.resize(size_t(out->h) * out->w);
  const uint8_t* p = buf.data();
  const float s = 1.0f / 255.0f;
  for (size_t i = 0; i < out->gray.size(); ++i, p += 3) {
    out->gray[i] = (0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2]) * s;
  }
  return true;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

bool decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_GRAYSCALE;  // libjpeg uses BT.601, as cv2 does
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->gray.resize(size_t(out->h) * out->w);
  std::vector<uint8_t> row(out->w);
  const float s = 1.0f / 255.0f;
  JSAMPROW rp = row.data();
  for (int y = 0; y < out->h; ++y) {
    jpeg_read_scanlines(&cinfo, &rp, 1);
    float* dst = out->gray.data() + size_t(y) * out->w;
    for (int x = 0; x < out->w; ++x) dst[x] = row[x] * s;
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_file(const std::string& path, Image* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  uint8_t magic[4] = {0};
  size_t got = std::fread(magic, 1, 4, f);
  std::rewind(f);
  bool ok = false;
  if (got >= 4 && magic[0] == 0x89 && magic[1] == 'P') {
    ok = decode_png(f, out);
  } else if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, out);
  }
  std::fclose(f);
  return ok;
}

// ------------------------------------------------------------------ warp

void warp_affine(const Image& src, const float* A /* 2x3 out->src */,
                 int out_h, int out_w, float* dst) {
  for (int y = 0; y < out_h; ++y) {
    const float sx0 = A[1] * y + A[2];
    const float sy0 = A[4] * y + A[5];
    float* row = dst + size_t(y) * out_w;
    for (int x = 0; x < out_w; ++x) {
      const float sx = A[0] * x + sx0;
      const float sy = A[3] * x + sy0;
      const int x0 = int(std::floor(sx));
      const int y0 = int(std::floor(sy));
      const float wx = sx - x0, wy = sy - y0;
      float acc = 0.0f;
      for (int dy = 0; dy <= 1; ++dy) {
        const int yy = y0 + dy;
        if (yy < 0 || yy >= src.h) continue;
        const float wyy = dy ? wy : 1.0f - wy;
        const float* srow = src.gray.data() + size_t(yy) * src.w;
        for (int dx = 0; dx <= 1; ++dx) {
          const int xx = x0 + dx;
          if (xx < 0 || xx >= src.w) continue;
          acc += srow[xx] * wyy * (dx ? wx : 1.0f - wx);
        }
      }
      row[x] = acc;
    }
  }
}

void resize_copy(const Image& src, int out_h, int out_w, float* dst) {
  if (src.h == out_h && src.w == out_w) {
    std::memcpy(dst, src.gray.data(), sizeof(float) * out_h * out_w);
    return;
  }
  // Identity-scale affine (cv2.resize INTER_LINEAR pixel-center contract:
  // src = (dst + 0.5) * scale - 0.5).
  const float sx = float(src.w) / out_w, sy = float(src.h) / out_h;
  const float A[6] = {sx, 0.0f, 0.5f * sx - 0.5f, 0.0f, sy, 0.5f * sy - 0.5f};
  warp_affine(src, A, out_h, out_w, dst);
}

// ---------------------------------------------------------------- loader

struct Slot {
  std::vector<float> data;
  int src_h = 0, src_w = 0;
  bool ok = false;
  bool ready = false;
};

struct Loader {
  std::vector<std::string> paths;
  std::vector<float> affines;  // n * 6, empty = no warp (resize/native size)
  int out_h = 0, out_w = 0;    // 0 = native size (affines must be empty)
  int queue_cap = 4;

  std::vector<Slot> slots;  // one per frame (data allocated lazily)
  std::atomic<int64_t> next_job{0};
  int64_t next_out = 0;  // consumer cursor
  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits for slot ready
  std::condition_variable cv_window;  // workers wait for window space
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void work() {
    for (;;) {
      if (stop.load()) return;
      const int64_t i = next_job.fetch_add(1);
      if (i >= int64_t(paths.size())) return;
      // Stay within queue_cap frames of the consumer (bounded prefetch).
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_window.wait(lk, [&] {
          return stop.load() || i < next_out + queue_cap;
        });
        if (stop.load()) return;
      }
      Image img;
      bool ok = decode_file(paths[i], &img);
      Slot s;
      s.ok = ok;
      s.src_h = img.h;
      s.src_w = img.w;
      if (ok) {
        const int oh = out_h > 0 ? out_h : img.h;
        const int ow = out_w > 0 ? out_w : img.w;
        s.data.resize(size_t(oh) * ow);
        if (!affines.empty()) {
          warp_affine(img, affines.data() + i * 6, oh, ow, s.data.data());
        } else {
          resize_copy(img, oh, ow, s.data.data());
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        s.ready = true;
        slots[i] = std::move(s);
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* fl_create(const char* const* paths, int64_t n_frames, int out_h,
                int out_w, const float* affines, int n_threads,
                int queue_cap) {
  auto* L = new Loader();
  L->paths.assign(paths, paths + n_frames);
  L->out_h = out_h;
  L->out_w = out_w;
  if (affines) L->affines.assign(affines, affines + n_frames * 6);
  L->queue_cap = queue_cap > 0 ? queue_cap : 4;
  L->slots.resize(n_frames);
  const int nt = n_threads > 0 ? n_threads : 2;
  for (int t = 0; t < nt; ++t) {
    L->workers.emplace_back([L] { L->work(); });
  }
  return L;
}

// Blocking ordered pop. Returns 1 on success (out filled, src_hw set to the
// pre-warp image size), 0 on decode failure of this frame, -1 past the end.
int fl_next(void* h, float* out, int64_t out_len, int* src_hw) {
  auto* L = static_cast<Loader*>(h);
  if (L->next_out >= int64_t(L->paths.size())) return -1;
  const int64_t i = L->next_out;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [&] { return L->slots[i].ready; });
  Slot s = std::move(L->slots[i]);
  L->slots[i] = Slot();  // free
  L->next_out = i + 1;
  lk.unlock();
  L->cv_window.notify_all();
  if (src_hw) {
    src_hw[0] = s.src_h;
    src_hw[1] = s.src_w;
  }
  if (!s.ok) return 0;
  const int64_t n = int64_t(s.data.size());
  if (n > out_len) return 0;
  std::memcpy(out, s.data.data(), sizeof(float) * n);
  return 1;
}

void fl_destroy(void* h) {
  auto* L = static_cast<Loader*>(h);
  L->stop.store(true);
  L->cv_window.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// One-shot helpers (no thread pool): decode a single image to grayscale
// float. Returns 1 and fills hw on success; call fl_read_gray after sizing
// the buffer from fl_probe.
int fl_probe(const char* path, int* hw) {
  Image img;
  if (!decode_file(path, &img)) return 0;
  hw[0] = img.h;
  hw[1] = img.w;
  return 1;
}

int fl_read_gray(const char* path, float* out, int64_t out_len) {
  Image img;
  if (!decode_file(path, &img)) return 0;
  const int64_t n = int64_t(img.gray.size());
  if (n > out_len) return 0;
  std::memcpy(out, img.gray.data(), sizeof(float) * n);
  return 1;
}

}  // extern "C"
