// Native training-window loader: threaded JPEG/16-bit-PNG decode + bilinear
// resize + pose parsing, in one pass per frame (the port's own copy of
// estdepth_tpu/data/native/loader.cc; the code below the comments is the
// same, so both packages read the same floats).
//
// The host-side work the reference runs through torch DataLoader workers +
// cv2 (its data/scannet.py:97-164: cv2.imread/resize/cvtColor and
// np.loadtxt inside a worker process). Here the whole window is assembled
// by native threads and written straight into caller-provided float32
// buffers: no intermediate uint8 arrays, no Python in the loop.
//
// Semantics:
//   * JPEG decodes to RGB (what the reference reaches after BGR->RGB).
//   * Resize is bilinear with half-pixel centers (cv2 INTER_LINEAR
//     convention); float arithmetic, so values match cv2's fixed-point
//     path to ~1/255.
//   * Depth PNGs are 16-bit grayscale millimeters; output is float32
//     meters (scale 1/1000, data/scannet.py:142).
//   * Poses are whitespace 4x4 row-major floats.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 loader.cc -o libestloader.so \
//            -ljpeg -lpng -lz -pthread
// (driven by estdepth_tpu_torch/data/native/__init__.py)

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Bilinear resize with half-pixel centers (cv2 INTER_LINEAR convention):
// src_x = (dst_x + 0.5) * (src_w / dst_w) - 0.5, clamped to the image.
// Column coordinates/weights are loop-invariant per row — precomputed once
// so the inner loop is pure lerps (auto-vectorizable).
template <typename SrcT>
void resize_bilinear(const SrcT* src, int src_h, int src_w, int channels,
                     float* dst, int dst_h, int dst_w, float value_scale) {
  const float sx = static_cast<float>(src_w) / dst_w;
  const float sy = static_cast<float>(src_h) / dst_h;

  std::vector<int> x0s(dst_w), x1s(dst_w);
  std::vector<float> wxs(dst_w);
  for (int x = 0; x < dst_w; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    if (fx < 0) fx = 0;
    if (fx > src_w - 1) fx = static_cast<float>(src_w - 1);
    x0s[x] = static_cast<int>(fx);
    x1s[x] = x0s[x] + 1 < src_w ? x0s[x] + 1 : src_w - 1;
    wxs[x] = fx - x0s[x];
  }

  // two-pass: horizontal lerp of the two contributing rows, then vertical
  std::vector<float> row0(static_cast<size_t>(dst_w) * channels);
  std::vector<float> row1(static_cast<size_t>(dst_w) * channels);
  int cached_y0 = -1, cached_y1 = -1;

  auto hlerp = [&](const SrcT* srow, float* out) {
    for (int x = 0; x < dst_w; ++x) {
      const SrcT* a = srow + static_cast<size_t>(x0s[x]) * channels;
      const SrcT* b = srow + static_cast<size_t>(x1s[x]) * channels;
      const float wx = wxs[x];
      float* o = out + static_cast<size_t>(x) * channels;
      for (int c = 0; c < channels; ++c) {
        const float va = static_cast<float>(a[c]);
        o[c] = va + wx * (static_cast<float>(b[c]) - va);
      }
    }
  };

  for (int y = 0; y < dst_h; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    if (fy > src_h - 1) fy = static_cast<float>(src_h - 1);
    const int y0 = static_cast<int>(fy);
    const int y1 = y0 + 1 < src_h ? y0 + 1 : src_h - 1;
    const float wy = fy - y0;

    if (y0 != cached_y0) {
      if (y0 == cached_y1) {  // rows slide down: promote row1 to row0
        std::swap(row0, row1);
        cached_y0 = y0;
        cached_y1 = -1;  // row1 content is now stale
      } else {
        hlerp(src + static_cast<size_t>(y0) * src_w * channels, row0.data());
        cached_y0 = y0;
      }
    }
    const float* r0 = row0.data();
    const float* r1;
    if (y1 == y0) {
      r1 = r0;  // bottom border: both taps are the same source row
    } else {
      if (y1 != cached_y1) {
        hlerp(src + static_cast<size_t>(y1) * src_w * channels, row1.data());
        cached_y1 = y1;
      }
      r1 = row1.data();
    }
    float* out = dst + static_cast<size_t>(y) * dst_w * channels;
    const int nc = dst_w * channels;
    for (int i = 0; i < nc; ++i) {
      out[i] = (r0[i] + wy * (r1[i] - r0[i])) * value_scale;
    }
  }
}

}  // namespace

extern "C" {

// RGB float32 [out_h, out_w, 3] in 0..255. Returns 0 on success.
int est_decode_jpeg_resize(const char* path, int out_w, int out_h,
                           float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;

  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  std::vector<unsigned char> pixels;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  pixels.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = pixels.data() +
        static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);

  resize_bilinear(pixels.data(), h, w, 3, out, out_h, out_w, 1.0f);
  return 0;
}

// Depth float32 [out_h, out_w] in meters (16-bit gray PNG, millimeters).
int est_decode_png16_resize(const char* path, int out_w, int out_h,
                            float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) { fclose(f); return 2; }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return 3;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  const int w = png_get_image_width(png, info);
  const int h = png_get_image_height(png, info);
  const int depth = png_get_bit_depth(png, info);
  const int color = png_get_color_type(png, info);
  if (color != PNG_COLOR_TYPE_GRAY) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return 4;
  }
  if (depth == 16) png_set_swap(png);  // PNG is big-endian on disk

  std::vector<unsigned short> pixels(static_cast<size_t>(w) * h);
  std::vector<png_bytep> rows(h);
  if (depth == 16) {
    for (int y = 0; y < h; ++y)
      rows[y] = reinterpret_cast<png_bytep>(pixels.data() +
                                            static_cast<size_t>(y) * w);
    png_read_image(png, rows.data());
  } else if (depth == 8) {
    std::vector<unsigned char> tmp(static_cast<size_t>(w) * h);
    for (int y = 0; y < h; ++y)
      rows[y] = tmp.data() + static_cast<size_t>(y) * w;
    png_read_image(png, rows.data());
    for (size_t i = 0; i < tmp.size(); ++i) pixels[i] = tmp[i];
  } else {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return 5;
  }
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);

  resize_bilinear(pixels.data(), h, w, 1, out, out_h, out_w, 1.0f / 1000.0f);
  return 0;
}

// 4x4 row-major pose from whitespace-separated text.
int est_load_pose(const char* path, float* out16) {
  FILE* f = fopen(path, "r");
  if (!f) return 1;
  for (int i = 0; i < 16; ++i) {
    if (fscanf(f, "%f", &out16[i]) != 1) {
      fclose(f);
      return 2;
    }
  }
  fclose(f);
  return 0;
}

// Assemble a full n-frame window with one native thread per frame.
// imgs:   [n, out_h, out_w, 3] float32 (0..255)
// depths: [n, out_h, out_w]    float32 meters
// poses:  [n, 4, 4]            float32
// Returns 0 if every frame loaded, else the first nonzero frame status.
int est_load_window(const char** img_paths, const char** depth_paths,
                    const char** pose_paths, int n, int out_w, int out_h,
                    float* imgs, float* depths, float* poses) {
  std::vector<int> status(n, 0);
  std::vector<std::thread> threads;
  threads.reserve(n);
  const size_t img_stride = static_cast<size_t>(out_h) * out_w * 3;
  const size_t depth_stride = static_cast<size_t>(out_h) * out_w;
  for (int i = 0; i < n; ++i) {
    threads.emplace_back([&, i]() {
      int rc = est_decode_jpeg_resize(img_paths[i], out_w, out_h,
                                      imgs + i * img_stride);
      if (rc == 0 && depth_paths)
        rc = est_decode_png16_resize(depth_paths[i], out_w, out_h,
                                     depths + i * depth_stride);
      if (rc == 0 && pose_paths)
        rc = est_load_pose(pose_paths[i], poses + i * 16);
      status[i] = rc;
    });
  }
  for (auto& t : threads) t.join();
  for (int i = 0; i < n; ++i)
    if (status[i] != 0) return status[i];
  return 0;
}

}  // extern "C"
