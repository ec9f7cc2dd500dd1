// Host JPEG decode: libjpeg -> BGR float32 [H, W, 3].
//
// The port's own copy of keystone_tpu/native/ingest.cpp (same code, same
// return codes).  A lock-free reentrant decoder with a plain C ABI, driven
// from Python through ctypes (loaders/native_decode.py); ctypes releases
// the GIL for each call, so the thread-pool loaders and the ingest stream
// decode on several host cores with no Python image library on the hot
// path.
//
// Semantics mirror loaders/image_loaders.decode_image exactly: output is
// H x W x 3 float32 BGR in [0, 255]; grayscale is triplicated; images
// smaller than 36 px on a side are rejected.
//
// Build: g++ -O2 -shared -fPIC ingest.cpp -o ingest-<hash>.so -ljpeg, by
// keystone_tpu_torch/_build.py into build/kernels/ at first use.

#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <jpeglib.h>

namespace {

constexpr int kMinDim = 36;  // reference ImageUtils.loadImage floor

struct ErrorTrap {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void error_exit_trap(j_common_ptr cinfo) {
  ErrorTrap* trap = reinterpret_cast<ErrorTrap*>(cinfo->err);
  longjmp(trap->jump, 1);
}

void silence_output(j_common_ptr) {}

}  // namespace

extern "C" {

// Decode a JPEG byte buffer.  On success returns 0 and sets *out (malloc'd
// H*W*3 float32 BGR buffer — free with kst_free), *h, *w.  Returns:
//   1  decode error (corrupt/unsupported stream)
//   2  image rejected (either dimension < 36 px)
//   3  unsupported channel count (not grayscale or 3-channel)
int kst_decode_jpeg(const unsigned char* data, long len, float** out,
                    int* h, int* w) {
  *out = nullptr;
  jpeg_decompress_struct cinfo;
  ErrorTrap trap;
  cinfo.err = jpeg_std_error(&trap.mgr);
  trap.mgr.error_exit = error_exit_trap;
  trap.mgr.output_message = silence_output;

  // volatile: modified between setjmp and longjmp — without it their
  // post-longjmp values are indeterminate (C++ [support.runtime]), so the
  // corrupt-stream error path could leak or free garbage (libjpeg
  // example.c uses the same pattern).
  float* volatile pixels = nullptr;
  unsigned char* volatile row = nullptr;
  if (setjmp(trap.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::free(pixels);
    std::free(row);
    return 1;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  jpeg_start_decompress(&cinfo);

  const int height = static_cast<int>(cinfo.output_height);
  const int width = static_cast<int>(cinfo.output_width);
  const int nc = cinfo.output_components;
  if (height < kMinDim || width < kMinDim) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  if (nc != 1 && nc != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }

  pixels = static_cast<float*>(
      std::malloc(sizeof(float) * static_cast<size_t>(height) * width * 3));
  row = static_cast<unsigned char*>(
      std::malloc(static_cast<size_t>(width) * nc));
  if (pixels == nullptr || row == nullptr) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::free(pixels);
    std::free(row);
    return 1;
  }

  while (cinfo.output_scanline < cinfo.output_height) {
    const int y = static_cast<int>(cinfo.output_scanline);
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
    float* dst = pixels + static_cast<size_t>(y) * width * 3;
    if (nc == 3) {
      // libjpeg emits RGB; the framework's image layout is BGR
      for (int x = 0; x < width; ++x) {
        dst[x * 3 + 0] = static_cast<float>(row[x * 3 + 2]);
        dst[x * 3 + 1] = static_cast<float>(row[x * 3 + 1]);
        dst[x * 3 + 2] = static_cast<float>(row[x * 3 + 0]);
      }
    } else {
      for (int x = 0; x < width; ++x) {
        const float v = static_cast<float>(row[x]);
        dst[x * 3 + 0] = v;
        dst[x * 3 + 1] = v;
        dst[x * 3 + 2] = v;
      }
    }
  }

  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::free(row);
  *out = pixels;
  *h = height;
  *w = width;
  return 0;
}

void kst_free(float* p) { std::free(p); }

}  // extern "C"
