// Native JPEG codec for the video IO of landiff_tpu_torch.
//
// The reference's video IO rides native code end to end: imageio-ffmpeg for
// writing (reference utils.py:334-343) and torch's C++ DataLoader workers for
// ingestion. This is the equivalent here: a small C ABI over libjpeg with
// an internal std::thread fan-out for batched frame encode/decode, loaded via
// ctypes (no pybind11 in the image). PIL remains the pure-python fallback and
// the parity oracle.
//
// Build: g++ -O3 -fPIC -shared jpeg.cpp -o liblandiff_jpeg.so -ljpeg -lpthread
// (driven by landiff_tpu_torch/native/build.py, cached by source hash).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <csetjmp>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// libjpeg's default error handler calls exit(); route errors through
// setjmp/longjmp so a corrupt frame returns an error code instead of
// killing the Python process.
struct lt_error_mgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

static void lt_error_exit(j_common_ptr cinfo) {
  lt_error_mgr* err = reinterpret_cast<lt_error_mgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// default output_message writes warnings to stderr; stay quiet (errors
// still surface as return codes via lt_error_exit).
static void lt_silent_message(j_common_ptr) {}

void lt_free(void* p) { free(p); }

// Encode one (h, w, 3) RGB uint8 frame. On success returns 0 and sets
// *out/*out_len to a malloc'ed JPEG buffer (caller frees via lt_free).
int lt_jpeg_encode(const uint8_t* rgb, int h, int w, int quality,
                   uint8_t** out, size_t* out_len) {
  jpeg_compress_struct cinfo;
  lt_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = lt_error_exit;
  jerr.pub.output_message = lt_silent_message;
  // The JPEG buffer pointer lives in the CALLER's storage (*out), not in a
  // local: automatic locals modified between setjmp and longjmp are
  // indeterminate when read in the error branch (C99 7.13.2.1), so under
  // -O3 an error path freeing a local pointer could free a stale value.
  // buf_len is only read on the success path, so it may stay a local.
  *out = nullptr;
  *out_len = 0;
  unsigned long buf_len = 0;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    if (*out) {
      free(*out);
      *out = nullptr;
    }
    return 1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, out, &buf_len);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const size_t stride = static_cast<size_t>(w) * 3;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb + cinfo.next_scanline * stride);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *out_len = buf_len;
  return 0;
}

// Probe JPEG dimensions without a full decode.
int lt_jpeg_probe(const uint8_t* data, size_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  lt_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = lt_error_exit;
  jerr.pub.output_message = lt_silent_message;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode into a caller-provided (h, w, 3) RGB buffer (size from lt_jpeg_probe,
// so numpy owns the output with no extra copy).
int lt_jpeg_decode(const uint8_t* data, size_t len, uint8_t* out_rgb,
                   int h, int w) {
  jpeg_decompress_struct cinfo;
  lt_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = lt_error_exit;
  jerr.pub.output_message = lt_silent_message;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != h ||
      static_cast<int>(cinfo.output_width) != w ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  const size_t stride = static_cast<size_t>(w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out_rgb + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Batched encode with a std::thread fan-out: frames is (n, h, w, 3)
// contiguous; outs/lens are n-length arrays filled with malloc'ed buffers.
// Returns the number of frames that FAILED (0 = all good). n_threads <= 0
// means hardware_concurrency.
int lt_jpeg_encode_batch(const uint8_t* frames, int n, int h, int w,
                         int quality, uint8_t** outs, size_t* lens,
                         int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > n) n_threads = n;
  const size_t frame_sz = static_cast<size_t>(h) * w * 3;
  std::vector<int> fails(n_threads, 0);
  auto work = [&](int t) {
    for (int i = t; i < n; i += n_threads) {
      fails[t] += lt_jpeg_encode(frames + i * frame_sz, h, w, quality,
                                 &outs[i], &lens[i]) != 0;
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; ++t) ts.emplace_back(work, t);
    for (auto& t : ts) t.join();
  }
  int total = 0;
  for (int f : fails) total += f;
  return total;
}

// Batched decode of n JPEG buffers into one (n, h, w, 3) output; every frame
// must match (h, w) (the AVI stream header fixes the size). Returns number
// of failed frames.
int lt_jpeg_decode_batch(const uint8_t** datas, const size_t* lens, int n,
                         uint8_t* out, int h, int w, int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > n) n_threads = n;
  const size_t frame_sz = static_cast<size_t>(h) * w * 3;
  std::vector<int> fails(n_threads, 0);
  auto work = [&](int t) {
    for (int i = t; i < n; i += n_threads) {
      fails[t] += lt_jpeg_decode(datas[i], lens[i], out + i * frame_sz,
                                 h, w) != 0;
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; ++t) ts.emplace_back(work, t);
    for (auto& t : ts) t.join();
  }
  int total = 0;
  for (int f : fails) total += f;
  return total;
}

}  // extern "C"
