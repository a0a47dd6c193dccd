// Native training-data loader of the PyTorch port: decode (JPEG/PNG) +
// seeded random crop + batch assembly, multithreaded in C++ with the GIL
// released (ctypes). It is the port's own copy of the JAX package's
// native/loader.cpp and behaves the same, byte for byte: the same C ABI and
// version, the same splitmix64 draws, the same ROI and prefix decodes and
// the same status codes, so for one (path, patch, seed) both libraries cut
// the same crop (tests/test_torch_native.py holds them equal).
//
// Exposed C ABI (see native/__init__.py for the ctypes binding):
//   isr_version()                         -> int
//   isr_decode_dims(path, &h, &w)         -> 0/err  (header probe only)
//   isr_decode_rgb(path, out, h, w)       -> 0/err  (decode into caller buf)
//   isr_load_patches(paths, n, patch, seeds, out, status, n_threads)
//       -> count of not-OK slots; per-item PatchStatus codes in status[n]
//       (the binding re-decodes FAILED/UNSUPPORTED slots via cv2/PIL)
//
// Semantics match data/pipeline.py's Python backend: images smaller than the
// patch are reflect-padded on the bottom/right (np.pad mode="reflect");
// unreadable files yield a zero patch (train-time substitution, not a crash).
// Crop offsets come from a splitmix64 PRNG seeded per patch by the caller —
// deterministic for a given (seed, epoch, batch, index). The stream differs
// from the Python backend's np.random.Generator, so the two backends cut
// different (equally uniform) crops; each matches its JAX counterpart.
//
// Needs libjpeg-turbo >= 1.5 (jpeg_crop_scanline, jpeg_skip_scanlines) and
// libpng.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

extern "C" {

int isr_version() { return 2; }

// ---------------------------------------------------------------------------
// splitmix64 — tiny, well-distributed PRNG for crop offsets
// ---------------------------------------------------------------------------
static inline uint64_t splitmix64(uint64_t* s) {
  uint64_t z = (*s += 0x9e3779b97f4a7c15ull);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

// bounded uniform via 128-bit multiply (Lemire); bound > 0
static inline uint64_t bounded(uint64_t* s, uint64_t bound) {
  return (uint64_t)(((__uint128_t)splitmix64(s) * bound) >> 64);
}

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg, with longjmp error trap)
// ---------------------------------------------------------------------------
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// mode 0: dims only; mode 1: decode rows into out (h*w*3, RGB)
static int decode_jpeg(FILE* f, int mode, uint8_t* out, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  if (mode == 0) {
    *h = (int)cinfo.image_height;
    *w = (int)cinfo.image_width;
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  jpeg_start_decompress(&cinfo);
  int W = (int)cinfo.output_width, H = (int)cinfo.output_height;
  if (H != *h || W != *w || cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  while ((int)cinfo.output_scanline < H) {
    JSAMPROW row = out + (size_t)cinfo.output_scanline * W * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// ---------------------------------------------------------------------------
// PNG decode (libpng, normalized to 8-bit RGB)
// ---------------------------------------------------------------------------
static int decode_png(FILE* f, int mode, uint8_t* out, int* h, int* w) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return -2;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -2;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -2;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  int W = (int)png_get_image_width(png, info);
  int H = (int)png_get_image_height(png, info);
  if (mode == 0) {
    *h = H;
    *w = W;
    png_destroy_read_struct(&png, &info, nullptr);
    return 0;
  }
  if (H != *h || W != *w) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -3;
  }
  // Normalize any PNG flavor to 8-bit RGB (strip alpha, expand palette/gray).
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color & PNG_COLOR_MASK_ALPHA || png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  png_read_update_info(png, info);
  if (png_get_rowbytes(png, info) != (size_t)W * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -3;
  }
  std::vector<png_bytep> rows((size_t)H);
  for (int y = 0; y < H; ++y) rows[y] = out + (size_t)y * W * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

// ---------------------------------------------------------------------------
// Format sniffing + unified decode
// ---------------------------------------------------------------------------
static int decode_any(const char* path, int mode, uint8_t* out, int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  unsigned char magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  rewind(f);
  int rc;
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    rc = decode_jpeg(f, mode, out, h, w);
  } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    rc = decode_png(f, mode, out, h, w);
  } else {
    rc = -4;  // unsupported container (bmp/webp fall back to the Python path)
  }
  fclose(f);
  return rc;
}

int isr_decode_dims(const char* path, int* h, int* w) {
  return decode_any(path, 0, nullptr, h, w);
}

int isr_decode_rgb(const char* path, uint8_t* out, int h, int w) {
  int hh = h, ww = w;
  return decode_any(path, 1, out, &hh, &ww);
}

// ---------------------------------------------------------------------------
// Patch extraction: decode full image, reflect-pad if small, random-crop
// ---------------------------------------------------------------------------
// np.pad mode="reflect" on the bottom/right: row h-2, h-3, ... (edge excluded)
static inline int reflect_index(int i, int n) {
  if (n == 1) return 0;
  int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return (i < n) ? i : period - i;
}

// ROI JPEG decode (libjpeg-turbo): decode ONLY the rows/iMCU columns the
// crop touches — jpeg_skip_scanlines past `top`, jpeg_crop_scanline to the
// enclosing iMCU span, abort after `patch` rows. For photo-sized sources
// this skips the vast majority of the IDCT work; cv2/PIL cannot express it.
static int jpeg_crop_patch(FILE* f, int patch, int top, int left, int w,
                           uint8_t* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  // Request one iMCU column of margin on each side: fancy chroma
  // upsampling needs horizontal context, so pixels at the very edge of a
  // cropped span differ from a full decode. With the margin, the pixels we
  // actually keep are interior to the span and bit-identical.
  int mcu_w = cinfo.max_h_samp_factor * DCTSIZE;
  int x0 = (left >= mcu_w) ? left - mcu_w : 0;
  int x1 = left + patch + mcu_w;
  if (x1 > w) x1 = w;
  JDIMENSION xoff = (JDIMENSION)x0, xw = (JDIMENSION)(x1 - x0);
  jpeg_crop_scanline(&cinfo, &xoff, &xw);  // snaps to iMCU boundary
  int col0 = left - (int)xoff;             // crop start within decoded span
  std::vector<uint8_t> row((size_t)cinfo.output_width * 3);
  // Skip whole iMCU rows only, to one iMCU row BEFORE the target, then
  // decode-and-discard up to `top` — unaligned jpeg_skip_scanlines with
  // fancy chroma upsampling is NOT bit-identical to a full decode (the
  // upsampler loses its context row); this way it is (exactness-tested).
  if (top > 0) {
    int mcu_h = cinfo.max_v_samp_factor * DCTSIZE;
    int aligned = (top / mcu_h) * mcu_h;
    int skip = (aligned >= mcu_h) ? aligned - mcu_h : 0;
    if (skip > 0) jpeg_skip_scanlines(&cinfo, (JDIMENSION)skip);
    while ((int)cinfo.output_scanline < top) {
      JSAMPROW r = row.data();
      jpeg_read_scanlines(&cinfo, &r, 1);
    }
  }
  for (int y = 0; y < patch; ++y) {
    JSAMPROW r = row.data();
    jpeg_read_scanlines(&cinfo, &r, 1);
    std::memcpy(out + (size_t)y * patch * 3, row.data() + (size_t)col0 * 3,
                (size_t)patch * 3);
  }
  jpeg_abort_decompress(&cinfo);  // skip trailing rows entirely
  jpeg_destroy_decompress(&cinfo);
  (void)w;
  return 0;
}

// Prefix PNG decode: rows are a sequential filter chain, so columns can't be
// skipped — but reading stops after top+patch rows (saves the tail).
static int png_prefix_patch(FILE* f, int patch, int top, int left, int w,
                            uint8_t* out) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return -2;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -2;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -2;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color & PNG_COLOR_MASK_ALPHA || png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  if (png_get_interlace_type(png, info) != PNG_INTERLACE_NONE) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -5;  // interlaced: caller falls back to full decode
  }
  png_read_update_info(png, info);
  if (png_get_rowbytes(png, info) != (size_t)w * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -3;
  }
  std::vector<uint8_t> row((size_t)w * 3);
  for (int y = 0; y < top + patch; ++y) {
    png_read_row(png, row.data(), nullptr);
    if (y >= top)
      std::memcpy(out + (size_t)(y - top) * patch * 3,
                  row.data() + (size_t)left * 3, (size_t)patch * 3);
  }
  png_destroy_read_struct(&png, &info, nullptr);  // no read_end: abandon tail
  return 0;
}

static uint8_t load_one_patch(const char* path, int patch, uint64_t seed,
                              uint8_t* out) {
  int h = 0, w = 0;
  int probe = decode_any(path, 0, nullptr, &h, &w);
  if (probe != 0 || h <= 0 || w <= 0) {
    std::memset(out, 0, (size_t)patch * patch * 3);
    return (uint8_t)(probe == -4 ? 2 : 1);  // ISR_UNSUPPORTED : ISR_FAILED
  }
  uint64_t s = seed;
  int ph = (h >= patch) ? h : patch, pw = (w >= patch) ? w : patch;
  int top = (ph > patch) ? (int)bounded(&s, (uint64_t)(ph - patch + 1)) : 0;
  int left = (pw > patch) ? (int)bounded(&s, (uint64_t)(pw - patch + 1)) : 0;

  if (h >= patch && w >= patch) {  // ROI fast path, no full-image buffer
    FILE* f = fopen(path, "rb");
    if (f) {
      unsigned char magic[8] = {0};
      size_t got = fread(magic, 1, 8, f);
      rewind(f);
      int rc = -4;
      if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8)
        rc = jpeg_crop_patch(f, patch, top, left, w, out);
      else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0)
        rc = png_prefix_patch(f, patch, top, left, w, out);
      fclose(f);
      if (rc == 0) return 0;  // else fall through to full decode
    }
  }

  std::vector<uint8_t> img((size_t)h * w * 3);
  if (decode_any(path, 1, img.data(), &h, &w) != 0) {
    std::memset(out, 0, (size_t)patch * patch * 3);
    return 1;
  }
  if (h >= patch && w >= patch) {
    for (int y = 0; y < patch; ++y)
      std::memcpy(out + (size_t)y * patch * 3,
                  img.data() + ((size_t)(top + y) * w + left) * 3,
                  (size_t)patch * 3);
  } else {  // reflect-pad small images (pipeline.py _random_crop parity)
    for (int y = 0; y < patch; ++y) {
      int sy = reflect_index(top + y, h);
      for (int x = 0; x < patch; ++x) {
        int sx = reflect_index(left + x, w);
        std::memcpy(out + ((size_t)y * patch + x) * 3,
                    img.data() + ((size_t)sy * w + sx) * 3, 3);
      }
    }
  }
  return 0;
}

// Per-item status codes written to `status[n]`:
enum PatchStatus : uint8_t {
  ISR_OK = 0,           // decoded and cropped
  ISR_FAILED = 1,       // unreadable / corrupt (slot zero-filled)
  ISR_UNSUPPORTED = 2,  // container this library doesn't decode (bmp/webp/
                        // tiff/...): caller must decode this slot itself
};

// Fill out[n, patch, patch, 3] (contiguous NHWC uint8). Returns the number
// of slots that are NOT ISR_OK; per-item dispositions land in status[n].
int isr_load_patches(const char** paths, int n, int patch,
                     const uint64_t* seeds, uint8_t* out, uint8_t* status,
                     int n_threads) {
  if (n <= 0 || patch <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0), not_ok(0);
  size_t stride = (size_t)patch * patch * 3;
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      uint8_t st = load_one_patch(paths[i], patch, seeds[i],
                                  out + (size_t)i * stride);
      status[i] = st;
      if (st != ISR_OK) not_ok += 1;
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    ts.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
  }
  return not_ok.load();
}

}  // extern "C"
