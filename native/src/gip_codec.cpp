// gip_codec: native image codec + byte utilities for the serving hot path.
//
// The reference vendors stb_image/stb_image_write (~15k LoC C) for its C++
// test programs (external/stb_image.h, used by tests/test_real_image.cu:7-11)
// and leans on PIL inside the server.  This library is this stack's
// native equivalent: PNG encode/decode (zlib), PPM/PGM and BMP io, and fast
// base64 -- the byte-level work that sits between HTTP and the device and
// should not burn Python time on a serving host.
//
// C ABI only; bound from Python via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <string>
#include <utility>
#include <vector>
#include <zlib.h>

// libdeflate (when present at build time) replaces zlib for the whole-buffer
// INFLATE on the PNG decode path: combined with the specialized unfilter
// rows below, native decode went from PIL parity to ~1.9x faster (74 -> 40
// ms on a 3 MP photo).  Encode stays on zlib Z_RLE (measured faster than
// libdeflate level 1 at equal size).  zlib also remains for crc32 and as
// the build-time fallback.
#ifdef GIP_HAVE_LIBDEFLATE
#include <libdeflate.h>
#endif

#include "gip_limits.h"

extern "C" {

// ---------------------------------------------------------------------------
// memory
// ---------------------------------------------------------------------------

void gip_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// base64 (standard alphabet, padded)
// ---------------------------------------------------------------------------

static const char B64_CHARS[] =
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";

size_t gip_base64_encoded_size(size_t n) { return ((n + 2) / 3) * 4; }

size_t gip_base64_encode(const uint8_t* in, size_t n, char* out) {
  size_t o = 0;
  size_t i = 0;
  for (; i + 3 <= n; i += 3) {
    uint32_t v = (uint32_t(in[i]) << 16) | (uint32_t(in[i + 1]) << 8) | in[i + 2];
    out[o++] = B64_CHARS[(v >> 18) & 63];
    out[o++] = B64_CHARS[(v >> 12) & 63];
    out[o++] = B64_CHARS[(v >> 6) & 63];
    out[o++] = B64_CHARS[v & 63];
  }
  size_t rem = n - i;
  if (rem == 1) {
    uint32_t v = uint32_t(in[i]) << 16;
    out[o++] = B64_CHARS[(v >> 18) & 63];
    out[o++] = B64_CHARS[(v >> 12) & 63];
    out[o++] = '=';
    out[o++] = '=';
  } else if (rem == 2) {
    uint32_t v = (uint32_t(in[i]) << 16) | (uint32_t(in[i + 1]) << 8);
    out[o++] = B64_CHARS[(v >> 18) & 63];
    out[o++] = B64_CHARS[(v >> 12) & 63];
    out[o++] = B64_CHARS[(v >> 6) & 63];
    out[o++] = '=';
  }
  return o;
}

// returns decoded size or -1 on bad input; skips ASCII whitespace.
long long gip_base64_decode(const char* in, size_t n, uint8_t* out) {
  // Magic static (C++11 thread-safe init): the server calls this from
  // concurrent threads with the GIL released; an unsynchronized
  // static-bool lazy init raced (torn table / init flag published early).
  struct B64Lut {
    int8_t v[256];
    B64Lut() {
      std::memset(v, -1, sizeof(v));
      for (int k = 0; k < 64; ++k) v[(uint8_t)B64_CHARS[k]] = (int8_t)k;
    }
  };
  static const B64Lut lut_s;
  const int8_t* lut = lut_s.v;
  uint32_t acc = 0;
  int bits = 0;
  size_t o = 0;
  for (size_t i = 0; i < n; ++i) {
    char ch = in[i];
    if (ch == '=' ) break;
    if (ch == '\n' || ch == '\r' || ch == ' ' || ch == '\t') continue;
    int8_t v = lut[(uint8_t)ch];
    if (v < 0) return -1;
    acc = (acc << 6) | (uint32_t)v;
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      out[o++] = (uint8_t)(acc >> bits);
    }
  }
  return (long long)o;
}

// ---------------------------------------------------------------------------
// PNG encode (8-bit gray / RGB / RGBA, filter 0, zlib-compressed)
// ---------------------------------------------------------------------------

static void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(uint8_t(x >> 24));
  v.push_back(uint8_t(x >> 16));
  v.push_back(uint8_t(x >> 8));
  v.push_back(uint8_t(x));
}

static void png_chunk(std::vector<uint8_t>& out, const char type[4],
                      const uint8_t* data, size_t len) {
  put_be32(out, (uint32_t)len);
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  if (len) out.insert(out.end(), data, data + len);
  uLong crc = crc32(0L, out.data() + start, (uInt)(4 + len));
  put_be32(out, (uint32_t)crc);
}

static int png_assemble(int w, int h, uint8_t color_type,
                        const std::vector<uint8_t>& zdata,
                        uint8_t** out_buf, size_t* out_len) {
  std::vector<uint8_t> png;
  png.reserve(zdata.size() + 128);
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  png.insert(png.end(), sig, sig + 8);

  uint8_t ihdr[13];
  ihdr[0] = uint8_t(w >> 24); ihdr[1] = uint8_t(w >> 16);
  ihdr[2] = uint8_t(w >> 8);  ihdr[3] = uint8_t(w);
  ihdr[4] = uint8_t(h >> 24); ihdr[5] = uint8_t(h >> 16);
  ihdr[6] = uint8_t(h >> 8);  ihdr[7] = uint8_t(h);
  ihdr[8] = 8;            // bit depth
  ihdr[9] = color_type;
  ihdr[10] = ihdr[11] = ihdr[12] = 0;  // deflate, adaptive, no interlace
  png_chunk(png, "IHDR", ihdr, 13);
  // PNG caps a chunk's length field at 2^31-1 (and png_chunk's 32-bit
  // length/CRC casts would truncate anyway): split oversized zlib streams
  // across consecutive IDAT chunks -- decoders concatenate them.
  const size_t kMaxIdat = (size_t)1 << 30;
  size_t off = 0;
  do {
    size_t n = zdata.size() - off;
    if (n > kMaxIdat) n = kMaxIdat;
    png_chunk(png, "IDAT", zdata.data() + off, n);
    off += n;
  } while (off < zdata.size());
  png_chunk(png, "IEND", nullptr, 0);

  *out_buf = (uint8_t*)std::malloc(png.size());
  if (!*out_buf) return 3;
  std::memcpy(*out_buf, png.data(), png.size());
  *out_len = png.size();
  return 0;
}

static int png_encode_impl(const uint8_t* img, int h, int w, int c, int level,
                           uint8_t** out_buf, size_t* out_len) {
  if (!img || h <= 0 || w <= 0 || (c != 1 && c != 3 && c != 4)) return 1;
  const uint8_t color_type = c == 1 ? 0 : (c == 3 ? 2 : 6);
  const size_t stride = (size_t)w * c;

  // level <= 1 is the serving fast path: per-row Sub filter + Z_RLE
  // deflate.  RLE-limited matching runs ~4-6x faster than level-1 full
  // matching, and the Sub filter turns photographic gradients into
  // near-constant rows so RLE still compresses them well (the standard
  // fast-PNG recipe).  Measured on 600x800 RGB: 37.5 -> ~7 ms with photo
  // output ~8% larger; the latency dominates the serving hot path
  // (3 PNG encodes per /api/process-all request).  level >= 2 keeps full
  // deflate at that level for archival writers.
  const bool fast = level <= 1;
  std::vector<uint8_t> raw((stride + 1) * (size_t)h);
  for (int y = 0; y < h; ++y) {
    uint8_t* dst = &raw[(stride + 1) * y];
    const uint8_t* src = img + stride * y;
    if (fast) {
      dst[0] = 1;  // Sub filter
      for (int k = 0; k < c; ++k) dst[1 + k] = src[k];
      for (size_t x = c; x < stride; ++x)
        dst[1 + x] = (uint8_t)(src[x] - src[x - c]);
    } else {
      dst[0] = 0;  // None
      std::memcpy(dst + 1, src, stride);
    }
  }

  // Encode stays on zlib: Z_RLE's run-limited matching measured FASTER than
  // libdeflate level 1's full matching at equal output size on photo
  // content (16.8 vs 22.8 ms on noisy 600x800 RGB) -- libdeflate only wins
  // on the decode side here.
  uLongf zcap = compressBound((uLong)raw.size());
  std::vector<uint8_t> zbuf(zcap);
  if (fast) {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, 1, Z_DEFLATED, 15, 8, Z_RLE) != Z_OK) return 2;
    // avail_in/avail_out are 32-bit; feed in bounded chunks so gigapixel
    // inputs aren't silently truncated through the uInt cast.
    const size_t kChunk = 1u << 30;
    size_t in_off = 0, out_off = 0;
    int zrc = Z_OK;
    do {
      size_t in_left = raw.size() - in_off;
      zs.next_in = raw.data() + in_off;
      zs.avail_in = (uInt)(in_left < kChunk ? in_left : kChunk);
      size_t out_left = (size_t)zcap - out_off;
      zs.next_out = zbuf.data() + out_off;
      zs.avail_out = (uInt)(out_left < kChunk ? out_left : kChunk);
      uInt fed_in = zs.avail_in, fed_out = zs.avail_out;
      bool last = in_off + fed_in == raw.size();
      zrc = deflate(&zs, last ? Z_FINISH : Z_NO_FLUSH);
      if (zrc == Z_STREAM_ERROR) break;
      in_off += fed_in - zs.avail_in;
      out_off += fed_out - zs.avail_out;
    } while (zrc != Z_STREAM_END);
    zcap = (uLongf)out_off;
    deflateEnd(&zs);
    if (zrc != Z_STREAM_END) return 2;
  } else if (compress2(zbuf.data(), &zcap, raw.data(), (uLong)raw.size(),
                       level) != Z_OK) {
    return 2;
  }

  zbuf.resize(zcap);
  return png_assemble(w, h, color_type, zbuf, out_buf, out_len);
}

// img: HWC uint8, c in {1,3,4}. Returns 0 on success.
int gip_png_encode(const uint8_t* img, int h, int w, int c, int level,
                   uint8_t** out_buf, size_t* out_len) {
  // C ABI boundary: an exception (e.g. bad_alloc) must not unwind into the
  // ctypes caller frame -- that is UB and typically aborts the process.
  try {
    return png_encode_impl(img, h, w, c, level, out_buf, out_len);
  } catch (...) {
    return 9;
  }
}

// ---------------------------------------------------------------------------
// PNG decode -- the full ISO/W3C variant matrix the reference's vendored stb
// layer covers (stb_image.h:24 "PNG 1/2/4/8/16-bit-per-channel", :4861
// Adam7, :5134 PLTE): gray 1/2/4/8/16, palette 1/2/4/8 (+tRNS alpha),
// RGB/GA/RGBA 8/16, interlace 0 and Adam7.  stb-matching reductions: 16-bit
// samples take the HIGH byte; sub-8-bit GRAY scales to full range
// (x * 255/(2^d-1)); palette INDICES are never scaled.
// ---------------------------------------------------------------------------

static uint32_t get_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | p[3];
}

static uint8_t paeth(int a, int b, int cc) {
  int p = a + b - cc;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - cc);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)cc;
}

// Unfilter `rows` scanlines of `stride` bytes in place within `buf`, where
// each scanline is preceded by its filter byte ((stride+1)-byte records).
// `fbpp` is the filter's pixel unit in bytes (max(1, bits_per_pixel/8)).
// Filtered output for row y lands at buf + (stride+1)*y + 1, using the
// PREVIOUS unfiltered row in place as "up".  Per-filter specialized rows:
// the generic per-byte switch measured ~2x slower than these tight loops.
static int png_unfilter(uint8_t* buf, size_t rows, size_t stride,
                        size_t fbpp) {
  for (size_t y = 0; y < rows; ++y) {
    uint8_t filter = buf[(stride + 1) * y];
    uint8_t* dst = buf + (stride + 1) * y + 1;
    const uint8_t* up = y ? buf + (stride + 1) * (y - 1) + 1 : nullptr;
    switch (filter) {
      case 0:
        break;
      case 1:  // Sub
        for (size_t x = fbpp; x < stride; ++x)
          dst[x] = (uint8_t)(dst[x] + dst[x - fbpp]);
        break;
      case 2:  // Up (b=0 on the first row -> None)
        if (up)
          for (size_t x = 0; x < stride; ++x)
            dst[x] = (uint8_t)(dst[x] + up[x]);
        break;
      case 3:  // Average
        if (!up) {
          for (size_t x = fbpp; x < stride; ++x)
            dst[x] = (uint8_t)(dst[x] + dst[x - fbpp] / 2);
        } else {
          for (size_t x = 0; x < fbpp && x < stride; ++x)
            dst[x] = (uint8_t)(dst[x] + up[x] / 2);
          for (size_t x = fbpp; x < stride; ++x)
            dst[x] = (uint8_t)(dst[x] + (dst[x - fbpp] + up[x]) / 2);
        }
        break;
      case 4:  // Paeth (first row: predictor==a -> Sub; first fbpp: ==b -> Up)
        if (!up) {
          for (size_t x = fbpp; x < stride; ++x)
            dst[x] = (uint8_t)(dst[x] + dst[x - fbpp]);
        } else {
          for (size_t x = 0; x < fbpp && x < stride; ++x)
            dst[x] = (uint8_t)(dst[x] + up[x]);
          for (size_t x = fbpp; x < stride; ++x)
            dst[x] = (uint8_t)(dst[x] +
                               paeth(dst[x - fbpp], up[x], up[x - fbpp]));
        }
        break;
      default:
        return 7;
    }
  }
  return 0;
}

// Adam7 pass origin/step tables (PNG spec 8.2).
static const int kAdam7X0[7] = {0, 4, 0, 2, 0, 1, 0};
static const int kAdam7Y0[7] = {0, 0, 4, 0, 2, 0, 1};
static const int kAdam7DX[7] = {8, 8, 4, 4, 2, 2, 1};
static const int kAdam7DY[7] = {8, 8, 8, 4, 4, 2, 2};

// Exactly one of out_buf (8-bit) / out_buf16 (16-bit) is non-null.
// 16-bit output follows stbi_load_16_from_memory semantics
// (/root/reference/external/stb_image.h:445-449): depth-16 samples pass
// through natively (big-endian pairs), everything 8-bit-or-below is
// upscaled v -> v*257 ((v<<8)|v, stb's stbi__convert_8_to_16) AFTER the
// usual sub-8 gray range expansion / palette lookup.
static int png_decode_impl(const uint8_t* png, size_t len,
                           uint8_t** out_buf, uint16_t** out_buf16,
                           int* out_h, int* out_w,
                           int* out_c) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (!png || len < 45 || std::memcmp(png, sig, 8) != 0) return 1;

  int w = 0, h = 0, depth = 0, color = -1, interlace = 0, samples = 0;
  std::vector<uint8_t> idat;
  uint8_t palette[256][3];
  uint8_t pal_alpha[256];
  int pal_count = 0;
  bool have_trns = false;
  size_t pos = 8;
  bool done = false;
  while (pos + 12 <= len && !done) {
    uint32_t clen = get_be32(png + pos);
    const uint8_t* type = png + pos + 4;
    const uint8_t* data = png + pos + 8;
    if (pos + 12 + clen > len) return 1;
    if (!std::memcmp(type, "IHDR", 4)) {
      if (clen != 13) return 1;
      uint32_t w32 = get_be32(data);
      uint32_t h32 = get_be32(data + 4);
      // Header-declared dims bound every allocation below; cap them before
      // trusting them (each dim < 2^31 follows from the product cap).
      if (!w32 || !h32 || (uint64_t)w32 * h32 > kGipMaxDecodePixels) return 8;
      w = (int)w32;
      h = (int)h32;
      depth = data[8];
      color = data[9];
      interlace = data[12];
      if (interlace != 0 && interlace != 1) return 3;
      // Legal (color, depth) combinations per PNG spec table 11.1.
      switch (color) {
        case 0:
          samples = 1;
          if (depth != 1 && depth != 2 && depth != 4 && depth != 8 &&
              depth != 16)
            return 2;
          break;
        case 3:
          samples = 1;
          if (depth != 1 && depth != 2 && depth != 4 && depth != 8) return 2;
          break;
        case 2: samples = 3; goto depth_8_16;
        case 4: samples = 2; goto depth_8_16;
        case 6: samples = 4; goto depth_8_16;
        depth_8_16:
          if (depth != 8 && depth != 16) return 2;
          break;
        default:
          return 4;
      }
    } else if (!std::memcmp(type, "PLTE", 4)) {
      if (clen % 3 || clen > 256 * 3) return 1;
      pal_count = (int)(clen / 3);
      for (int i = 0; i < pal_count; ++i) {
        palette[i][0] = data[i * 3];
        palette[i][1] = data[i * 3 + 1];
        palette[i][2] = data[i * 3 + 2];
        pal_alpha[i] = 255;
      }
    } else if (!std::memcmp(type, "tRNS", 4)) {
      if (color == 3) {
        if ((int)clen > pal_count) return 1;
        for (uint32_t i = 0; i < clen; ++i) pal_alpha[i] = data[i];
        have_trns = true;
      }
      // tRNS on gray/RGB is a single transparent-color key; the serving
      // contract decodes those types at their native channel count (PIL's
      // default does too), so the key is parsed-and-ignored.
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + clen);
    } else if (!std::memcmp(type, "IEND", 4)) {
      done = true;
    }
    pos += 12 + clen;
  }
  if (!w || !h || !samples || idat.empty()) return 1;
  if (color == 3 && !pal_count) return 1;

  const int bits_pp = depth * samples;
  const size_t fbpp = bits_pp < 8 ? 1 : (size_t)(bits_pp / 8);

  // Per-pass geometry (one full-frame pass when non-interlaced).
  const int n_pass = interlace ? 7 : 1;
  int pw[7], ph[7];
  size_t pstride[7], poff[7];
  size_t total_raw = 0;
  for (int p = 0; p < n_pass; ++p) {
    if (interlace) {
      pw[p] = (w - kAdam7X0[p] + kAdam7DX[p] - 1) / kAdam7DX[p];
      ph[p] = (h - kAdam7Y0[p] + kAdam7DY[p] - 1) / kAdam7DY[p];
    } else {
      pw[p] = w;
      ph[p] = h;
    }
    pstride[p] = ((size_t)pw[p] * bits_pp + 7) / 8;
    poff[p] = total_raw;
    if (pw[p] && ph[p]) total_raw += (pstride[p] + 1) * (size_t)ph[p];
  }
  if (!total_raw) return 1;

  std::vector<uint8_t> raw(total_raw);
#ifdef GIP_HAVE_LIBDEFLATE
  {
    libdeflate_decompressor* dec = libdeflate_alloc_decompressor();
    if (!dec) return 6;
    size_t actual = 0;
    libdeflate_result r = libdeflate_zlib_decompress(
        dec, idat.data(), idat.size(), raw.data(), raw.size(), &actual);
    libdeflate_free_decompressor(dec);
    if (r != LIBDEFLATE_SUCCESS || actual != raw.size()) return 5;
  }
#else
  {
    uLongf rawlen = (uLongf)raw.size();
    if (uncompress(raw.data(), &rawlen, idat.data(),
                   (uLong)idat.size()) != Z_OK ||
        rawlen != raw.size())
      return 5;
  }
#endif

  const int out_channels =
      color == 3 ? (have_trns ? 4 : 3) : samples;
  const size_t out_stride = (size_t)w * out_channels;
  const bool want16 = out_buf16 != nullptr;
  uint8_t* img = nullptr;
  uint16_t* img16 = nullptr;
  if (want16) {
    img16 = (uint16_t*)std::malloc(out_stride * (size_t)h * 2);
    if (!img16) return 6;
  } else {
    img = (uint8_t*)std::malloc(out_stride * (size_t)h);
    if (!img) return 6;
  }
  auto fail = [&](int rc) {
    std::free(img);
    std::free(img16);
    return rc;
  };

  // Sub-8-bit gray scale factors (1->255, 2->85, 4->17); palette indices
  // pass through unscaled (stb_image.h depth_scale_table semantics).
  const int gray_scale =
      (color == 0 && depth < 8) ? 255 / ((1 << depth) - 1) : 1;

  for (int p = 0; p < n_pass; ++p) {
    if (!pw[p] || !ph[p]) continue;
    uint8_t* pass = raw.data() + poff[p];
    int rc = png_unfilter(pass, (size_t)ph[p], pstride[p], fbpp);
    if (rc) return fail(rc);
    const int x0 = interlace ? kAdam7X0[p] : 0;
    const int y0 = interlace ? kAdam7Y0[p] : 0;
    const int dx = interlace ? kAdam7DX[p] : 1;
    const int dy = interlace ? kAdam7DY[p] : 1;
    for (int ry = 0; ry < ph[p]; ++ry) {
      const uint8_t* src = pass + (pstride[p] + 1) * ry + 1;
      const size_t row_off = out_stride * ((size_t)y0 + (size_t)ry * dy);
      if (!want16 && depth == 8 && color != 3 && dx == 1) {
        // Hot serving path (8-bit non-palette rows with unit step --
        // every non-interlaced image plus Adam7's final pass): straight
        // row copy instead of the per-pixel assembly loop.
        std::memcpy(img + row_off + (size_t)x0 * out_channels, src,
                    (size_t)pw[p] * samples);
        continue;
      }
      for (int rx = 0; rx < pw[p]; ++rx) {
        // 16-bit-capable pixel assembly: px holds NATIVE-range samples
        // (0..65535 at depth 16, 0..255 otherwise).
        int px[4];
        if (depth == 16) {
          for (int s = 0; s < samples; ++s) {
            const uint8_t* sp = src + ((size_t)rx * samples + s) * 2;
            px[s] = want16 ? ((sp[0] << 8) | sp[1]) : sp[0];  // BE / hi byte
          }
        } else if (depth == 8) {
          for (int s = 0; s < samples; ++s)
            px[s] = src[(size_t)rx * samples + s];
        } else {
          size_t bit = (size_t)rx * depth;
          int v = (src[bit >> 3] >> (8 - depth - (bit & 7))) &
                  ((1 << depth) - 1);
          px[0] = v * gray_scale;
        }
        const size_t dst_off = row_off + (size_t)(x0 + rx * dx) * out_channels;
        if (color == 3) {
          int idx = px[0];
          if (idx >= pal_count) return fail(1);  // index past PLTE
          if (want16) {
            uint16_t* dst = img16 + dst_off;
            dst[0] = (uint16_t)(palette[idx][0] * 257);
            dst[1] = (uint16_t)(palette[idx][1] * 257);
            dst[2] = (uint16_t)(palette[idx][2] * 257);
            if (have_trns) dst[3] = (uint16_t)(pal_alpha[idx] * 257);
          } else {
            uint8_t* dst = img + dst_off;
            dst[0] = palette[idx][0];
            dst[1] = palette[idx][1];
            dst[2] = palette[idx][2];
            if (have_trns) dst[3] = pal_alpha[idx];
          }
        } else if (want16) {
          uint16_t* dst = img16 + dst_off;
          for (int s = 0; s < samples; ++s)
            dst[s] = (uint16_t)(depth == 16 ? px[s] : px[s] * 257);
        } else {
          uint8_t* dst = img + dst_off;
          for (int s = 0; s < samples; ++s) dst[s] = (uint8_t)px[s];
        }
      }
    }
  }
  if (want16)
    *out_buf16 = img16;
  else
    *out_buf = img;
  *out_h = h;
  *out_w = w;
  *out_c = out_channels;
  return 0;
}

// Returns 0 on success; out is HWC uint8 with channels = PNG channels.
int gip_png_decode(const uint8_t* png, size_t len,
                   uint8_t** out_buf, int* out_h, int* out_w, int* out_c) {
  // C ABI boundary: never let an exception unwind into the ctypes caller.
  try {
    return png_decode_impl(png, len, out_buf, nullptr, out_h, out_w, out_c);
  } catch (...) {
    return 9;
  }
}

// stbi_load_16_from_memory analog (stb_image.h:445-449): HWC uint16
// (host-endian), depth-16 samples native, 8-bit-or-below upscaled v*257.
// Free with gip_free.
int gip_png_decode16(const uint8_t* png, size_t len,
                     uint16_t** out_buf, int* out_h, int* out_w,
                     int* out_c) {
  try {
    return png_decode_impl(png, len, nullptr, out_buf, out_h, out_w, out_c);
  } catch (...) {
    return 9;
  }
}

// ---------------------------------------------------------------------------
// PPM (P6) / PGM (P5)
// ---------------------------------------------------------------------------

int gip_ppm_write(const char* path, const uint8_t* img, int h, int w, int c) {
  if (c != 1 && c != 3) return 1;
  FILE* f = std::fopen(path, "wb");
  if (!f) return 2;
  std::fprintf(f, "P%d\n%d %d\n255\n", c == 1 ? 5 : 6, w, h);
  size_t n = (size_t)h * w * c;
  size_t written = std::fwrite(img, 1, n, f);
  std::fclose(f);
  return written == n ? 0 : 3;
}

int gip_ppm_read(const char* path, uint8_t** out, int* h, int* w, int* c) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  int kind = 0, width = 0, height = 0, maxval = 0;
  if (std::fscanf(f, "P%d", &kind) != 1 || (kind != 5 && kind != 6)) {
    std::fclose(f);
    return 2;
  }
  // Skip whitespace/comments between header tokens.
  auto next_int = [&](int* out_val) -> bool {
    int ch;
    while ((ch = std::fgetc(f)) != EOF) {
      if (ch == '#') { while ((ch = std::fgetc(f)) != EOF && ch != '\n') {} }
      else if (!isspace(ch)) { std::ungetc(ch, f); break; }
    }
    return std::fscanf(f, "%d", out_val) == 1;
  };
  if (!next_int(&width) || !next_int(&height) || !next_int(&maxval) ||
      maxval != 255 || width <= 0 || height <= 0 ||
      (uint64_t)width * height > kGipMaxDecodePixels) {
    std::fclose(f);
    return 3;
  }
  std::fgetc(f);  // single whitespace after maxval
  int channels = kind == 5 ? 1 : 3;
  size_t n = (size_t)width * height * channels;
  uint8_t* buf = (uint8_t*)std::malloc(n);
  if (!buf) { std::fclose(f); return 4; }
  size_t got = std::fread(buf, 1, n, f);
  std::fclose(f);
  if (got != n) { std::free(buf); return 5; }
  *out = buf;
  *h = height;
  *w = width;
  *c = channels;
  return 0;
}

// ---------------------------------------------------------------------------
// BMP write (24-bit BGR, bottom-up) -- parity with stb_image_write's BMP path
// ---------------------------------------------------------------------------

int gip_bmp_write(const char* path, const uint8_t* img, int h, int w,
                  int c) try {
  if (c != 1 && c != 3 && c != 4) return 1;
  if (w <= 0 || h <= 0) return 1;
  uint64_t row64 = ((uint64_t)w * 3 + 3) & ~uint64_t(3);
  uint64_t data64 = row64 * (uint64_t)h;
  // The BITMAPFILEHEADER size field is 32-bit; larger images can't be
  // represented as BI_RGB 24-bit BMPs at all.
  if (54 + data64 > 0xFFFFFFFFu) return 1;
  FILE* f = std::fopen(path, "wb");
  if (!f) return 2;
  size_t row = (size_t)row64;
  uint32_t data_size = (uint32_t)data64;
  uint32_t file_size = 54 + data_size;
  uint8_t header[54] = {0};
  header[0] = 'B'; header[1] = 'M';
  std::memcpy(header + 2, &file_size, 4);
  uint32_t off = 54, hdr = 40, planes_bpp = 1 | (24 << 16);
  std::memcpy(header + 10, &off, 4);
  std::memcpy(header + 14, &hdr, 4);
  std::memcpy(header + 18, &w, 4);
  std::memcpy(header + 22, &h, 4);
  std::memcpy(header + 26, &planes_bpp, 4);
  std::memcpy(header + 34, &data_size, 4);
  if (std::fwrite(header, 1, 54, f) != 54) {
    std::fclose(f);
    return 3;
  }
  std::vector<uint8_t> line(row, 0);
  for (int y = h - 1; y >= 0; --y) {
    for (int x = 0; x < w; ++x) {
      const uint8_t* p = img + ((size_t)y * w + x) * c;
      uint8_t r = p[0], g = c >= 3 ? p[1] : p[0], b = c >= 3 ? p[2] : p[0];
      line[x * 3 + 0] = b;
      line[x * 3 + 1] = g;
      line[x * 3 + 2] = r;
    }
    if (std::fwrite(line.data(), 1, row, f) != row) {
      std::fclose(f);
      return 3;
    }
  }
  std::fclose(f);
  return 0;
} catch (...) {  // no-unwind-into-ctypes contract (bad_alloc on huge rows)
  return 4;
}

// ---------------------------------------------------------------------------
// TGA -- the fourth output format of the reference CLI (test_real_image.cu
// :220-240 picks png/jpg/bmp/tga by extension via stb_image_write).  Write is
// uncompressed top-down type 2 (BGR/BGRA) or type 3 (gray); read also covers
// the RLE types (9 excluded: color-mapped) and both row orders.
// ---------------------------------------------------------------------------

int gip_tga_write(const char* path, const uint8_t* img, int h, int w,
                  int c) try {
  if (c != 1 && c != 3 && c != 4) return 1;
  if (w <= 0 || h <= 0 || w > 0xffff || h > 0xffff) return 1;  // 16-bit dims
  FILE* f = std::fopen(path, "wb");
  if (!f) return 2;
  uint8_t header[18] = {0};
  header[2] = c == 1 ? 3 : 2;
  header[12] = (uint8_t)(w & 0xff);
  header[13] = (uint8_t)((w >> 8) & 0xff);
  header[14] = (uint8_t)(h & 0xff);
  header[15] = (uint8_t)((h >> 8) & 0xff);
  header[16] = (uint8_t)(8 * c);
  header[17] = (uint8_t)(0x20 | (c == 4 ? 8 : 0));  // top-down; alpha bits
  std::fwrite(header, 1, 18, f);
  std::vector<uint8_t> line((size_t)w * c);
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = img + (size_t)y * w * c;
    if (c == 1) {
      std::memcpy(line.data(), src, (size_t)w);
    } else {
      for (int x = 0; x < w; ++x) {
        line[(size_t)x * c + 0] = src[x * c + 2];  // B
        line[(size_t)x * c + 1] = src[x * c + 1];  // G
        line[(size_t)x * c + 2] = src[x * c + 0];  // R
        if (c == 4) line[(size_t)x * c + 3] = src[x * c + 3];
      }
    }
    if (std::fwrite(line.data(), 1, line.size(), f) != line.size()) {
      std::fclose(f);
      return 3;
    }
  }
  std::fclose(f);
  return 0;
} catch (...) {  // no-unwind-into-ctypes contract
  return 4;
}

// Defined in gip_formats.cpp.
int gip_tga_decode(const uint8_t* buf, size_t len, uint8_t** out, int* out_h,
                   int* out_w, int* out_c);

int gip_tga_read(const char* path, uint8_t** out, int* out_h, int* out_w,
                 int* out_c) try {
  // Delegates to the bounds-checked in-memory decoder (gip_formats.cpp),
  // which supersets the original file reader: colormapped types 1/9 and
  // 15/16-bpp truecolor decode too.
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::vector<uint8_t> data;
  uint8_t chunk[65536];
  size_t got;
  while ((got = std::fread(chunk, 1, sizeof chunk, f)) > 0) {
    // A multi-GB "TGA" can't be valid (16-bit dims x 4 bpp tops out far
    // lower); cap before the vector growth turns into bad_alloc.
    if (data.size() + got > (size_t)1 << 30) {
      std::fclose(f);
      return 1;
    }
    data.insert(data.end(), chunk, chunk + got);
  }
  std::fclose(f);
  return gip_tga_decode(data.data(), data.size(), out, out_h, out_w, out_c);
} catch (...) {  // no-unwind-into-ctypes contract (bad_alloc on slurp)
  return 1;
}

}  // extern "C"
