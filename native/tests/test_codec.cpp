// Native codec test program (analog of the reference's C++ test binaries,
// tests/*.cu -- synthetic-image generation + roundtrip + printed verdict).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
void gip_free(void*);
size_t gip_base64_encoded_size(size_t);
size_t gip_base64_encode(const uint8_t*, size_t, char*);
long long gip_base64_decode(const char*, size_t, uint8_t*);
int gip_png_encode(const uint8_t*, int, int, int, int, uint8_t**, size_t*);
int gip_png_decode(const uint8_t*, size_t, uint8_t**, int*, int*, int*);
int gip_ppm_write(const char*, const uint8_t*, int, int, int);
int gip_ppm_read(const char*, uint8_t**, int*, int*, int*);
int gip_bmp_write(const char*, const uint8_t*, int, int, int);
int gip_jpeg_encode(const uint8_t*, int, int, int, int, uint8_t**, size_t*);
int gip_jpeg_decode(const uint8_t*, size_t, uint8_t**, int*, int*, int*);
int gip_tga_write(const char*, const uint8_t*, int, int, int);
int gip_tga_read(const char*, uint8_t**, int*, int*, int*);
}

static int failures = 0;
#define CHECK(cond, msg)                                   \
  do {                                                     \
    if (!(cond)) {                                         \
      std::printf("[FAIL] %s\n", msg);                     \
      ++failures;                                          \
    } else {                                               \
      std::printf("[PASS] %s\n", msg);                     \
    }                                                      \
  } while (0)

// Synthetic test card: white square on gradient (like the reference's
// test_gaussian_blur.cu:22-36 synthetic input).
static std::vector<uint8_t> make_image(int h, int w, int c) {
  std::vector<uint8_t> img((size_t)h * w * c);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      for (int k = 0; k < c; ++k) {
        uint8_t v = (uint8_t)((x * 7 + y * 13 + k * 29) & 0xFF);
        if (y > h / 4 && y < 3 * h / 4 && x > w / 4 && x < 3 * w / 4) v = 255;
        img[((size_t)y * w + x) * c + k] = v;
      }
  return img;
}

int main() {
  // base64 roundtrip
  {
    const char* msg = "GPU image processing native codec";
    size_t n = std::strlen(msg);
    std::vector<char> enc(gip_base64_encoded_size(n) + 1);
    size_t elen = gip_base64_encode((const uint8_t*)msg, n, enc.data());
    std::vector<uint8_t> dec(n + 3);
    long long dlen = gip_base64_decode(enc.data(), elen, dec.data());
    CHECK(dlen == (long long)n && !std::memcmp(dec.data(), msg, n),
          "base64 roundtrip");
  }

  // PNG roundtrip for 1/3/4 channels
  for (int c : {1, 3, 4}) {
    auto img = make_image(37, 53, c);
    uint8_t* png = nullptr;
    size_t plen = 0;
    int rc = gip_png_encode(img.data(), 37, 53, c, 6, &png, &plen);
    char msg[64];
    std::snprintf(msg, sizeof msg, "png encode c=%d", c);
    CHECK(rc == 0 && plen > 8, msg);
    uint8_t* out = nullptr;
    int h = 0, w = 0, oc = 0;
    rc = gip_png_decode(png, plen, &out, &h, &w, &oc);
    std::snprintf(msg, sizeof msg, "png decode c=%d", c);
    CHECK(rc == 0 && h == 37 && w == 53 && oc == c &&
              !std::memcmp(out, img.data(), img.size()),
          msg);
    gip_free(png);
    gip_free(out);
  }

  // PPM roundtrip
  {
    auto img = make_image(24, 31, 3);
    CHECK(gip_ppm_write("/tmp/gip_test.ppm", img.data(), 24, 31, 3) == 0,
          "ppm write");
    uint8_t* out = nullptr;
    int h = 0, w = 0, c = 0;
    int rc = gip_ppm_read("/tmp/gip_test.ppm", &out, &h, &w, &c);
    CHECK(rc == 0 && h == 24 && w == 31 && c == 3 &&
              !std::memcmp(out, img.data(), img.size()),
          "ppm roundtrip");
    gip_free(out);
  }

  // BMP write (smoke: file exists and starts with 'BM')
  {
    auto img = make_image(16, 20, 3);
    CHECK(gip_bmp_write("/tmp/gip_test.bmp", img.data(), 16, 20, 3) == 0,
          "bmp write");
    FILE* f = std::fopen("/tmp/gip_test.bmp", "rb");
    char hdr[2] = {0, 0};
    if (f) {
      std::fread(hdr, 1, 2, f);
      std::fclose(f);
    }
    CHECK(hdr[0] == 'B' && hdr[1] == 'M', "bmp header");
  }

  // TGA roundtrip for 1/3/4 channels (uncompressed top-down write path)
  for (int c : {1, 3, 4}) {
    auto img = make_image(19, 27, c);
    char msg[64];
    std::snprintf(msg, sizeof msg, "tga write c=%d", c);
    CHECK(gip_tga_write("/tmp/gip_test.tga", img.data(), 19, 27, c) == 0, msg);
    uint8_t* out = nullptr;
    int h = 0, w = 0, oc = 0;
    int rc = gip_tga_read("/tmp/gip_test.tga", &out, &h, &w, &oc);
    std::snprintf(msg, sizeof msg, "tga roundtrip c=%d", c);
    CHECK(rc == 0 && h == 19 && w == 27 && oc == c &&
              !std::memcmp(out, img.data(), img.size()),
          msg);
    gip_free(out);
  }

  // TGA RLE + bottom-up decode (the stb-written variant): hand-built 2x2
  // BGR image -- row packets [run of 2 red] (bottom row) then [2 raw pixels
  // green, blue] (top row), origin bottom-left.
  {
    const uint8_t rle_tga[] = {
        0, 0, 10, 0, 0, 0, 0, 0, 0, 0, 0, 0,  // header: type 10 (RLE BGR)
        2, 0, 2, 0, 24, 0,                     // 2x2, 24bpp, bottom-up
        0x81, 0, 0, 255,                       // run(2): red (BGR)
        0x01, 0, 255, 0, 255, 0, 0,            // raw(2): green, blue
    };
    FILE* f = std::fopen("/tmp/gip_rle.tga", "wb");
    std::fwrite(rle_tga, 1, sizeof rle_tga, f);
    std::fclose(f);
    uint8_t* out = nullptr;
    int h = 0, w = 0, oc = 0;
    int rc = gip_tga_read("/tmp/gip_rle.tga", &out, &h, &w, &oc);
    const uint8_t want[] = {0, 255, 0, 0, 0, 255,    // top row: green, blue
                            255, 0, 0, 255, 0, 0};   // bottom row: red, red
    CHECK(rc == 0 && h == 2 && w == 2 && oc == 3 &&
              !std::memcmp(out, want, sizeof want),
          "tga rle bottom-up decode");
    gip_free(out);
  }

  // JPEG roundtrip: smooth gradient, quality 95 -> small reconstruction
  // error (lossy, so a max-diff budget, not bit equality; the same
  // methodology as the reference's L1-vs-L2 maxdiff gate,
  // tests/test_comparison.cu:204-221).
  {
    const int H = 41, W = 67;
    std::vector<uint8_t> img((size_t)H * W * 3);
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) {
        img[((size_t)y * W + x) * 3 + 0] = (uint8_t)(x * 3);
        img[((size_t)y * W + x) * 3 + 1] = (uint8_t)(y * 5);
        img[((size_t)y * W + x) * 3 + 2] = (uint8_t)(128 + ((x + y) & 31));
      }
    uint8_t* jpg = nullptr;
    size_t jlen = 0;
    CHECK(gip_jpeg_encode(img.data(), H, W, 3, 95, &jpg, &jlen) == 0 && jlen > 100,
          "jpeg encode rgb");
    uint8_t* out = nullptr;
    int h = 0, w = 0, c = 0;
    int rc = gip_jpeg_decode(jpg, jlen, &out, &h, &w, &c);
    CHECK(rc == 0 && h == H && w == W && c == 3, "jpeg decode rgb header");
    int maxdiff = 0;
    if (rc == 0)
      for (size_t i = 0; i < img.size(); ++i) {
        int d = std::abs((int)out[i] - (int)img[i]);
        if (d > maxdiff) maxdiff = d;
      }
    char msg[64];
    std::snprintf(msg, sizeof msg, "jpeg rgb roundtrip maxdiff=%d <= 16", maxdiff);
    CHECK(rc == 0 && maxdiff <= 16, msg);
    gip_free(jpg);
    gip_free(out);
  }

  // JPEG grayscale roundtrip
  {
    const int H = 33, W = 29;
    std::vector<uint8_t> img((size_t)H * W);
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) img[(size_t)y * W + x] = (uint8_t)(x * 4 + y * 2);
    uint8_t* jpg = nullptr;
    size_t jlen = 0;
    CHECK(gip_jpeg_encode(img.data(), H, W, 1, 95, &jpg, &jlen) == 0,
          "jpeg encode gray");
    uint8_t* out = nullptr;
    int h = 0, w = 0, c = 0;
    int rc = gip_jpeg_decode(jpg, jlen, &out, &h, &w, &c);
    int maxdiff = 0;
    if (rc == 0)
      for (size_t i = 0; i < img.size(); ++i) {
        int d = std::abs((int)out[i] - (int)img[i]);
        if (d > maxdiff) maxdiff = d;
      }
    char msg[64];
    std::snprintf(msg, sizeof msg,
                  "jpeg gray roundtrip h=%d w=%d c=%d maxdiff=%d <= 8", h, w, c,
                  maxdiff);
    CHECK(rc == 0 && h == H && w == W && c == 1 && maxdiff <= 8, msg);
    gip_free(jpg);
    gip_free(out);
  }

  // JPEG error paths.  Progressive (SOF2) is a SUPPORTED process now, so
  // a truncated SOF2 stream fails as malformed (1), while the genuinely
  // unsupported processes (lossless SOF3) keep the distinct signal 2.
  {
    uint8_t trunc_sof2[8] = {0xFF, 0xD8, 0xFF, 0xC2, 0, 4, 0, 0};
    uint8_t* out = nullptr;
    int h, w, c;
    CHECK(gip_jpeg_decode(trunc_sof2, sizeof trunc_sof2, &out, &h, &w, &c) == 1,
          "jpeg truncated progressive rejected as malformed");
    uint8_t lossless[8] = {0xFF, 0xD8, 0xFF, 0xC3, 0, 4, 0, 0};
    CHECK(gip_jpeg_decode(lossless, sizeof lossless, &out, &h, &w, &c) == 2,
          "jpeg lossless process rejected with code 2");
    uint8_t not_jpeg[4] = {1, 2, 3, 4};
    CHECK(gip_jpeg_decode(not_jpeg, 4, &out, &h, &w, &c) == 1,
          "jpeg bad magic rejected");
  }

  std::printf("\n%s (%d failures)\n", failures ? "FAILED" : "ALL PASSED",
              failures);
  return failures ? 1 : 0;
}
