// Fast PGM/PPM (binary P5/P6) and PFM readers/writers with a C ABI.
//
// The reference's C++ host loads rectified pairs with stb_image/OpenCV
// (SURVEY.md §2.1 C1); this is the framework's native loader for the
// formats Middlebury ships, used by the Python data layer via ctypes with
// a pure-Python fallback (data/middlebury.py). Grayscale conversion for
// P6 uses BT.601 integer luma, matching PIL's convert("L").

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// Skips whitespace and '#' comments, parses a non-negative integer.
bool parse_int(FILE* f, long* out) {
  int c;
  do {
    c = fgetc(f);
    if (c == '#') {
      while (c != '\n' && c != EOF) c = fgetc(f);
    }
  } while (c == ' ' || c == '\t' || c == '\n' || c == '\r');
  if (c < '0' || c > '9') return false;
  long v = 0;
  while (c >= '0' && c <= '9') {
    v = v * 10 + (c - '0');
    c = fgetc(f);
  }
  *out = v;
  return true;
}

}  // namespace

extern "C" {

// Reads header only; returns 0 on success and fills w/h/channels.
int32_t stpu_pnm_probe(const char* path, int64_t* w, int64_t* h,
                       int32_t* channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int p = fgetc(f), n = fgetc(f);
  long ww, hh, maxv;
  int ok = 0;
  if (p == 'P' && (n == '5' || n == '6')) {
    if (parse_int(f, &ww) && parse_int(f, &hh) && parse_int(f, &maxv) &&
        maxv <= 255) {
      *w = ww;
      *h = hh;
      *channels = n == '5' ? 1 : 3;
      ok = 1;
    }
  }
  fclose(f);
  return ok ? 0 : -2;
}

// Reads a P5/P6 image as grayscale uint8 into out[h*w].
int32_t stpu_pnm_read_gray(const char* path, uint8_t* out, int64_t w,
                           int64_t h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int p = fgetc(f), n = fgetc(f);
  long ww, hh, maxv;
  if (p != 'P' || (n != '5' && n != '6') || !parse_int(f, &ww) ||
      !parse_int(f, &hh) || !parse_int(f, &maxv) || ww != w || hh != h ||
      maxv > 255) {
    fclose(f);
    return -2;
  }
  const int64_t npix = w * h;
  int32_t rc = 0;
  if (n == '5') {
    if (fread(out, 1, (size_t)npix, f) != (size_t)npix) rc = -3;
  } else {
    uint8_t* rgb = (uint8_t*)malloc((size_t)npix * 3);
    if (!rgb || fread(rgb, 1, (size_t)npix * 3, f) != (size_t)npix * 3) {
      rc = -3;
    } else {
      for (int64_t i = 0; i < npix; ++i) {
        // PIL "L": (299 R + 587 G + 114 B + 500) / 1000
        const uint32_t r = rgb[i * 3], g = rgb[i * 3 + 1], b = rgb[i * 3 + 2];
        out[i] = (uint8_t)((r * 299u + g * 587u + b * 114u + 500u) / 1000u);
      }
    }
    free(rgb);
  }
  fclose(f);
  return rc;
}

// Writes [h*w] uint8 as binary P5.
int32_t stpu_pnm_write_gray(const char* path, const uint8_t* data, int64_t w,
                            int64_t h) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "P5\n%lld %lld\n255\n", (long long)w, (long long)h);
  const size_t npix = (size_t)(w * h);
  const int32_t rc = fwrite(data, 1, npix, f) == npix ? 0 : -3;
  fclose(f);
  return rc;
}

// PFM (Pf, single channel): probe w/h, then read as float32 top-down rows.
int32_t stpu_pfm_probe(const char* path, int64_t* w, int64_t* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char tag[3] = {0};
  long ww, hh;
  int ok = 0;
  if (fscanf(f, "%2s", tag) == 1 && tag[0] == 'P' && tag[1] == 'f' &&
      parse_int(f, &ww) && parse_int(f, &hh)) {
    *w = ww;
    *h = hh;
    ok = 1;
  }
  fclose(f);
  return ok ? 0 : -2;
}

int32_t stpu_pfm_read(const char* path, float* out, int64_t w, int64_t h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char tag[3] = {0};
  long ww, hh;
  double scale = 0.0;
  if (fscanf(f, "%2s", tag) != 1 || tag[0] != 'P' || tag[1] != 'f' ||
      !parse_int(f, &ww) || !parse_int(f, &hh) ||
      fscanf(f, "%lf", &scale) != 1 || ww != w || hh != h) {
    fclose(f);
    return -2;
  }
  fgetc(f);  // single whitespace after scale
  const bool little = scale < 0.0;
  int32_t rc = 0;
  for (int64_t y = h - 1; y >= 0 && rc == 0; --y) {  // PFM rows: bottom-up
    if (fread(out + y * w, 4, (size_t)w, f) != (size_t)w) rc = -3;
  }
  if (rc == 0 && !little) {
    uint32_t* u = (uint32_t*)out;
    for (int64_t i = 0; i < w * h; ++i) u[i] = __builtin_bswap32(u[i]);
  }
  fclose(f);
  return rc;
}

}  // extern "C"
