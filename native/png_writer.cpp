// Native PNG encoder for python_ray_tracer_jax's viewer/output layer.
//
// The reference's output path is Pillow: viewer/image.py:7-19 builds a PIL
// Image and main.py:53 saves it, making Pillow a hard runtime dependency
// (requirements.txt:4). This framework's output layer is standalone instead:
// an 8-bit RGB PNG encoder in ~150 lines of C++ over the system zlib,
// exposed through a C ABI and loaded with ctypes (utils/native.py). PIL
// remains only as a fallback and as the decode oracle in tests.
//
// Format notes (PNG spec, RFC 2083): signature + IHDR + IDAT + IEND, each
// chunk CRC32'd over type+data. Scanlines use filter type 1 ("Sub") — for
// smooth rendered images it deflates markedly better than filter 0 and is
// a single subtraction per byte to encode.
//
// Build: native/Makefile -> librt_native.so (g++ -O2 -shared -fPIC, -lz).

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

inline void put_be32(uint8_t* p, uint32_t v) {
  p[0] = static_cast<uint8_t>(v >> 24);
  p[1] = static_cast<uint8_t>(v >> 16);
  p[2] = static_cast<uint8_t>(v >> 8);
  p[3] = static_cast<uint8_t>(v);
}

// Append one chunk (length, type, data, crc) to *out, advancing it.
void write_chunk(uint8_t*& out, const char type[4], const uint8_t* data,
                 uint32_t len) {
  put_be32(out, len);
  std::memcpy(out + 4, type, 4);
  if (len) std::memcpy(out + 8, data, len);
  uint32_t crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, out + 4, 4 + len);
  put_be32(out + 8 + len, crc);
  out += 12 + len;
}

}  // namespace

extern "C" {

// Encode an (h, w, 3) row-major RGB8 image (row stride `stride` bytes,
// stride >= 3*w) into a malloc'd PNG buffer. Returns 0 on success and sets
// *out/*out_len; the caller frees with rt_free. `level` is the zlib
// compression level (0-9; 6 = zlib default).
int rt_encode_png(const uint8_t* rgb, int32_t w, int32_t h, int64_t stride,
                  int32_t level, uint8_t** out, size_t* out_len) {
  if (!rgb || !out || !out_len || w <= 0 || h <= 0 || stride < 3LL * w)
    return -1;
  if (level < 0 || level > 9) level = 6;

  const size_t row_bytes = 3u * static_cast<size_t>(w);
  const size_t raw_len = static_cast<size_t>(h) * (1 + row_bytes);
  uint8_t* raw = static_cast<uint8_t*>(std::malloc(raw_len));
  if (!raw) return -2;

  // Filter type 1 (Sub): out[i] = cur[i] - cur[i - 3] (first pixel verbatim).
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* src = rgb + y * stride;
    uint8_t* dst = raw + static_cast<size_t>(y) * (1 + row_bytes);
    *dst++ = 1;
    dst[0] = src[0];
    dst[1] = src[1];
    dst[2] = src[2];
    for (size_t i = 3; i < row_bytes; ++i)
      dst[i] = static_cast<uint8_t>(src[i] - src[i - 3]);
  }

  uLongf zcap = compressBound(raw_len);
  uint8_t* zbuf = static_cast<uint8_t*>(std::malloc(zcap));
  if (!zbuf) {
    std::free(raw);
    return -2;
  }
  int zrc = compress2(zbuf, &zcap, raw, raw_len, level);
  std::free(raw);
  if (zrc != Z_OK) {
    std::free(zbuf);
    return -3;
  }

  // 8 (sig) + IHDR (12+13) + IDAT (12+zcap) + IEND (12)
  const size_t total = 8 + 25 + 12 + zcap + 12;
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(total));
  if (!buf) {
    std::free(zbuf);
    return -2;
  }
  uint8_t* p = buf;
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', 0x0d, 0x0a, 0x1a, 0x0a};
  std::memcpy(p, kSig, 8);
  p += 8;

  uint8_t ihdr[13];
  put_be32(ihdr, static_cast<uint32_t>(w));
  put_be32(ihdr + 4, static_cast<uint32_t>(h));
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type: truecolor RGB
  ihdr[10] = 0;  // compression: deflate
  ihdr[11] = 0;  // filter method 0 (per-scanline filter bytes)
  ihdr[12] = 0;  // no interlace
  write_chunk(p, "IHDR", ihdr, 13);
  write_chunk(p, "IDAT", zbuf, static_cast<uint32_t>(zcap));
  std::free(zbuf);
  write_chunk(p, "IEND", nullptr, 0);

  *out = buf;
  *out_len = static_cast<size_t>(p - buf);
  return 0;
}

// Encode and write to `path`. Returns 0 on success, <0 on encode failure,
// >0 (errno-style 1) on IO failure.
int rt_write_png(const char* path, const uint8_t* rgb, int32_t w, int32_t h,
                 int64_t stride, int32_t level) {
  uint8_t* buf = nullptr;
  size_t len = 0;
  int rc = rt_encode_png(rgb, w, h, stride, level, &buf, &len);
  if (rc != 0) return rc;
  std::FILE* f = std::fopen(path, "wb");
  if (!f) {
    std::free(buf);
    return 1;
  }
  size_t written = std::fwrite(buf, 1, len, f);
  int frc = std::fclose(f);
  std::free(buf);
  return (written == len && frc == 0) ? 0 : 1;
}

void rt_free(uint8_t* p) { std::free(p); }

// ABI version stamp so the ctypes loader can reject a stale build artifact.
int rt_native_abi_version() { return 1; }

}  // extern "C"
