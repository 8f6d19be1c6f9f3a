// The two HDF5 filters the package's reader (io/hdf5.py) decodes natively,
// because a chunk of several megabytes is too slow in Python:
//   - lzf (h5py's filter 32000): liblzf's lzf_decompress;
//   - szip (filter 4): the CCSDS 121.0 adaptive entropy decoder as libaec
//     runs it behind HDF5's szip filter (sz_compat.c SZ_BufftoBuffDecompress
//     over aec_buffer_decode): the option mask's NN (preprocessing: unit
//     delay predictor and the inverse mapping) and MSB (output byte order),
//     the block size (pixels per block), reference sample intervals of
//     ceil(pixels per scanline / pixels per block) blocks, scanlines padded
//     to whole blocks and 32- and 64-bit pixels coded as interleaved bytes.
//     Each block is: an ID, then zero blocks (with the remainder-of-segment
//     code), the second extension, k-split samples or raw samples.
//
// Entry points (C ABI, loaded with ctypes):
//   h5_lzf_decode(in, n, out, cap)  -> bytes written, -2 when cap is too
//       small (liblzf's E2BIG), or -1 when the data is corrupt (EINVAL)
//   h5_szip_decode(in, n, out, cap, mask, ppb, bpp, pps, err, errlen)
//       -> bytes written, or -1 with a message

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// ------------------------------------------------------------------ lzf
// liblzf's lzf_decompress with CHECK_INPUT, its checks in its order
long lzf_decode(const uint8_t* ip, long n, uint8_t* op, long cap) {
  const uint8_t* in_end = ip + n;
  uint8_t* out = op;
  uint8_t* out_end = op + cap;
  while (ip < in_end) {
    unsigned ctrl = *ip++;
    if (ctrl < (1 << 5)) {  // a literal run of ctrl + 1 bytes
      ++ctrl;
      if (op + ctrl > out_end) return -2;
      if (ip + ctrl > in_end) return -1;
      memcpy(op, ip, ctrl);
      op += ctrl;
      ip += ctrl;
    } else {  // a back reference
      unsigned len = ctrl >> 5;
      long back = long((ctrl & 0x1f) << 8) + 1;
      if (len == 7) {
        if (ip >= in_end) return -1;
        len += *ip++;
      }
      if (ip >= in_end) return -1;
      back += *ip++;
      len += 2;
      if (op + len > out_end) return -2;
      if (back > op - out) return -1;
      const uint8_t* ref = op - back;
      for (unsigned i = 0; i < len; ++i) *op++ = *ref++;  // may overlap
    }
  }
  return long(op - out);
}

// ------------------------------------------------------------------ szip
constexpr int kSzNN = 32, kSzMSB = 16;

struct Bits {  // MSB first
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int n = 0;
  void need(int k) {
    while (n < k) {
      if (p >= end) throw Error("szip data ends early");
      acc = (acc << 8) | *p++;
      n += 8;
    }
  }
  uint32_t get(int k) {
    if (k == 0) return 0;
    need(k);
    n -= k;
    return uint32_t((acc >> n) & ((uint64_t(1) << k) - 1));
  }
  uint32_t fs() {  // a fundamental sequence: zeros up to a one
    uint32_t z = 0;
    while (get(1) == 0) ++z;
    return z;
  }
};

// aec_buffer_decode into out (cap bytes, samples of `bytes` bytes each)
size_t aec_decode(const uint8_t* in, size_t n, uint8_t* out, size_t cap,
                  int bps, int block, int rsi, bool pp, bool msb) {
  const int id_len = bps > 16 ? 5 : bps > 8 ? 4 : 3;
  const int bytes = bps > 16 ? 4 : bps > 8 ? 2 : 1;
  const uint32_t xmax = bps == 32 ? 0xFFFFFFFFu : (uint32_t(1) << bps) - 1;
  const uint32_t med = xmax / 2 + 1;
  const size_t total = cap / bytes;
  Bits br{in, in + n};
  std::vector<uint32_t> buf(size_t(rsi) * block);
  size_t done = 0;
  uint32_t data = 0;  // the last sample written (the predictor)
  // SE table: for m, (beta, first m of that beta)
  int se_beta[91], se_ms[91];
  for (int i = 0, k = 0; i < 13; ++i)
    for (int j = 0, ms = k; j <= i && k < 91; ++j, ++k) {
      se_beta[k] = i;
      se_ms[k] = ms;
    }
  auto put = [&](uint32_t v) {
    uint8_t* o = out + done * bytes;
    for (int b = 0; b < bytes; ++b)
      o[b] = uint8_t(v >> (8 * (msb ? bytes - 1 - b : b)));
    ++done;
  };
  while (done < total) {
    size_t used = 0;  // samples of this RSI
    const size_t rsi_len = size_t(rsi) * block;
    while (used < rsi_len && done + used < total) {
      const int ref = pp && used == 0 ? 1 : 0;
      uint32_t id = br.get(id_len);
      if (id == 0) {  // low entropy: zero blocks or the second extension
        uint32_t se = br.get(1);
        if (ref) buf[used++] = br.get(bps);
        if (se) {
          int i = ref;
          while (i < block) {
            uint32_t m = br.fs();
            if (m > 90) throw Error("szip data is corrupt (bad SE code)");
            int d1 = int(m) - se_ms[m];
            if ((i & 1) == 0) {
              buf[used++] = uint32_t(se_beta[m] - d1);
              ++i;
            }
            buf[used++] = uint32_t(d1);
            ++i;
          }
        } else {
          uint32_t zb = br.fs() + 1;
          if (zb == 5) {  // ROS: to the end of the RSI or of 64 blocks
            size_t b = (used - ref) / block;
            zb = uint32_t(std::min<size_t>(rsi - b, 64 - b % 64));
          } else if (zb > 5) {
            --zb;
          }
          size_t zs = size_t(zb) * block - ref;
          if (used + zs > rsi_len)
            throw Error("szip data is corrupt (zero run)");
          for (size_t i = 0; i < zs; ++i) buf[used++] = 0;
        }
      } else if (id == (uint32_t(1) << id_len) - 1) {  // uncoded
        for (int i = 0; i < block; ++i) buf[used++] = br.get(bps);
      } else {  // split: k low bits under fundamental sequences
        const int k = int(id) - 1;
        if (ref) buf[used++] = br.get(bps);
        const size_t start = used;
        for (int i = ref; i < block; ++i) buf[used++] = br.fs() << k;
        for (size_t i = start; i < used; ++i) buf[i] += br.get(k);
      }
    }
    // write the RSI's samples, undoing the preprocessing
    size_t avail = std::min(used, total - done);
    for (size_t i = 0; i < avail; ++i) {
      uint32_t d = buf[i];
      if (!pp) {
        put(d);
        continue;
      }
      if (i == 0) {  // the reference sample
        data = d;
        put(data);
        continue;
      }
      uint32_t half_d = (d >> 1) + (d & 1);
      uint32_t mask = (data & med) ? xmax : 0;
      if (half_d <= (mask ^ data))
        data += (d >> 1) ^ (~((d & 1) - 1));
      else
        data = mask ^ d;
      data &= xmax;
      put(data);
    }
  }
  return done * bytes;
}

size_t szip_decode(const uint8_t* in, size_t n, uint8_t* dest, size_t cap,
                   int mask, int ppb, int bpp, int pps) {
  if (n < 4) throw Error("szip chunk shorter than its size field");
  size_t want = size_t(in[0]) | size_t(in[1]) << 8 | size_t(in[2]) << 16 |
                size_t(in[3]) << 24;
  if (want > cap) throw Error("szip chunk larger than its chunk");
  in += 4;
  n -= 4;
  if (ppb < 2 || ppb > 64 || ppb % 2 || pps < 1)
    throw Error("szip parameters out of range");
  const bool inter = bpp == 32 || bpp == 64;
  const int bps = inter ? 8 : bpp;
  if (bps < 1 || bps > 32) throw Error("szip bits per pixel out of range");
  const int pixel = bps > 16 ? 4 : bps > 8 ? 2 : 1;
  const int rsi = (pps + ppb - 1) / ppb;
  const int pad = pps % ppb;
  const bool pp = mask & kSzNN, msb = mask & kSzMSB;
  std::vector<uint8_t> buf;
  size_t scanlines = 0;
  if (pad) {
    scanlines = (want / pixel + pps - 1) / pps;
    buf.resize(size_t(rsi) * ppb * pixel * scanlines);
  } else {
    buf.resize(want);
  }
  size_t got = aec_decode(in, n, buf.data(), buf.size(), bps, ppb, rsi, pp,
                          msb);
  size_t total = got;
  if (pad) {  // drop each scanline's padding to whole blocks
    const size_t line = size_t(pps) * pixel, padded = size_t(rsi) * ppb * pixel;
    size_t k = 0;
    for (size_t s = 0; s < scanlines; ++s)
      for (size_t i = 0; i < line; ++i) buf[k++] = buf[s * padded + i];
    total = scanlines * line;
  }
  if (total > want) total = want;
  if (inter) {  // bytes were coded plane by plane
    const size_t w = size_t(bpp / 8), cnt = total / w;
    for (size_t i = 0; i < cnt; ++i)
      for (size_t j = 0; j < w; ++j) dest[i * w + j] = buf[j * cnt + i];
  } else {
    memcpy(dest, buf.data(), total);
  }
  return total;
}

}  // namespace

extern "C" {

long h5_lzf_decode(const uint8_t* in, long n, uint8_t* out, long cap) {
  return lzf_decode(in, n, out, cap);
}

long h5_szip_decode(const uint8_t* in, long n, uint8_t* out, long cap,
                    int mask, int ppb, int bpp, int pps, char* err,
                    int errlen) {
  try {
    return long(szip_decode(in, size_t(n), out, size_t(cap), mask, ppb, bpp,
                            pps));
  } catch (const std::exception& e) {
    if (err && errlen > 0) snprintf(err, size_t(errlen), "%s", e.what());
    return -1;
  }
}

}  // extern "C"
