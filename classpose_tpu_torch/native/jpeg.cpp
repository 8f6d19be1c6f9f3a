// Baseline JPEG codec for the slide reader and writer.
//
// The decoder follows libjpeg's default decompression path step by step,
// so its pixels equal libjpeg-turbo's (and so PIL's) bit for bit:
//   - Huffman decoding of sequential scans (SOF0/SOF1, 8-bit, 1 or 3
//     components, sampling factors 1 or 2, DRI/RSTn, interleaved or not);
//   - the "islow" integer inverse DCT of jidctint.c with its range limit;
//   - "fancy" triangle upsampling (jdsample.c h2v1, h1v2, h2v2), whose
//     context rows repeat the first and the last real sample row;
//   - the fixed-point YCbCr -> RGB tables of jdcolor.c, and libjpeg's rule
//     for whether a 3-component stream is YCbCr or RGB (JFIF APP0, Adobe
//     APP14 transform flag, component ids).
// Progressive, arithmetic-coded, lossless, 12-bit and 4-component streams
// raise with the marker's name.
//
// The encoder writes what libjpeg writes with its defaults and
// jpeg_set_quality(q): a JFIF stream at 4:2:0 (jccolor.c colour tables,
// jcsample.c h2v2 downsampling with its alternating bias, the edge
// replication of jcprepct.c, the dummy blocks of jccoefct.c), the islow
// forward DCT of jfdctint.c, libjpeg-turbo's reciprocal quantization and
// the standard Huffman tables of Annex K.
//
// Entry points (C ABI, loaded with ctypes, which releases the GIL):
//   jpeg_info(data, n, dims[3], err, errlen)   -> 0, or 1 with a message
//   jpeg_decode(data, n, out, cap, err, errlen) -> 0, or 1 with a message;
//       out receives (H, W, 3) RGB uint8 (grey streams are replicated)
//   jpeg_encode(rgb, h, w, quality, out, cap, err, errlen) -> bytes
//       written, or -1 with a message

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

// zig-zag index -> natural (row-major) index; the 16 extra entries absorb
// a run that overshoots coefficient 63 in a corrupt block, as libjpeg does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ------------------------------------------------------------ islow DCT
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// jidctint.c's post-IDCT range limit: the output wraps modulo 1024 as a
// signed 10-bit value, then is clamped to 0..255 after adding 128
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int v = i < 512 ? i : i - 1024;
      v += 128;
      t[i] = uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
};
const RangeLimit kIdctLimit;

// One 8x8 block: dequantize, inverse DCT, write 8 rows of 8 samples.
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dc = (int(ip[0]) * int(qp[0])) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16];
    int64_t z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = int(descale(tmp10 + tmp3, sh));
    wp[56] = int(descale(tmp10 - tmp3, sh));
    wp[8] = int(descale(tmp11 + tmp2, sh));
    wp[48] = int(descale(tmp11 - tmp2, sh));
    wp[16] = int(descale(tmp12 + tmp1, sh));
    wp[40] = int(descale(tmp12 - tmp1, sh));
    wp[24] = int(descale(tmp13 + tmp0, sh));
    wp[32] = int(descale(tmp13 - tmp0, sh));
  }
  const uint8_t* lim = kIdctLimit.t;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    const int sh = kConstBits + kPass1Bits + 3;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 &&
        wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
      uint8_t v = lim[int(descale(wp[0], kPass1Bits + 3)) & 1023];
      memset(op, v, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = lim[int(descale(tmp10 + tmp3, sh)) & 1023];
    op[7] = lim[int(descale(tmp10 - tmp3, sh)) & 1023];
    op[1] = lim[int(descale(tmp11 + tmp2, sh)) & 1023];
    op[6] = lim[int(descale(tmp11 - tmp2, sh)) & 1023];
    op[2] = lim[int(descale(tmp12 + tmp1, sh)) & 1023];
    op[5] = lim[int(descale(tmp12 - tmp1, sh)) & 1023];
    op[3] = lim[int(descale(tmp13 + tmp0, sh)) & 1023];
    op[4] = lim[int(descale(tmp13 - tmp0, sh)) & 1023];
  }
}

// jfdctint.c on samples already centred on 0; 16-bit elements as
// libjpeg-turbo keeps them
void fdct_islow(int16_t* d) {
  for (int r = 0; r < 8; ++r) {
    int16_t* p = d + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int16_t((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = int16_t((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int sh = kConstBits - kPass1Bits;
    p[2] = int16_t(descale(z1 + tmp13 * FIX_0_765366865, sh));
    p[6] = int16_t(descale(z1 + tmp12 * -FIX_1_847759065, sh));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = int16_t(descale(tmp4 + z1 + z3, sh));
    p[5] = int16_t(descale(tmp5 + z2 + z4, sh));
    p[3] = int16_t(descale(tmp6 + z2 + z3, sh));
    p[1] = int16_t(descale(tmp7 + z1 + z4, sh));
  }
  for (int c = 0; c < 8; ++c) {
    int16_t* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int16_t(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = int16_t(descale(tmp10 - tmp11, kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int sh = kConstBits + kPass1Bits;
    p[16] = int16_t(descale(z1 + tmp13 * FIX_0_765366865, sh));
    p[48] = int16_t(descale(z1 + tmp12 * -FIX_1_847759065, sh));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = int16_t(descale(tmp4 + z1 + z3, sh));
    p[40] = int16_t(descale(tmp5 + z2 + z4, sh));
    p[24] = int16_t(descale(tmp6 + z2 + z3, sh));
    p[8] = int16_t(descale(tmp7 + z1 + z4, sh));
  }
}

// ----------------------------------------------------- colour tables
constexpr int kScaleBits = 16;
constexpr int64_t kOneHalf = int64_t(1) << (kScaleBits - 1);
constexpr int64_t fix16(double x) {
  return int64_t(x * (1L << kScaleBits) + 0.5);
}

struct YccToRgb {  // jdcolor.c build_ycc_rgb_table
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccToRgb() {
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((fix16(1.40200) * x + kOneHalf) >> kScaleBits);
      cb_b[i] = int((fix16(1.77200) * x + kOneHalf) >> kScaleBits);
      cr_g[i] = -fix16(0.71414) * x;
      cb_g[i] = -fix16(0.34414) * x + kOneHalf;
    }
  }
};
const YccToRgb kYcc;

struct RgbToYcc {  // jccolor.c rgb_ycc_start
  int64_t ry[256], gy[256], by[256], rcb[256], gcb[256], bcb[256],
      gcr[256], bcr[256];
  RgbToYcc() {
    const int64_t off = int64_t(128) << kScaleBits;
    for (int i = 0; i < 256; ++i) {
      ry[i] = fix16(0.29900) * i;
      gy[i] = fix16(0.58700) * i;
      by[i] = fix16(0.11400) * i + kOneHalf;
      rcb[i] = -fix16(0.16874) * i;
      gcb[i] = -fix16(0.33126) * i;
      bcb[i] = fix16(0.50000) * i + off + kOneHalf - 1;  // also R -> Cr
      gcr[i] = -fix16(0.41869) * i;
      bcr[i] = -fix16(0.08131) * i;
    }
  }
};
const RgbToYcc kRgb;

inline uint8_t clamp255(int v) {
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

// ------------------------------------------------------------ decoder
struct HuffDec {
  bool set = false;
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoff[17];
  uint16_t look[1 << 9];  // (length << 8) | symbol, 0 = longer than 9 bits
};

void build_huff(HuffDec& h, const uint8_t* counts, const uint8_t* vals,
                int nvals) {
  memset(h.look, 0, sizeof(h.look));
  memcpy(h.vals, vals, nvals);
  int32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    h.valoff[l] = k - code;
    if (counts[l - 1]) {
      for (int i = 0; i < counts[l - 1]; ++i, ++code, ++k) {
        if (l <= 9) {
          int base = code << (9 - l);
          for (int j = 0; j < (1 << (9 - l)); ++j)
            h.look[base + j] = uint16_t((l << 8) | vals[k]);
        }
      }
      if (code - 1 >= (1 << l)) throw Error("bad Huffman table");
      h.maxcode[l] = code - 1;
    } else {
      h.maxcode[l] = -1;
    }
    code <<= 1;
  }
  h.maxcode[17] = INT32_MAX;
  h.set = true;
}

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  bool marker = false;  // stopped at a marker: feed zeros from here

  void fill() {
    while (nbits <= 56) {
      unsigned b = 0;
      if (!marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          unsigned b2 = p + 1 < end ? p[1] : 0xD9;
          if (b2 == 0) {
            p += 2;
          } else {
            marker = true;
            b = 0;
          }
        } else {
          ++p;
        }
      }
      acc |= uint64_t(b) << (56 - nbits);
      nbits += 8;
    }
  }
  inline unsigned peek(int n) { return unsigned(acc >> (64 - n)); }
  inline void skip(int n) {
    acc <<= n;
    nbits -= n;
  }
  inline int get(int n) {
    int v = int(acc >> (64 - n));
    skip(n);
    return v;
  }
  void reset() {
    acc = 0;
    nbits = 0;
    marker = false;
  }
};

inline int decode_sym(BitReader& br, const HuffDec& h) {
  if (br.nbits < 32) br.fill();
  uint16_t e = h.look[br.peek(9)];
  if (e) {
    br.skip(e >> 8);
    return e & 0xFF;
  }
  for (int l = 10; l <= 16; ++l) {
    int32_t code = int32_t(br.peek(l));
    if (code <= h.maxcode[l]) {
      br.skip(l);
      return h.vals[(h.valoff[l] + code) & 0xFF];
    }
  }
  throw Error("corrupt JPEG data: bad Huffman code");
}

inline int extend(int v, int t) {
  return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

struct Comp {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int pred = 0;
  int dw, dh;     // downsampled width and height (real samples)
  int bw, bh;     // blocks allocated (MCU-padded)
  std::vector<int16_t> coef;
  uint16_t q[64];
  bool latched = false;
  bool scanned = false;
  std::vector<uint8_t> plane;  // IDCT output, stride pw
  int pw = 0;
};

const char* sof_name(int m) {
  switch (m) {
    case 0xC2: return "SOF2 (progressive)";
    case 0xC3: return "SOF3 (lossless)";
    case 0xC5: return "SOF5 (differential sequential)";
    case 0xC6: return "SOF6 (differential progressive)";
    case 0xC7: return "SOF7 (differential lossless)";
    case 0xC9: return "SOF9 (arithmetic sequential)";
    case 0xCA: return "SOF10 (arithmetic progressive)";
    case 0xCB: return "SOF11 (arithmetic lossless)";
    case 0xCD: return "SOF13 (arithmetic differential sequential)";
    case 0xCE: return "SOF14 (arithmetic differential progressive)";
    case 0xCF: return "SOF15 (arithmetic differential lossless)";
  }
  return "unknown SOF";
}

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_set[4] = {false, false, false, false};
  HuffDec dc[4], ac[4];
  int restart = 0;
  int W = 0, H = 0, nc = 0;
  Comp comp[3];
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  bool have_frame = false, have_scan = false;

  Decoder(const uint8_t* data, size_t len) : d(data), n(len) {}

  int u8() {
    if (pos >= n) throw Error("JPEG data ends early");
    return d[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // next marker code; skips fill bytes and stray data before it
  int next_marker() {
    for (;;) {
      while (pos < n && d[pos] != 0xFF) ++pos;
      while (pos < n && d[pos] == 0xFF) ++pos;
      if (pos >= n) return 0xD9;  // no EOI: treat the end as one
      int m = d[pos++];
      if (m != 0) return m;
    }
  }

  void parse(bool header_only) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8)
      throw Error("not a JPEG stream (no SOI marker)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;
      if (m >= 0xD0 && m <= 0xD7) continue;  // stray RSTn
      if (m == 0x01) continue;              // TEM
      size_t start = pos;
      int len = u16();
      if (len < 2 || start + len > n) throw Error("bad JPEG marker length");
      size_t seg_end = start + len;
      if (m == 0xC0 || m == 0xC1) {
        read_sof();
        if (header_only) return;
      } else if ((m >= 0xC2 && m <= 0xCF) && m != 0xC4 && m != 0xC8 &&
                 m != 0xCC) {
        throw Error(std::string("unsupported JPEG process: ") + sof_name(m));
      } else if (m == 0xCC) {
        throw Error("unsupported JPEG process: DAC (arithmetic coding)");
      } else if (m == 0xC4) {
        read_dht(seg_end);
      } else if (m == 0xDB) {
        read_dqt(seg_end);
      } else if (m == 0xDD) {
        restart = u16();
      } else if (m == 0xDA) {
        if (!have_frame) throw Error("JPEG scan before its frame header");
        read_sos_and_decode(seg_end);
        continue;  // pos is past the entropy-coded data
      } else if (m == 0xE0) {
        // libjpeg's examine_app0: "JFIF\0" with at least 14 data bytes
        if (len - 2 >= 14 && memcmp(d + pos, "JFIF\0", 5) == 0) jfif = true;
      } else if (m == 0xEE) {
        // examine_app14: "Adobe" with at least 12 data bytes
        if (len - 2 >= 12 && memcmp(d + pos, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = d[pos + 11];
        }
      } else if (m == 0xDC) {
        throw Error("unsupported JPEG marker: DNL");
      }
      pos = seg_end;
    }
    if (!have_frame) throw Error("JPEG stream has no frame header");
    if (!header_only && !have_scan) throw Error("JPEG stream has no scan");
  }

  void read_sof() {
    if (have_frame) throw Error("JPEG stream has two frame headers");
    int prec = u8();
    H = u16();
    W = u16();
    nc = u8();
    if (prec != 8)
      throw Error("unsupported JPEG sample precision " +
                  std::to_string(prec) + " (12-bit)");
    if (H == 0) throw Error("unsupported JPEG height 0 (DNL)");
    if (W == 0) throw Error("bad JPEG width 0");
    if (nc != 1 && nc != 3)
      throw Error("unsupported JPEG with " + std::to_string(nc) +
                  " components");
    for (int i = 0; i < nc; ++i) {
      Comp& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2)
        throw Error("unsupported JPEG sampling factors " +
                    std::to_string(c.h) + "x" + std::to_string(c.v));
      if (c.tq > 3) throw Error("bad JPEG quantization table index");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (W + 8 * hmax - 1) / (8 * hmax);
    mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < nc; ++i) {
      Comp& c = comp[i];
      c.dw = (W * c.h + hmax - 1) / hmax;
      c.dh = (H * c.v + vmax - 1) / vmax;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
    }
    have_frame = true;
  }

  void read_dht(size_t seg_end) {
    while (pos < seg_end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw Error("bad JPEG Huffman table index");
      if (pos + 16 > seg_end) throw Error("bad JPEG DHT segment");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = uint8_t(u8());
      if (total > 256 || pos + total > seg_end)
        throw Error("bad JPEG Huffman table");
      build_huff(tc ? ac[th] : dc[th], counts, d + pos, total);
      pos += total;
    }
  }

  void read_dqt(size_t seg_end) {
    while (pos < seg_end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) throw Error("bad JPEG quantization table");
      for (int k = 0; k < 64; ++k)
        qt[tq][kNatural[k]] = uint16_t(pq ? u16() : u8());
      qt_set[tq] = true;
    }
  }

  void read_sos_and_decode(size_t seg_end) {
    int ns = u8();
    if (ns < 1 || ns > nc) throw Error("bad JPEG scan component count");
    Comp* sc[3];
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      Comp* c = nullptr;
      for (int j = 0; j < nc; ++j)
        if (comp[j].id == id) c = &comp[j];
      if (!c) throw Error("JPEG scan names an unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3) throw Error("bad JPEG Huffman index");
      if (!dc[c->td].set || !ac[c->ta].set)
        throw Error("JPEG scan uses an undefined Huffman table");
      sc[i] = c;
    }
    pos = seg_end;  // Ss, Se, Ah/Al: sequential scans use the whole block
    for (int i = 0; i < ns; ++i) {
      Comp& c = *sc[i];
      if (!c.latched) {
        if (!qt_set[c.tq])
          throw Error("JPEG component uses an undefined quantization table");
        memcpy(c.q, qt[c.tq], sizeof(c.q));
        c.latched = true;
      }
      if (c.coef.empty()) c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
      c.pred = 0;
      c.scanned = true;
    }
    BitReader br{d + pos, d + n};
    int todo = restart;
    auto mcu_start = [&]() {
      if (restart == 0) return;
      if (todo == 0) {
        // discard the partial byte, find RSTn, restart prediction
        const uint8_t* p = br.p;
        while (p + 1 < br.end && !(p[0] == 0xFF && p[1] >= 0xD0 &&
                                   p[1] <= 0xD7))
          ++p;
        br.p = p + 1 < br.end ? p + 2 : br.end;
        br.reset();
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
        todo = restart;
      }
      --todo;
    };
    if (ns == 1) {
      Comp& c = *sc[0];
      int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
      for (int by = 0; by < nby; ++by)
        for (int bx = 0; bx < nbx; ++bx) {
          mcu_start();
          decode_block(br, c, &c.coef[(size_t(by) * c.bw + bx) * 64]);
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          mcu_start();
          for (int i = 0; i < ns; ++i) {
            Comp& c = *sc[i];
            for (int yy = 0; yy < c.v; ++yy)
              for (int xx = 0; xx < c.h; ++xx) {
                size_t by = size_t(my) * c.v + yy, bx = size_t(mx) * c.h + xx;
                decode_block(br, c, &c.coef[(by * c.bw + bx) * 64]);
              }
          }
        }
    }
    pos = size_t(br.p - d);
    have_scan = true;
  }

  inline void decode_block(BitReader& br, Comp& c, int16_t* blk) {
    const HuffDec& hd = dc[c.td];
    const HuffDec& ha = ac[c.ta];
    int s = decode_sym(br, hd);
    if (s) {
      if (s > 16) throw Error("corrupt JPEG data: bad DC category");
      if (br.nbits < 32) br.fill();
      s = extend(br.get(s), s);
    }
    c.pred = int(unsigned(c.pred) + unsigned(s));  // wraps, as JCOEF does
    blk[0] = int16_t(c.pred);
    for (int k = 1; k < 64; ++k) {
      int rs = decode_sym(br, ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (br.nbits < 32) br.fill();
        blk[kNatural[k]] = int16_t(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void idct_all() {
    for (int i = 0; i < nc; ++i) {
      Comp& c = comp[i];
      if (!c.scanned) throw Error("JPEG component was never scanned");
      int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
      c.pw = nbx * 8;
      c.plane.assign(size_t(c.pw) * nby * 8, 0);
      for (int by = 0; by < nby; ++by)
        for (int bx = 0; bx < nbx; ++bx)
          idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], c.q,
                     &c.plane[size_t(by) * 8 * c.pw + bx * 8], c.pw);
    }
  }

  // one full-resolution row y of component c into out[0..W)
  void upsample_row(const Comp& c, int y, uint8_t* out,
                    std::vector<int>& colsum) const {
    bool h2 = c.h < hmax, v2 = c.v < vmax;
    const uint8_t* plane = c.plane.data();
    int pw = c.pw, dw = c.dw, dh = c.dh;
    if (!v2) {
      const uint8_t* row = plane + size_t(y) * pw;
      if (!h2) {
        memcpy(out, row, W);
      } else if (dw > 2) {  // h2v1_fancy_upsample
        for (int x = 0; x < W; ++x) {
          int cc = x >> 1;
          int v;
          if (x & 1)
            v = cc == dw - 1 ? row[cc] : (row[cc] * 3 + row[cc + 1] + 2) >> 2;
          else
            v = cc == 0 ? row[0] : (row[cc] * 3 + row[cc - 1] + 1) >> 2;
          out[x] = uint8_t(v);
        }
      } else {
        for (int x = 0; x < W; ++x) out[x] = row[x >> 1];
      }
      return;
    }
    int r = y >> 1;
    const uint8_t* row = plane + size_t(r) * pw;
    if (!h2) {  // h1v2_fancy_upsample
      int rn = (y & 1) ? std::min(r + 1, dh - 1) : std::max(r - 1, 0);
      int bias = (y & 1) ? 2 : 1;
      const uint8_t* nb = plane + size_t(rn) * pw;
      for (int x = 0; x < W; ++x)
        out[x] = uint8_t((row[x] * 3 + nb[x] + bias) >> 2);
      return;
    }
    if (dw <= 2) {  // h2v2_upsample (box)
      for (int x = 0; x < W; ++x) out[x] = row[x >> 1];
      return;
    }
    // h2v2_fancy_upsample
    int rn = (y & 1) ? std::min(r + 1, dh - 1) : std::max(r - 1, 0);
    const uint8_t* nb = plane + size_t(rn) * pw;
    colsum.resize(dw);
    for (int cc = 0; cc < dw; ++cc) colsum[cc] = row[cc] * 3 + nb[cc];
    for (int x = 0; x < W; ++x) {
      int cc = x >> 1;
      int v;
      if (x & 1)
        v = cc == dw - 1 ? (colsum[cc] * 4 + 7) >> 4
                         : (colsum[cc] * 3 + colsum[cc + 1] + 7) >> 4;
      else
        v = cc == 0 ? (colsum[0] * 4 + 8) >> 4
                    : (colsum[cc] * 3 + colsum[cc - 1] + 8) >> 4;
      out[x] = uint8_t(v);
    }
  }

  bool is_rgb() const {  // jdapimin.c default_decompress_parms
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }

  void output(uint8_t* out) {
    idct_all();
    std::vector<int> colsum;
    if (nc == 1) {
      std::vector<uint8_t> g(W);
      for (int y = 0; y < H; ++y) {
        upsample_row(comp[0], y, g.data(), colsum);
        uint8_t* o = out + size_t(y) * W * 3;
        for (int x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
      }
      return;
    }
    std::vector<uint8_t> a(W), b(W), c(W);
    bool rgb = is_rgb();
    for (int y = 0; y < H; ++y) {
      upsample_row(comp[0], y, a.data(), colsum);
      upsample_row(comp[1], y, b.data(), colsum);
      upsample_row(comp[2], y, c.data(), colsum);
      uint8_t* o = out + size_t(y) * W * 3;
      if (rgb) {
        for (int x = 0; x < W; ++x) {
          o[3 * x] = a[x];
          o[3 * x + 1] = b[x];
          o[3 * x + 2] = c[x];
        }
        continue;
      }
      for (int x = 0; x < W; ++x) {  // jdcolor.c ycc_rgb_convert
        int yy = a[x], cb = b[x], cr = c[x];
        o[3 * x] = clamp255(yy + kYcc.cr_r[cr]);
        o[3 * x + 1] = clamp255(
            yy + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> kScaleBits));
        o[3 * x + 2] = clamp255(yy + kYcc.cb_b[cb]);
      }
    }
  }
};

// ------------------------------------------------------------ encoder
const uint8_t kStdLumaQ[64] = {  // natural order
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3,
                                 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4,
                                   7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffEnc {
  uint16_t code[256];
  uint8_t size[256];
};

void build_enc(HuffEnc& e, const uint8_t* bits, const uint8_t* vals) {
  memset(e.size, 0, sizeof(e.size));
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
      e.code[vals[k]] = uint16_t(code);
      e.size[vals[k]] = uint8_t(l);
    }
    code <<= 1;
  }
}

// jcdctmgr.c compute_reciprocal with 16-bit DCT elements
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(unsigned divisor) {
  Divisor r;
  if (divisor == 1) return {1, 0, -16};
  int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
  int rr = 16 + b;
  uint32_t fq = (uint32_t(1) << rr) / divisor;
  uint32_t fr = (uint32_t(1) << rr) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --rr;
  } else if (fr <= divisor / 2U) {
    ++c;
  } else {
    ++fq;
  }
  r.recip = fq & 0xFFFF;
  r.corr = c & 0xFFFF;
  r.shift = rr - 16;
  return r;
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  inline void put(uint32_t v, int n) {
    acc = (acc << n) | (v & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      uint8_t b = uint8_t(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits) put(0x7F, 8 - nbits);  // pad with ones
  }
};

void put_marker(std::vector<uint8_t>& o, int m) {
  o.push_back(0xFF);
  o.push_back(uint8_t(m));
}
void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v));
}

void put_dht(std::vector<uint8_t>& o, int cls_id, const uint8_t* bits,
             const uint8_t* vals) {
  int total = 0;
  for (int i = 0; i < 16; ++i) total += bits[i];
  put_marker(o, 0xC4);
  put16(o, 2 + 1 + 16 + total);
  o.push_back(uint8_t(cls_id));
  o.insert(o.end(), bits, bits + 16);
  o.insert(o.end(), vals, vals + total);
}

void encode_block(BitWriter& bw, const int16_t* blk, int& last_dc,
                  const HuffEnc& dc, const HuffEnc& ac) {
  int t = blk[0] - last_dc;
  last_dc = blk[0];
  int t2 = t;
  if (t < 0) {
    t = -t;
    --t2;
  }
  int nb = t ? 32 - __builtin_clz(unsigned(t)) : 0;
  bw.put(dc.code[nb], dc.size[nb]);
  if (nb) bw.put(uint32_t(t2), nb);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = blk[kNatural[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    int a = v, a2 = v;
    if (a < 0) {
      a = -a;
      --a2;
    }
    nb = 32 - __builtin_clz(unsigned(a));
    int sym = (run << 4) + nb;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(uint32_t(a2), nb);
    run = 0;
  }
  if (run > 0) bw.put(ac.code[0], ac.size[0]);
}

struct Plane {
  int w, h;
  std::vector<uint8_t> px;
  uint8_t at(int y, int x) const { return px[size_t(y) * w + x]; }
};

std::vector<uint8_t> encode(const uint8_t* rgb, int H, int W, int quality) {
  if (H < 1 || W < 1 || H > 65535 || W > 65535)
    throw Error("JPEG image size out of range");
  // jcparam.c jpeg_quality_scaling + jpeg_add_quant_table(force_baseline)
  quality = std::min(std::max(quality, 1), 100);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t q[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) {
      long v = (long((t ? kStdChromaQ : kStdLumaQ)[i]) * scale + 50) / 100;
      q[t][i] = uint16_t(std::min(std::max(v, 1L), 255L));
    }
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal(unsigned(q[t][i]) << 3);

  // colour conversion, then the padded sample planes the DCT reads
  const int mcux = (W + 15) / 16, mcuy = (H + 15) / 16;
  const int ybw = (W + 7) / 8, ybh = (H + 7) / 8;
  const int cdw = (W + 1) / 2, cdh = (H + 1) / 2;
  const int cbw = (cdw + 7) / 8, cbh = (cdh + 7) / 8;
  // Y: right edge replicated to ybw*8 columns, bottom to the iMCU height
  Plane Y{ybw * 8, mcuy * 16, {}};
  Y.px.resize(size_t(Y.w) * Y.h);
  // Cb, Cr at full resolution, padded to the downsampler's input
  const int fw = cbw * 16, fh = (H + 1) / 2 * 2;
  std::vector<uint8_t> cbf(size_t(fw) * fh), crf(size_t(fw) * fh);
  for (int y = 0; y < fh; ++y) {
    int sy = std::min(y, H - 1);
    const uint8_t* src = rgb + size_t(sy) * W * 3;
    uint8_t* yr = y < Y.h ? &Y.px[size_t(y) * Y.w] : nullptr;
    for (int x = 0; x < fw; ++x) {
      int sx = std::min(x, W - 1);
      int r = src[3 * sx], g = src[3 * sx + 1], b = src[3 * sx + 2];
      if (yr && x < Y.w)
        yr[x] = uint8_t((kRgb.ry[r] + kRgb.gy[g] + kRgb.by[b]) >> kScaleBits);
      cbf[size_t(y) * fw + x] =
          uint8_t((kRgb.rcb[r] + kRgb.gcb[g] + kRgb.bcb[b]) >> kScaleBits);
      crf[size_t(y) * fw + x] =
          uint8_t((kRgb.bcb[r] + kRgb.gcr[g] + kRgb.bcr[b]) >> kScaleBits);
    }
  }
  for (int y = fh; y < Y.h; ++y)  // bottom rows repeat the last one
    memcpy(&Y.px[size_t(y) * Y.w], &Y.px[size_t(H - 1) * Y.w], Y.w);
  // jcsample.c h2v2_downsample (bias 1, 2, 1, 2, ...), then the
  // downsampled rows padded to the iMCU height
  Plane C[2] = {{cbw * 8, mcuy * 8, {}}, {cbw * 8, mcuy * 8, {}}};
  const std::vector<uint8_t>* full[2] = {&cbf, &crf};
  for (int t = 0; t < 2; ++t) {
    Plane& P = C[t];
    P.px.resize(size_t(P.w) * P.h);
    const std::vector<uint8_t>& F = *full[t];
    int rows = fh / 2;
    for (int y = 0; y < rows; ++y) {
      const uint8_t* r0 = &F[size_t(2 * y) * fw];
      const uint8_t* r1 = r0 + fw;
      int bias = 1;
      for (int x = 0; x < P.w; ++x) {
        P.px[size_t(y) * P.w + x] = uint8_t(
            (r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
    for (int y = rows; y < P.h; ++y)
      memcpy(&P.px[size_t(y) * P.w], &P.px[size_t(rows - 1) * P.w], P.w);
  }

  auto fdct_quant = [&](const Plane& P, int by, int bx, const Divisor* dv,
                        int16_t* outb) {
    int16_t ws[64];
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c)
        ws[8 * r + c] = int16_t(int(P.at(by * 8 + r, bx * 8 + c)) - 128);
    fdct_islow(ws);
    for (int i = 0; i < 64; ++i) {  // jcdctmgr.c quantize
      int t = ws[i];
      bool neg = t < 0;
      if (neg) t = -t;
      uint32_t prod = uint32_t(t + int(dv[i].corr)) * dv[i].recip;
      prod >>= dv[i].shift + 16;
      int v = int16_t(prod);
      outb[i] = int16_t(neg ? -v : v);
    }
  };

  std::vector<uint8_t> o;
  o.reserve(size_t(W) * H / 2 + 1024);
  put_marker(o, 0xD8);
  const uint8_t app0[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  put_marker(o, 0xE0);
  put16(o, 16);
  o.insert(o.end(), app0, app0 + 14);
  for (int t = 0; t < 2; ++t) {
    put_marker(o, 0xDB);
    put16(o, 67);
    o.push_back(uint8_t(t));
    for (int k = 0; k < 64; ++k) o.push_back(uint8_t(q[t][kNatural[k]]));
  }
  put_marker(o, 0xC0);
  put16(o, 17);
  o.push_back(8);
  put16(o, H);
  put16(o, W);
  o.push_back(3);
  const uint8_t sof[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  o.insert(o.end(), sof, sof + 9);
  put_dht(o, 0x00, kDcLumaBits, kDcVals);
  put_dht(o, 0x10, kAcLumaBits, kAcLumaVals);
  put_dht(o, 0x01, kDcChromaBits, kDcVals);
  put_dht(o, 0x11, kAcChromaBits, kAcChromaVals);
  put_marker(o, 0xDA);
  put16(o, 12);
  const uint8_t sos[10] = {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  o.insert(o.end(), sos, sos + 10);

  HuffEnc hdc[2], hac[2];
  build_enc(hdc[0], kDcLumaBits, kDcVals);
  build_enc(hdc[1], kDcChromaBits, kDcVals);
  build_enc(hac[0], kAcLumaBits, kAcLumaVals);
  build_enc(hac[1], kAcChromaBits, kAcChromaVals);
  BitWriter bw(o);
  int last_dc[3] = {0, 0, 0};
  int16_t blk[6][64];
  // jccoefct.c: real blocks past a component's width or height in the
  // last MCU column or row are dummies: zero, with the DC of the block
  // before them in the MCU
  auto comp_blocks = [&](const Plane& P, int nbw, int nbh, int hs, int vs,
                         int my, int mx, const Divisor* dv, int16_t (*b)[64]) {
    for (int yy = 0; yy < vs; ++yy)
      for (int xx = 0; xx < hs; ++xx) {
        int by = my * vs + yy, bx = mx * hs + xx;
        int16_t* cur = b[yy * hs + xx];
        if (by < nbh && bx < nbw) {
          fdct_quant(P, by, bx, dv, cur);
        } else {
          memset(cur, 0, 64 * sizeof(int16_t));
          const int16_t* prev = by < nbh ? b[yy * hs + xx - 1]
                                         : b[yy * hs - 1];
          cur[0] = prev[0];
        }
      }
  };
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx) {
      comp_blocks(Y, ybw, ybh, 2, 2, my, mx, div[0], blk);
      comp_blocks(C[0], cbw, cbh, 1, 1, my, mx, div[1], blk + 4);
      comp_blocks(C[1], cbw, cbh, 1, 1, my, mx, div[1], blk + 5);
      for (int i = 0; i < 4; ++i)
        encode_block(bw, blk[i], last_dc[0], hdc[0], hac[0]);
      encode_block(bw, blk[4], last_dc[1], hdc[1], hac[1]);
      encode_block(bw, blk[5], last_dc[2], hdc[1], hac[1]);
    }
  bw.flush();
  put_marker(o, 0xD9);
  return o;
}

void set_err(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) snprintf(err, size_t(errlen), "%s", msg);
}

}  // namespace

extern "C" {

int jpeg_info(const uint8_t* data, long n, int* dims, char* err,
              int errlen) {
  try {
    Decoder dec(data, size_t(n));
    dec.parse(true);
    dims[0] = dec.H;
    dims[1] = dec.W;
    dims[2] = dec.nc;
    return 0;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 1;
  }
}

int jpeg_decode(const uint8_t* data, long n, uint8_t* out, long cap,
                char* err, int errlen) {
  try {
    Decoder dec(data, size_t(n));
    dec.parse(false);
    if (long(dec.H) * dec.W * 3 > cap)
      throw Error("output buffer too small");
    dec.output(out);
    return 0;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 1;
  }
}

long jpeg_encode(const uint8_t* rgb, int h, int w, int quality, uint8_t* out,
                 long cap, char* err, int errlen) {
  try {
    std::vector<uint8_t> o = encode(rgb, h, w, quality);
    if (long(o.size()) > cap) throw Error("output buffer too small");
    memcpy(out, o.data(), o.size());
    return long(o.size());
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return -1;
  }
}

}  // extern "C"
