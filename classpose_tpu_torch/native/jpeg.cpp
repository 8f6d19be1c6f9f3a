// JPEG codec for the slide reader and writer.
//
// The decoder follows libjpeg-turbo 3.1's default decompression path step
// by step, so its pixels equal libjpeg-turbo's (and so PIL's) bit for bit:
//   - Huffman decoding of sequential scans (SOF0/SOF1) and of progressive
//     ones (SOF2, jdphuff.c: DC and AC first and refinement scans, EOB
//     runs), arithmetic decoding of both (SOF9/SOF10, jdarith.c, with the
//     DAC conditioning), lossless decoding (SOF3, jdlhuff.c and
//     jdlossls.c: predictors 1-7, point transform); 8-bit samples, 1, 3 or
//     4 components, sampling factors 1 to 4 with integral ratios, DRI/RSTn,
//     interleaved or not, the Annex K tables in Huffman slots 0 and 1 a
//     sequential stream leaves undefined;
//   - the block smoothing of a progressive image whose low-frequency
//     coefficients are not all known (jdcoefct.c decompress_smooth_data);
//   - the "islow" integer inverse DCT as libjpeg-turbo's x86-64 SIMD code
//     computes it (16-bit products and sums that wrap, saturation);
//   - "fancy" triangle upsampling (jdsample.c h2v1, h1v2, h2v2), whose
//     context rows repeat the first and the last real sample row, and
//     box replication for other ratios and for lossless images;
//   - the fixed-point YCbCr -> RGB tables of jdcolor.c, libjpeg's rule
//     for whether a 3-component stream is YCbCr or RGB (JFIF APP0, Adobe
//     APP14 transform flag, component ids; RGB for an unmarked lossless
//     stream), and for 4 components CMYK or YCCK (ycck_cmyk_convert)
//     followed by what PIL does with them: the samples read as inverted
//     CMYK and Pillow's cmyk2rgb.
// A damaged stream goes as it goes in libjpeg-turbo through PIL: a
// stream that ends before EOI raises (PIL's "image file is truncated"),
// unless the frame's one scan was decoded without reading past the end;
// a bad Huffman code decodes as symbol 0 after 17 bits; a marker inside
// entropy-coded data feeds zero bits, and once a code needs them, the
// rest of the restart interval is left as it is; a wrong RSTn is resynced
// to as jpeg_resync_to_restart does; a bad arithmetic code leaves the rest
// of its restart interval; a run past coefficient 63 writes coefficient
// 63; a bad Huffman table refuses only a scan that uses it.
// What libjpeg-turbo (or PIL) refuses raises with its name: hierarchical
// and arithmetic-lossless processes (SOF5-7, SOF11, SOF13-15), height 0 (DNL),
// precisions other than 8, 2 components, fractional sampling, more than
// 10 blocks in an interleaved MCU, scan parameters libjpeg rejects, and
// colour conversion of a lossless stream.
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

// One 8x8 block: dequantize, inverse DCT, write 8 rows of 8 samples, as
// libjpeg-turbo's x86-64 SIMD "islow" IDCT (jidctint-avx2.asm, which the
// SSE2 one equals) computes it, not as jidctint.c: the products with the
// quantizers, in0 +- in4 and the odd part's z3 = in7 + in3, z4 = in5 + in1
// are 16-bit and wrap, each pass's outputs saturate to 16 bits, and the
// samples saturate to -128..127 before the +128 (the C version wraps them
// modulo 1024 before its clamp). A clean stream never reaches these limits
// (the two agree); a corrupt one does. Pass 1 takes a shortcut when every
// coefficient past the first row is zero: its DC, << 2, wraps.
inline int16_t sat16(int32_t v) {
  return int16_t(v < -32768 ? -32768 : v > 32767 ? 32767 : v);
}

// dodct on one vector of 8 (16-bit inputs): outputs descaled by `shift`,
// saturated, to out[0], out[os], ... The products with the constants fit
// 32 bits (vpmaddwd); sums wrap at 32 bits (vpaddd), so they are taken
// unsigned.
template <int shift>
inline void idct_1d(int32_t in0, int32_t in1, int32_t in2, int32_t in3,
                    int32_t in4, int32_t in5, int32_t in6, int32_t in7,
                    int16_t* out, int os) {
  typedef uint32_t u;
  const u tmp3 = u(in2 * int32_t(FIX_0_541196100 + FIX_0_765366865)) +
                 u(in6 * int32_t(FIX_0_541196100));
  const u tmp2 = u(in2 * int32_t(FIX_0_541196100)) +
                 u(in6 * int32_t(FIX_0_541196100 - FIX_1_847759065));
  const u t0 = u(int32_t(int16_t(in0 + in4)) * (1 << kConstBits));
  const u t1 = u(int32_t(int16_t(in0 - in4)) * (1 << kConstBits));
  const u tmp10 = t0 + tmp3, tmp13 = t0 - tmp3, tmp11 = t1 + tmp2,
          tmp12 = t1 - tmp2;
  const int32_t z3 = int16_t(in7 + in3), z4 = int16_t(in5 + in1);
  const u z3p = u(z3 * int32_t(FIX_1_175875602 - FIX_1_961570560)) +
                u(z4 * int32_t(FIX_1_175875602));
  const u z4p = u(z3 * int32_t(FIX_1_175875602)) +
                u(z4 * int32_t(FIX_1_175875602 - FIX_0_390180644));
  const u o0 = u(in7 * int32_t(FIX_0_298631336 - FIX_0_899976223)) +
               u(in1 * int32_t(-FIX_0_899976223)) + z3p;
  const u o1 = u(in5 * int32_t(FIX_2_053119869 - FIX_2_562915447)) +
               u(in3 * int32_t(-FIX_2_562915447)) + z4p;
  const u o2 = u(in5 * int32_t(-FIX_2_562915447)) +
               u(in3 * int32_t(FIX_3_072711026 - FIX_2_562915447)) + z3p;
  const u o3 = u(in7 * int32_t(-FIX_0_899976223)) +
               u(in1 * int32_t(FIX_1_501321110 - FIX_0_899976223)) + z4p;
  const u rnd = u(1) << (shift - 1);
  out[0] = sat16(int32_t(tmp10 + o3 + rnd) >> shift);
  out[7 * os] = sat16(int32_t(tmp10 - o3 + rnd) >> shift);
  out[os] = sat16(int32_t(tmp11 + o2 + rnd) >> shift);
  out[6 * os] = sat16(int32_t(tmp11 - o2 + rnd) >> shift);
  out[2 * os] = sat16(int32_t(tmp12 + o1 + rnd) >> shift);
  out[5 * os] = sat16(int32_t(tmp12 - o1 + rnd) >> shift);
  out[3 * os] = sat16(int32_t(tmp13 + o0 + rnd) >> shift);
  out[4 * os] = sat16(int32_t(tmp13 - o0 + rnd) >> shift);
}

void idct_islow_simd(const int16_t* in, const uint16_t* q, uint8_t* out,
                     int stride) {
  int16_t ws[64];  // pass 1's outputs, row-major
  bool ac_zero = true;
  for (int k = 8; k < 64 && ac_zero; ++k) ac_zero = in[k] == 0;
  // the dequantized coefficient: its low 16 bits (vpmullw)
  auto dq = [&](int k) { return int32_t(int16_t(in[k] * q[k])); };
  for (int c = 0; c < 8; ++c) {
    if (ac_zero) {  // the shortcut: DC << 2 in 16 bits
      const int16_t v = int16_t(uint16_t(dq(c)) << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
    } else if (in[8 + c] == 0 && in[16 + c] == 0 && in[24 + c] == 0 &&
               in[32 + c] == 0 && in[40 + c] == 0 && in[48 + c] == 0 &&
               in[56 + c] == 0) {  // what the general path gives
      const int16_t v = sat16(dq(c) * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
    } else {
      idct_1d<kConstBits - kPass1Bits>(dq(c), dq(8 + c), dq(16 + c),
                                       dq(24 + c), dq(32 + c), dq(40 + c),
                                       dq(48 + c), dq(56 + c), ws + c, 8);
    }
  }
  for (int r = 0; r < 8; ++r) {
    const int16_t* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    int16_t res[8];
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 &&
        wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
      const int v = (int(wp[0]) + 16) >> 5;
      const int s = v < -128 ? -128 : v > 127 ? 127 : v;
      memset(op, s + 128, 8);
      continue;
    }
    idct_1d<kConstBits + kPass1Bits + 3>(wp[0], wp[1], wp[2], wp[3], wp[4],
                                         wp[5], wp[6], wp[7], res, 1);
    for (int c = 0; c < 8; ++c)
      op[c] = uint8_t((res[c] < -128 ? -128 : res[c] > 127 ? 127 : res[c]) +
                      128);
  }
}

// clamp(v, -128, 127) + 128, the SIMD code's sample, for |v| < 8192: past
// idct_islow's checks a sample's magnitude stays under 8 * 16384 * sqrt(2)
// / 32 < 5800
struct SatTable {
  uint8_t t[16384];
  SatTable() {
    for (int i = 0; i < 16384; ++i) {
      int v = i - 8192;
      t[i] = uint8_t((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
    }
  }
};
const SatTable kSat;

// The same block by jidctint.c's arithmetic, which equals the SIMD code's
// wherever none of its 16-bit values can wrap or saturate: every
// dequantized coefficient and every pass-1 output within -16384..16383 (so
// no sum of two of them leaves 16 bits either); the samples saturate as the
// SIMD code's do. A block past those limits (only a corrupt stream's)
// goes to idct_islow_simd.
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  uint32_t wide = 0;  // nonzero once a value leaves -16384..16383
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      const int32_t dc = int32_t(ip[0]) * qp[0];
      wide |= (uint32_t(dc) + 4096u) >> 13;  // dc << 2 stays in range
      const int v = dc * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = v;
      continue;
    }
    const int32_t d0 = int32_t(ip[0]) * qp[0], d1 = int32_t(ip[8]) * qp[8],
                  d2 = int32_t(ip[16]) * qp[16], d3 = int32_t(ip[24]) * qp[24],
                  d4 = int32_t(ip[32]) * qp[32], d5 = int32_t(ip[40]) * qp[40],
                  d6 = int32_t(ip[48]) * qp[48], d7 = int32_t(ip[56]) * qp[56];
    wide |= ((uint32_t(d0) + 16384u) | (uint32_t(d1) + 16384u) |
             (uint32_t(d2) + 16384u) | (uint32_t(d3) + 16384u) |
             (uint32_t(d4) + 16384u) | (uint32_t(d5) + 16384u) |
             (uint32_t(d6) + 16384u) | (uint32_t(d7) + 16384u)) >> 15;
    int64_t z2 = d2;
    int64_t z3 = d6;
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = d0;
    z3 = d4;
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = d7;
    tmp1 = d5;
    tmp2 = d3;
    tmp3 = d1;
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
  uint32_t w2 = 0;
  for (int k = 0; k < 64; ++k) w2 |= uint32_t(ws[k]) + 16384u;
  if ((wide | (w2 >> 15)) != 0) return idct_islow_simd(in, q, out, stride);
  const uint8_t* sat = kSat.t + 8192;
  auto sample = [sat](int64_t v) { return sat[v]; };
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    const int sh = kConstBits + kPass1Bits + 3;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 &&
        wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
      memset(op, sample(descale(wp[0], kPass1Bits + 3)), 8);
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
    op[0] = sample(descale(tmp10 + tmp3, sh));
    op[7] = sample(descale(tmp10 - tmp3, sh));
    op[1] = sample(descale(tmp11 + tmp2, sh));
    op[6] = sample(descale(tmp11 - tmp2, sh));
    op[2] = sample(descale(tmp12 + tmp1, sh));
    op[5] = sample(descale(tmp12 - tmp1, sh));
    op[3] = sample(descale(tmp13 + tmp0, sh));
    op[4] = sample(descale(tmp13 - tmp0, sh));
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

// the Annex K Huffman tables: the encoder's, and what libjpeg-turbo loads
// into the Huffman slots 0 and 1 a stream leaves undefined (jstdhuff.c)
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

// ------------------------------------------------------------ decoder
// A Huffman table as DHT defines it, and the decoding tables that
// jdhuff.c's jpeg_make_d_derived_tbl derives from it when a scan uses it
// (so a bad table refuses only the scan that uses it, as in libjpeg).
struct HuffDec {
  bool set = false;
  uint8_t counts[16];
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoff[17];
  uint16_t look[1 << 9];  // (length << 8) | symbol, 0 = longer than 9 bits
};

void define_huff(HuffDec& h, const uint8_t* counts, const uint8_t* vals,
                 int nvals) {
  memcpy(h.counts, counts, 16);
  memset(h.vals, 0, sizeof(h.vals));
  memcpy(h.vals, vals, nvals);
  h.set = true;
}

// jpeg_make_d_derived_tbl: no code may be all ones, and a DC table's
// symbols are difference categories (0..15, or 0..16 when lossless)
void build_huff(HuffDec& h, bool dc, bool lossless) {
  memset(h.look, 0, sizeof(h.look));
  int32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    h.valoff[l] = k - code;
    const int cnt = h.counts[l - 1];
    for (int i = 0; i < cnt; ++i, ++code, ++k) {
      if (dc && h.vals[k] > (lossless ? 16 : 15))
        throw Error("bad JPEG Huffman table (DC symbol " +
                    std::to_string(h.vals[k]) + ")");
      if (l <= 9) {
        int base = code << (9 - l);
        for (int j = 0; j < (1 << (9 - l)); ++j)
          h.look[base + j] = uint16_t((l << 8) | h.vals[k]);
      }
    }
    if (cnt && code >= (1 << l)) throw Error("bad JPEG Huffman table");
    h.maxcode[l] = cnt ? code - 1 : -1;
    code <<= 1;
  }
  h.maxcode[17] = INT32_MAX;
}

// A read reached the end of the bytes PIL has handed libjpeg so far (its
// reads are 64 KiB): libjpeg suspends and redoes the MCU with more.
struct Suspend {};
// The stream ended where libjpeg needed more: PIL raises "image file is
// truncated" (unless the frame's one scan is already decoded)
struct EndOfData {};

const char* const kTruncated = "JPEG data ends early (truncated stream)";

// jdhuff.c's bit reader, fill for fill: the slow path's
// jpeg_fill_bit_buffer (to 57 bits; at a marker it stops and, when a
// request needs more bits than are left, feeds zeros and sets
// insufficient_data) and decode_mcu_fast's FILL_BIT_BUFFER_FAST (six
// bytes when 16 bits or fewer are left; at a marker the MCU is redone on
// the slow path). Which fills happen decides where a short stream runs
// dry, so both are kept exactly.
struct BitReader {
  const uint8_t* d;
  size_t p, end, n;  // next byte, end of the bytes handed over, stream end
  uint64_t acc = 0;  // nbits valid bits at the top
  int nbits = 0;
  int marker = 0;  // libjpeg's unread_marker, met by the reader
  bool insufficient = false;
  bool fast_marker = false;  // the fast path met a marker

  BitReader(const uint8_t* data, size_t pos, size_t end_, size_t len)
      : d(data), p(pos), end(end_), n(len) {}

  [[noreturn]] void dry() const {
    if (end >= n) throw Error(kTruncated);
    throw Suspend{};
  }
  void fill(int need) {
    if (!marker) {
      while (nbits < 57) {
        if (p >= end) dry();
        unsigned c = d[p++];
        if (c == 0xFF) {
          do {
            if (p >= end) dry();
            c = d[p++];
          } while (c == 0xFF);
          if (c != 0) {
            marker = int(c);
            break;
          }
          c = 0xFF;
        }
        acc |= uint64_t(c) << (56 - nbits);
        nbits += 8;
      }
      if (!marker) return;
    }
    if (need > nbits) {  // zeros below the valid bits already
      insufficient = true;
      nbits = 57;
    }
  }
  void fill_fast() {
    for (int i = 0; i < 6; ++i) {
      unsigned c0 = p < end ? d[p] : 0xFF;
      unsigned c1 = p + 1 < end ? d[p + 1] : 0xD9;
      if (c0 == 0xFF && c1 != 0) {
        fast_marker = true;
        c0 = 0;
      } else {
        p += c0 == 0xFF ? 2 : 1;
      }
      acc |= uint64_t(c0) << (56 - nbits);
      nbits += 8;
    }
  }
  inline unsigned peek(int k) const { return unsigned(acc >> (64 - k)); }
  inline void skip(int k) {
    acc <<= k;
    nbits -= k;
  }
  inline int get(int k) {
    int v = int(acc >> (64 - k));
    skip(k);
    return v;
  }
  // the slow path: CHECK_BIT_BUFFER then GET_BITS
  inline int bits(int k) {
    if (nbits < k) fill(k);
    return get(k);
  }
  // jpeg_huff_decode from a code of l bits; 17 bits and symbol 0 when no
  // code of 16 bits or fewer matches (JWRN_HUFF_BAD_CODE)
  int decode_from(const HuffDec& h, int l) {
    int32_t code = bits(l);
    while (code > h.maxcode[l]) {
      code = (code << 1) | bits(1);
      ++l;
    }
    return l > 16 ? 0 : h.vals[(h.valoff[l] + code) & 0xFF];
  }
  // HUFF_DECODE: an 8-bit lookahead once the buffer holds 8 bits
  inline int decode(const HuffDec& h) {
    if (nbits < 8) {
      fill(0);
      if (nbits < 8) return decode_from(h, 1);
    }
    uint16_t e = h.look[peek(9)];
    if (e && (e >> 8) <= 8) {
      skip(e >> 8);
      return e & 0xFF;
    }
    return decode_from(h, 9);
  }
  // the fast path: HUFF_DECODE_FAST and its GET_BITS
  inline int bits_fast(int k) {
    if (nbits <= 16) fill_fast();
    return get(k);
  }
  inline int decode_fast(const HuffDec& h) {
    if (nbits <= 16) fill_fast();
    uint16_t e = h.look[peek(9)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    for (int l = 10; l <= 16; ++l) {
      int32_t code = int32_t(peek(l));
      if (code <= h.maxcode[l]) {
        skip(l);
        return h.vals[(h.valoff[l] + code) & 0xFF];
      }
    }
    skip(17);
    return 0;
  }
};

inline int extend(int v, int t) {
  return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

// jaricom.c: T.81 Table D.2 packed as (Qe << 16) | (Next_Index_MPS << 8) |
// (Switch_MPS << 7) | Next_Index_LPS; entry 113 is the fixed 0.5 state
#define ARI(qe, nlps, nmps, sw) \
  ((int32_t(qe) << 16) | (int32_t(nmps) << 8) | (int32_t(sw) << 7) | (nlps))
const int32_t kAritab[114] = {
    ARI(0x5a1d, 1, 1, 1),     ARI(0x2586, 14, 2, 0),
    ARI(0x1114, 16, 3, 0),    ARI(0x080b, 18, 4, 0),
    ARI(0x03d8, 20, 5, 0),    ARI(0x01da, 23, 6, 0),
    ARI(0x00e5, 25, 7, 0),    ARI(0x006f, 28, 8, 0),
    ARI(0x0036, 30, 9, 0),    ARI(0x001a, 33, 10, 0),
    ARI(0x000d, 35, 11, 0),   ARI(0x0006, 9, 12, 0),
    ARI(0x0003, 10, 13, 0),   ARI(0x0001, 12, 13, 0),
    ARI(0x5a7f, 15, 15, 1),   ARI(0x3f25, 36, 16, 0),
    ARI(0x2cf2, 38, 17, 0),   ARI(0x207c, 39, 18, 0),
    ARI(0x17b9, 40, 19, 0),   ARI(0x1182, 42, 20, 0),
    ARI(0x0cef, 43, 21, 0),   ARI(0x09a1, 45, 22, 0),
    ARI(0x072f, 46, 23, 0),   ARI(0x055c, 48, 24, 0),
    ARI(0x0406, 49, 25, 0),   ARI(0x0303, 51, 26, 0),
    ARI(0x0240, 52, 27, 0),   ARI(0x01b1, 54, 28, 0),
    ARI(0x0144, 56, 29, 0),   ARI(0x00f5, 57, 30, 0),
    ARI(0x00b7, 59, 31, 0),   ARI(0x008a, 60, 32, 0),
    ARI(0x0068, 62, 33, 0),   ARI(0x004e, 63, 34, 0),
    ARI(0x003b, 32, 35, 0),   ARI(0x002c, 33, 9, 0),
    ARI(0x5ae1, 37, 37, 1),   ARI(0x484c, 64, 38, 0),
    ARI(0x3a0d, 65, 39, 0),   ARI(0x2ef1, 67, 40, 0),
    ARI(0x261f, 68, 41, 0),   ARI(0x1f33, 69, 42, 0),
    ARI(0x19a8, 70, 43, 0),   ARI(0x1518, 72, 44, 0),
    ARI(0x1177, 73, 45, 0),   ARI(0x0e74, 74, 46, 0),
    ARI(0x0bfb, 75, 47, 0),   ARI(0x09f8, 77, 48, 0),
    ARI(0x0861, 78, 49, 0),   ARI(0x0706, 79, 50, 0),
    ARI(0x05cd, 48, 51, 0),   ARI(0x04de, 50, 52, 0),
    ARI(0x040f, 50, 53, 0),   ARI(0x0363, 51, 54, 0),
    ARI(0x02d4, 52, 55, 0),   ARI(0x025c, 53, 56, 0),
    ARI(0x01f8, 54, 57, 0),   ARI(0x01a4, 55, 58, 0),
    ARI(0x0160, 56, 59, 0),   ARI(0x0125, 57, 60, 0),
    ARI(0x00f6, 58, 61, 0),   ARI(0x00cb, 59, 62, 0),
    ARI(0x00ab, 61, 63, 0),   ARI(0x008f, 61, 32, 0),
    ARI(0x5b12, 65, 65, 1),   ARI(0x4d04, 80, 66, 0),
    ARI(0x412c, 81, 67, 0),   ARI(0x37d8, 82, 68, 0),
    ARI(0x2fe8, 83, 69, 0),   ARI(0x293c, 84, 70, 0),
    ARI(0x2379, 86, 71, 0),   ARI(0x1edf, 87, 72, 0),
    ARI(0x1aa9, 87, 73, 0),   ARI(0x174e, 72, 74, 0),
    ARI(0x1424, 72, 75, 0),   ARI(0x119c, 74, 76, 0),
    ARI(0x0f6b, 74, 77, 0),   ARI(0x0d51, 75, 78, 0),
    ARI(0x0bb6, 77, 79, 0),   ARI(0x0a40, 77, 48, 0),
    ARI(0x5832, 80, 81, 1),   ARI(0x4d1c, 88, 82, 0),
    ARI(0x438e, 89, 83, 0),   ARI(0x3bdd, 90, 84, 0),
    ARI(0x34ee, 91, 85, 0),   ARI(0x2eae, 92, 86, 0),
    ARI(0x299a, 93, 87, 0),   ARI(0x2516, 86, 71, 0),
    ARI(0x5570, 88, 89, 1),   ARI(0x4ca9, 95, 90, 0),
    ARI(0x44d9, 96, 91, 0),   ARI(0x3e22, 97, 92, 0),
    ARI(0x3824, 99, 93, 0),   ARI(0x32b4, 99, 94, 0),
    ARI(0x2e17, 93, 86, 0),   ARI(0x56a8, 95, 96, 1),
    ARI(0x4f46, 101, 97, 0),  ARI(0x47e5, 102, 98, 0),
    ARI(0x41cf, 103, 99, 0),  ARI(0x3c3d, 104, 100, 0),
    ARI(0x375e, 99, 93, 0),   ARI(0x5231, 105, 102, 0),
    ARI(0x4c0f, 106, 103, 0), ARI(0x4639, 107, 104, 0),
    ARI(0x415e, 103, 99, 0),  ARI(0x5627, 105, 106, 1),
    ARI(0x50e7, 108, 107, 0), ARI(0x4b85, 109, 103, 0),
    ARI(0x5597, 110, 109, 0), ARI(0x504f, 111, 107, 0),
    ARI(0x5a10, 110, 111, 1), ARI(0x5522, 112, 109, 0),
    ARI(0x59eb, 112, 111, 1), ARI(0x5a1d, 113, 113, 0)};
#undef ARI

// jdarith.c's decoder: C holds the interval base and the input bits, CT
// counts the bits left (-1 after a bad code: the rest of the restart
// interval decodes as zero blocks), A the interval size; a marker feeds
// zeros. libjpeg cannot suspend it, and PIL hands libjpeg a stream in
// 64 KiB reads, so PIL refuses a scan that reads a byte at or past
// `limit`: the end of the reads that held its header, or of the stream
struct ArithReader {
  const uint8_t* base;  // the stream's first byte
  const uint8_t* p;
  const uint8_t* limit;
  const uint8_t* end;  // the stream's end
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: two bytes to read before the first decision
  int marker = 0;  // libjpeg's unread_marker, met by the decoder

  void reset() {
    c = 0;
    a = 0;
    ct = -16;
  }
  void reach(const uint8_t* q) const {
    if (q < limit) return;
    if (limit >= end) throw Error(kTruncated);
    throw Error("unsupported JPEG arithmetic-coded scan: it reads byte " +
                std::to_string(q - base) + ", past the 64 KiB read that "
                "holds its header (libjpeg cannot suspend an arithmetic "
                "decoder there, so PIL refuses it)");
  }
  int byte() {
    if (marker) return 0;
    reach(p);
    int v = *p++;
    if (v != 0xFF) return v;
    do {  // fill bytes
      reach(p);
      v = *p++;
    } while (v == 0xFF);
    if (v == 0) return 0xFF;  // stuffed zero
    marker = v;
    return 0;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // got the two initial bytes
      }
      a <<= 1;
    }
    int sv = *st;
    int32_t qe = kAritab[sv & 0x7F];
    int nl = qe & 0xFF;
    qe >>= 8;
    int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional LPS exchange
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {  // conditional MPS exchange
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct Comp {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int pred = 0;
  int dc_ctx = 0;  // arithmetic DC conditioning category
  int dw, dh;      // downsampled width and height (real samples)
  int bw, bh;      // blocks allocated (MCU-padded)
  std::vector<int16_t> coef;
  uint16_t q[64];
  bool latched = false;
  bool scanned = false;
  // progressive: each coefficient's last Al, -1 until a scan sends it
  // (libjpeg's coef_bits; a complete stream smooths with the final ones)
  int coef_bits[64];
  // the same before the component's latest scan (libjpeg's second half of
  // coef_bits); smoothing uses them for the iMCU rows past the last one
  // that the final scan decoded with data
  int prev_coef_bits[64];
  std::vector<uint8_t> plane;  // IDCT (or lossless) output, stride pw
  int pw = 0;
};

const char* sof_name(int m) {
  switch (m) {
    case 0xC5: return "SOF5 (differential sequential)";
    case 0xC6: return "SOF6 (differential progressive)";
    case 0xC7: return "SOF7 (differential lossless)";
    case 0xC8: return "JPG (reserved SOF)";
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
  uint8_t dc_L[16], dc_U[16], ac_K[16];  // arithmetic conditioning (DAC)
  int restart = 0;
  int W = 0, H = 0, nc = 0;
  Comp comp[4];
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool progressive = false, arith = false, lossless = false;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  bool have_frame = false, have_scan = false;
  int scans = 0;             // SOS markers read (input_scan_number)
  bool multi_scan = false;   // has_multiple_scans, set by the first scan
  bool single_done = false;  // the frame's one scan is decoded
  int unread_marker = 0;     // a marker the entropy decoder stopped at
  int next_rst = 0;          // the RSTn due next
  int last_good_row = 0;     // last_good_iMCU_row
  // the current scan
  Comp* sc[4];
  int ns = 0, Ss = 0, Se = 63, Ah = 0, Al = 0;
  int eobrun = 0;
  std::vector<uint8_t> dc_stats, ac_stats;  // 16 x 64 and 16 x 256 bins
  uint8_t fixed_bin = 113;

  Decoder(const uint8_t* data, size_t len) : d(data), n(len) {
    memset(dc_L, 0, sizeof(dc_L));
    memset(dc_U, 1, sizeof(dc_U));
    memset(ac_K, 5, sizeof(ac_K));
  }

  int u8() {
    if (pos >= n) throw EndOfData{};
    return d[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // jdmarker.c next_marker from p: stray bytes and FF00 pairs are skipped,
  // then fill bytes; more(q) runs before byte q is read
  template <class More>
  int next_marker_from(size_t& p, More&& more) {
    for (;;) {
      more(p);
      int c = d[p++];
      while (c != 0xFF) {
        more(p);
        c = d[p++];
      }
      do {
        more(p);
        c = d[p++];
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  // jdmarker.c read_restart_marker and jpeg_resync_to_restart: take the
  // marker the entropy decoder met (or the next one); when it is not the
  // RSTn due, skip markers below SOF0 and RSTns just passed, stop (and
  // decode empty segments) at any other marker or at one of the next two
  // RSTns, and resume at any other RSTn
  template <class More>
  void read_restart_marker(int& marker, size_t& p, More&& more) {
    if (!marker) marker = next_marker_from(p, more);
    const int want = next_rst;
    while (marker != 0xD0 + want) {
      int action;
      if (marker < 0xC0)
        action = 2;
      else if (marker < 0xD0 || marker > 0xD7)
        action = 3;
      else if (marker == 0xD0 + ((want + 1) & 7) ||
               marker == 0xD0 + ((want + 2) & 7))
        action = 3;
      else if (marker == 0xD0 + ((want - 1) & 7) ||
               marker == 0xD0 + ((want - 2) & 7))
        action = 2;
      else
        action = 1;
      if (action == 1) break;
      if (action == 3) {
        next_rst = (next_rst + 1) & 7;
        return;
      }
      marker = next_marker_from(p, more);
    }
    marker = 0;
    next_rst = (next_rst + 1) & 7;
  }

  // The markers up to EOI, decoding each scan. Where the stream ends
  // before EOI, PIL raises, unless the frame has one scan and it is
  // decoded: libjpeg's jpeg_finish_decompress then suspends past the last
  // row, which PIL accepts.
  void parse(bool header_only) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8)
      throw Error("not a JPEG stream (no SOI marker)");
    pos = 2;
    auto more = [&](size_t q) {
      if (q >= n) throw EndOfData{};
    };
    try {
      for (;;) {
        int m = unread_marker;
        unread_marker = 0;
        if (!m) m = next_marker_from(pos, more);
        if (m == 0xD9) break;
        if (m >= 0xD0 && m <= 0xD7) continue;  // stray RSTn
        if (m == 0x01) continue;              // TEM
        // read_markers refuses these before reading a length
        const bool sof = m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 ||
                         m == 0xC9 || m == 0xCA;
        if (sof && have_frame)
          throw Error("JPEG stream has two frame headers");
        if (m >= 0xC5 && m <= 0xCF && m != 0xCC && !sof)
          throw Error(std::string("unsupported JPEG process: ") + sof_name(m));
        if (!sof && m != 0xC4 && m != 0xCC && m != 0xDA && m != 0xDB &&
            m != 0xDC && m != 0xDD && !(m >= 0xE0 && m <= 0xEF) &&
            m != 0xFE) {
          // SOI again, DHP, EXP, JPGn, RESn and codes below SOF0
          char buf[64];
          snprintf(buf, sizeof(buf), "unsupported JPEG marker 0x%02X", m);
          throw Error(buf);
        }
        // a segment is read byte by byte: a refusal inside it stands even
        // where the stream ends later
        size_t start = pos;
        int len = u16();
        if (len < 2) throw Error("bad JPEG marker length");
        size_t seg_end = start + len;
        if (sof) {
          read_sof(m);
          if (header_only) return;
        } else if (m == 0xCC) {
          read_dac(seg_end);
        } else if (m == 0xC4) {
          read_dht(seg_end);
        } else if (m == 0xDB) {
          read_dqt(seg_end);
        } else if (m == 0xDD) {
          restart = u16();
        } else if (m == 0xDA) {
          if (!have_frame) throw Error("JPEG scan before its frame header");
          read_sos_and_decode(seg_end);
          if (!multi_scan) single_done = true;
          continue;  // pos is past the entropy-coded data
        } else if (m == 0xE0 || m == 0xEE) {
          // get_interesting_appn reads up to 14 bytes, then examine_app0
          // ("JFIF\0" in at least 14) or examine_app14 ("Adobe" in 12)
          if (pos + std::min(len - 2, 14) > n) throw EndOfData{};
          if (m == 0xE0 && len - 2 >= 14 && memcmp(d + pos, "JFIF\0", 5) == 0)
            jfif = true;
          if (m == 0xEE && len - 2 >= 12 && memcmp(d + pos, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = d[pos + 11];
          }
        }  // APPn, COM and DNL (which libjpeg skips) are skipped
        if (seg_end > n) throw EndOfData{};
        pos = seg_end;
      }
    } catch (const EndOfData&) {
      if (header_only || !single_done) throw Error(kTruncated);
    }
    if (!have_frame) throw Error("JPEG stream has no frame header");
    if (!header_only && !have_scan) throw Error("JPEG stream has no scan");
  }

  void read_sof(int m) {
    if (have_frame) throw Error("JPEG stream has two frame headers");
    progressive = m == 0xC2 || m == 0xCA;
    arith = m == 0xC9 || m == 0xCA;
    lossless = m == 0xC3;
    int prec = u8();
    H = u16();
    W = u16();
    nc = u8();
    if (prec != 8)
      throw Error("unsupported JPEG sample precision " +
                  std::to_string(prec) + " (" + std::to_string(prec) +
                  "-bit)");
    if (H == 0) throw Error("unsupported JPEG height 0 (DNL)");
    if (W == 0) throw Error("bad JPEG width 0");
    if (H > 65500 || W > 65500) throw Error("JPEG image larger than 65500");
    if (nc != 1 && nc != 3 && nc != 4)
      throw Error("unsupported JPEG with " + std::to_string(nc) +
                  " components");
    for (int i = 0; i < nc; ++i) {
      Comp& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        throw Error("bad JPEG sampling factors " + std::to_string(c.h) +
                    "x" + std::to_string(c.v));
      if (c.tq > 3) throw Error("bad JPEG quantization table index");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    // jdsample.c: each component's ratio to the largest factors must be
    // an integer
    for (int i = 0; i < nc; ++i)
      if (hmax % comp[i].h || vmax % comp[i].v)
        throw Error(
            "unsupported JPEG sampling factors: fractional sampling (" +
            std::to_string(comp[i].h) + "x" + std::to_string(comp[i].v) +
            " against " + std::to_string(hmax) + "x" + std::to_string(vmax) +
            ")");
    const int unit = lossless ? 1 : 8;  // samples per block side
    mcux = (W + unit * hmax - 1) / (unit * hmax);
    mcuy = (H + unit * vmax - 1) / (unit * vmax);
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
      if (pos + total > n) throw EndOfData{};
      define_huff(tc ? ac[th] : dc[th], counts, d + pos, total);
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

  void read_dac(size_t seg_end) {  // jdmarker.c get_dac
    while (pos + 1 < seg_end) {
      int index = u8(), val = u8();
      if (index >= 32) throw Error("bad JPEG DAC table index");
      if (index >= 16) {
        ac_K[index - 16] = uint8_t(val);
      } else {
        dc_L[index] = uint8_t(val & 15);
        dc_U[index] = uint8_t(val >> 4);
        if (dc_L[index] > dc_U[index]) throw Error("bad JPEG DAC value");
      }
    }
    if (pos != seg_end) throw Error("bad JPEG DAC segment");
  }

  void read_sos_and_decode(size_t seg_end) {
    ns = u8();
    if (ns < 1 || ns > 4 || ns > nc || seg_end - pos != size_t(2 * ns + 3))
      throw Error("bad JPEG scan header");
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      Comp* c = nullptr;
      for (int j = 0; j < nc; ++j)
        if (comp[j].id == id) c = &comp[j];
      if (!c) throw Error("JPEG scan names an unknown component");
      for (int j = 0; j < i; ++j)
        if (sc[j] == c) throw Error("JPEG scan names a component twice");
      c->td = t >> 4;
      c->ta = t & 15;
      sc[i] = c;
    }
    Ss = u8();
    Se = u8();
    int a = u8();
    Ah = a >> 4;
    Al = a & 15;
    pos = seg_end;
    // jdinput.c consume_markers: JERR_EOI_EXPECTED
    if (single_done)
      throw Error("JPEG stream has a second scan after a scan of every "
                  "component");
    have_scan = true;
    next_rst = 0;
    if (++scans == 1) multi_scan = ns < nc || progressive;
    if (ns > 1) {  // jdinput.c: an interleaved MCU holds at most 10 blocks
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10)
        throw Error("JPEG sampling factors too large for an interleaved "
                    "scan (" + std::to_string(blocks) + " blocks in an MCU)");
    }
    if (!arith && !progressive && !lossless) {
      // jinit_huff_decoder's std_huff_tables fill empty slots 0 and 1 (the
      // progressive and lossless decoders have no such default)
      if (!dc[0].set) define_huff(dc[0], kDcLumaBits, kDcVals, 12);
      if (!dc[1].set) define_huff(dc[1], kDcChromaBits, kDcVals, 12);
      if (!ac[0].set) define_huff(ac[0], kAcLumaBits, kAcLumaVals, 162);
      if (!ac[1].set) define_huff(ac[1], kAcChromaBits, kAcChromaVals, 162);
    }
    if (lossless) {
      decode_lossless_scan();
      return;
    }
    for (int i = 0; i < ns; ++i) {
      Comp& c = *sc[i];
      if (!c.latched) {
        if (!qt_set[c.tq])
          throw Error("JPEG component uses an undefined quantization table");
        memcpy(c.q, qt[c.tq], sizeof(c.q));
        c.latched = true;
      }
      if (c.coef.empty()) c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
      c.scanned = true;
    }
    if (progressive) start_progressive_scan();
    if (arith) {  // 16 conditioning slots: any 4-bit index is one
      decode_arith_scan();
      return;
    }
    const bool need_dc = !progressive || (Ss == 0 && Ah == 0);
    const bool need_ac = !progressive || Ss > 0;
    for (int i = 0; i < ns; ++i) {
      const Comp& c = *sc[i];
      if ((need_dc && (c.td > 3 || !dc[c.td].set)) ||
          (need_ac && (c.ta > 3 || !ac[c.ta].set)))
        throw Error("JPEG scan uses an undefined Huffman table");
    }
    for (int i = 0; i < ns; ++i) {
      if (need_dc) build_huff(dc[sc[i]->td], true, false);
      if (need_ac) build_huff(ac[sc[i]->ta], false, false);
    }
    decode_huffman_scan();
  }

  // jdphuff.c start_pass_phuff_decoder (jdarith.c's is the same): the
  // checks of Ss, Se, Ah, Al and the progression status of each
  // coefficient, the previous status kept for smoothing
  void start_progressive_scan() {
    bool bad = false;
    if (Ss == 0) {
      if (Se != 0) bad = true;
    } else {
      if (Ss > Se || Se > 63) bad = true;
      if (ns != 1) bad = true;
    }
    if (Ah != 0 && Al != Ah - 1) bad = true;
    if (Al > 13) bad = true;
    if (bad)
      throw Error("bad JPEG progression parameters Ss=" +
                  std::to_string(Ss) + " Se=" + std::to_string(Se) +
                  " Ah=" + std::to_string(Ah) + " Al=" + std::to_string(Al));
    for (int i = 0; i < ns; ++i) {
      Comp& c = *sc[i];
      for (int k = std::min(Ss, 1); k <= std::max(Se, 9); ++k)
        c.prev_coef_bits[k] = scans > 1 ? c.coef_bits[k] : 0;
      std::fill(c.coef_bits + Ss, c.coef_bits + Se + 1, Al);
    }
  }

  // the blocks of one MCU in stream order, and its iMCU row
  struct MCU {
    Comp* c[10];
    int16_t* b[10];
    int n = 0;
    int row = 0;
  };

  // Calls f(mcu) for every MCU of the scan in stream order.
  template <class F>
  void for_each_mcu(F&& f) {
    MCU m;
    if (ns == 1) {
      Comp& c = *sc[0];
      int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
      m.n = 1;
      m.c[0] = &c;
      for (int by = 0; by < nby; ++by) {
        m.row = by / c.v;
        for (int bx = 0; bx < nbx; ++bx) {
          m.b[0] = &c.coef[(size_t(by) * c.bw + bx) * 64];
          f(m);
        }
      }
      return;
    }
    for (int my = 0; my < mcuy; ++my) {
      m.row = my;
      for (int mx = 0; mx < mcux; ++mx) {
        m.n = 0;
        for (int i = 0; i < ns; ++i) {
          Comp& c = *sc[i];
          for (int yy = 0; yy < c.v; ++yy)
            for (int xx = 0; xx < c.h; ++xx) {
              size_t by = size_t(my) * c.v + yy, bx = size_t(mx) * c.h + xx;
              m.c[m.n] = &c;
              m.b[m.n++] = &c.coef[(by * c.bw + bx) * 64];
            }
        }
        f(m);
      }
    }
  }

  // Huffman scans, MCU by MCU as jdhuff.c / jdphuff.c decode_mcu: a
  // restart first (process_restart: the bit buffer dropped, the marker
  // read or resynced to, the predictions and the EOB run reset, and
  // insufficient_data cleared unless a marker is still pending); an MCU
  // met after the data ran out at a marker is left as it is (zero blocks
  // in a first scan). A sequential MCU takes libjpeg-turbo's fast path
  // where no restart interval is set, no marker is pending and PIL's read
  // holds 512 bytes a block; a fast MCU that meets a marker is redone on
  // the slow path over what it wrote, and an MCU that runs past PIL's read
  // is redone with the next read (zeroed first in a one-scan frame).
  void decode_huffman_scan() {
    const size_t end0 =
        progressive ? n : std::min((pos + 65535) / 65536 * 65536, n);
    BitReader br(d, pos, end0, n);
    for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
    eobrun = 0;
    int togo = restart;
    auto more = [&](size_t q) {
      if (q >= n) throw Error(kTruncated);
      if (q >= br.end) br.end = std::min(br.end + 65536, n);
    };
    auto at_restart = [&]() {
      br.acc = 0;
      br.nbits = 0;
      read_restart_marker(br.marker, br.p, more);
      if (!br.marker) br.insufficient = false;
      for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
      eobrun = 0;
      togo = restart;
    };
    if (!progressive) {
      const size_t fast_bytes = size_t(512) * (ns == 1 ? 1 : blocks_in_mcu());
      int preds[4];
      for_each_mcu([&](MCU& m) {
        if (restart && togo == 0) at_restart();
        if (!br.insufficient) {
          BitReader keep = br;
          for (int i = 0; i < ns; ++i) preds[i] = sc[i]->pred;
          for (;;) {
            try {
              if (!restart && !br.marker && br.end - br.p >= fast_bytes) {
                for (int j = 0; j < m.n; ++j)
                  decode_block<true>(br, *m.c[j], m.b[j]);
                if (!br.fast_marker) break;
                br = keep;
                for (int i = 0; i < ns; ++i) sc[i]->pred = preds[i];
              }
              for (int j = 0; j < m.n; ++j)
                decode_block<false>(br, *m.c[j], m.b[j]);
              break;
            } catch (const Suspend&) {
              keep.end = std::min(keep.end + 65536, n);
              br = keep;
              for (int i = 0; i < ns; ++i) sc[i]->pred = preds[i];
              if (!multi_scan)
                for (int j = 0; j < m.n; ++j) memset(m.b[j], 0, 128);
            }
          }
        }
        if (restart) --togo;
      });
    } else {
      const int p1 = 1 << Al;
      for_each_mcu([&](MCU& m) {
        if (!br.insufficient) last_good_row = m.row;
        if (restart && togo == 0) at_restart();
        if (!br.insufficient) {
          for (int j = 0; j < m.n; ++j) {
            Comp& c = *m.c[j];
            int16_t* b = m.b[j];
            if (Ss == 0 && Ah == 0)
              dc_first(br, c, b);
            else if (Ss == 0) {
              if (br.bits(1)) b[0] = int16_t(b[0] | p1);
            } else if (Ah == 0)
              ac_first(br, c, b);
            else
              ac_refine(br, c, b);
          }
        }
        if (restart) --togo;
      });
    }
    pos = br.p;
    unread_marker = br.marker;
  }

  int blocks_in_mcu() const {
    int blocks = 0;
    for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
    return blocks;
  }

  // jdhuff.c decode_mcu_fast / decode_mcu_slow, one block
  template <bool Fast>
  inline void decode_block(BitReader& br, Comp& c, int16_t* blk) {
    const HuffDec& hd = dc[c.td];
    const HuffDec& ha = ac[c.ta];
    int s = Fast ? br.decode_fast(hd) : br.decode(hd);
    if (s) s = extend(Fast ? br.bits_fast(s) : br.bits(s), s);
    c.pred = int(unsigned(c.pred) + unsigned(s));  // wraps, as JCOEF does
    blk[0] = int16_t(c.pred);
    for (int k = 1; k < 64; ++k) {
      int rs = Fast ? br.decode_fast(ha) : br.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        int v = Fast ? br.bits_fast(s) : br.bits(s);
        blk[kNatural[k]] = int16_t(extend(v, s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // jdphuff.c decode_mcu_DC_first, one block
  void dc_first(BitReader& br, Comp& c, int16_t* blk) {
    int s = br.decode(dc[c.td]);
    if (s) s = extend(br.bits(s), s);
    c.pred = int(unsigned(c.pred) + unsigned(s));
    blk[0] = int16_t(unsigned(c.pred) << Al);
  }

  // decode_mcu_AC_first: one band of one block, or one block of an EOB run
  void ac_first(BitReader& br, Comp& c, int16_t* blk) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const HuffDec& ha = ac[c.ta];
    for (int k = Ss; k <= Se; ++k) {
      int rs = br.decode(ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int v = extend(br.bits(s), s);
        blk[kNatural[k]] = int16_t(unsigned(v) << Al);
      } else if (r == 15) {
        k += 15;  // ZRL
      } else {    // EOBr: 2^r + r appended bits blocks end here
        eobrun = 1 << r;
        if (r) eobrun += br.bits(r);
        --eobrun;
        break;
      }
    }
  }

  // decode_mcu_AC_refine: one more bit of the band's nonzero coefficients,
  // and the coefficients that become nonzero (+-1 << Al)
  void ac_refine(BitReader& br, Comp& c, int16_t* blk) {
    const int p1 = 1 << Al, m1 = -p1;
    const HuffDec& ha = ac[c.ta];
    auto correct = [&](int16_t* t) {
      if (br.bits(1) && (*t & p1) == 0)
        *t = int16_t(*t >= 0 ? *t + p1 : *t + m1);
    };
    int k = Ss;
    if (eobrun == 0) {
      for (; k <= Se; ++k) {
        int rs = br.decode(ha);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        // pass over nonzero coefficients (correcting them) and r zeros
        do {
          int16_t* t = blk + kNatural[k];
          if (*t != 0) {
            correct(t);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= Se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; ++k) {
        int16_t* t = blk + kNatural[k];
        if (*t != 0) correct(t);
      }
      --eobrun;
    }
  }

  // ----------------------------------------------- arithmetic (jdarith.c)
  void decode_arith_scan() {
    // PIL's reads are 65536 bytes from the stream's start
    const size_t reads_end = (pos + 65535) / 65536 * 65536;
    ArithReader ar{d, d + pos, d + std::min(reads_end, n), d + n};
    dc_stats.resize(16 * 64);
    ac_stats.resize(16 * 256);
    const bool need_dc = !progressive || (Ss == 0 && Ah == 0);
    const bool need_ac = !progressive || Ss > 0;
    auto reset_stats = [&]() {
      for (int i = 0; i < ns; ++i) {
        Comp& c = *sc[i];
        if (need_dc) {
          memset(&dc_stats[c.td * 64], 0, 64);
          c.pred = 0;
          c.dc_ctx = 0;
        }
        if (need_ac) memset(&ac_stats[c.ta * 256], 0, 256);
      }
    };
    reset_stats();
    int togo = restart;
    auto more = [&](size_t q) { ar.reach(d + q); };
    const int p1 = 1 << Al;
    // decode_mcu of each kind: a restart first; after a bad code (ct = -1)
    // the rest of the restart interval is left as it is
    for_each_mcu([&](MCU& m) {
      last_good_row = m.row;  // jdarith.c never sets insufficient_data
      if (restart) {
        if (togo == 0) {
          size_t p = size_t(ar.p - d);
          read_restart_marker(ar.marker, p, more);
          ar.p = d + p;
          reset_stats();
          ar.reset();
          togo = restart;
        }
        --togo;
      }
      for (int j = 0; j < m.n && ar.ct != -1; ++j) {
        Comp& c = *m.c[j];
        int16_t* b = m.b[j];
        if (!progressive) {
          if (arith_dc(ar, c, b, 0)) arith_ac(ar, c, b, 1, 63, 0);
        } else if (Ss == 0 && Ah == 0) {
          arith_dc(ar, c, b, Al);
        } else if (Ss == 0) {
          if (ar.decode(&fixed_bin)) b[0] = int16_t(b[0] | p1);
        } else if (Ah == 0) {
          arith_ac(ar, c, b, Ss, Se, Al);
        } else {
          arith_ac_refine(ar, c, b);
        }
      }
    });
    pos = size_t(ar.p - d);
    unread_marker = ar.marker;
  }

  // Figures F.19 to F.24: one DC difference, the block's DC written as the
  // new prediction (16 bits, as libjpeg keeps it) << al; false after a
  // magnitude overflow (JWRN_ARITH_BAD_CODE: ct = -1, the DC unwritten)
  bool arith_dc(ArithReader& ar, Comp& c, int16_t* blk, int al) {
    uint8_t* stats = &dc_stats[c.td * 64];
    uint8_t* st = stats + c.dc_ctx;
    if (ar.decode(st) == 0) {
      c.dc_ctx = 0;
    } else {
      int sign = ar.decode(st + 1);
      st += 2 + sign;
      int m = ar.decode(st);
      if (m) {
        st = stats + 20;
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;
            return false;
          }
          ++st;
        }
      }
      if (m < int((1L << dc_L[c.td]) >> 1))
        c.dc_ctx = 0;
      else if (m > int((1L << dc_U[c.td]) >> 1))
        c.dc_ctx = 12 + sign * 4;
      else
        c.dc_ctx = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      c.pred = (c.pred + v) & 0xFFFF;
    }
    blk[0] = int16_t(unsigned(c.pred) << al);
    return true;
  }

  // Figure F.20: the AC coefficients k0..k1 of a block, scaled by << al; a
  // run past k1 or a magnitude overflow sets ct = -1 and stops
  void arith_ac(ArithReader& ar, Comp& c, int16_t* blk, int k0, int k1,
                int al) {
    uint8_t* stats = &ac_stats[c.ta * 256];
    for (int k = k0; k <= k1; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > k1) {
          ar.ct = -1;
          return;
        }
      }
      int sign = ar.decode(&fixed_bin);
      st += 2;
      int m = ar.decode(st);
      if (m && ar.decode(st)) {
        m <<= 1;
        st = stats + (k <= ac_K[c.ta] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;
            return;
          }
          ++st;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = int16_t(unsigned(v) << al);
    }
  }

  // decode_mcu_AC_refine of jdarith.c
  void arith_ac_refine(ArithReader& ar, Comp& c, int16_t* blk) {
    uint8_t* stats = &ac_stats[c.ta * 256];
    const int p1 = 1 << Al, m1 = -p1;
    int kex = Se;  // the previous stage's end of block
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = Ss; k <= Se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;  // EOB
      for (;;) {
        int16_t* t = blk + kNatural[k];
        if (*t) {  // previously nonzero
          if (ar.decode(st + 2)) *t = int16_t(*t < 0 ? *t + m1 : *t + p1);
          break;
        }
        if (ar.decode(st + 1)) {  // newly nonzero
          *t = int16_t(ar.decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > Se) {
          ar.ct = -1;
          return;
        }
      }
    }
  }

  // ------------------------------------- lossless (jdlhuff.c, jdlossls.c)
  void decode_lossless_scan() {
    // jdlossls.c: Ss is the predictor, Al the point transform
    if (Ss < 1 || Ss > 7 || Se != 0 || Ah != 0 || Al >= 8)
      throw Error("bad JPEG lossless parameters Ss=" + std::to_string(Ss) +
                  " Se=" + std::to_string(Se) + " Ah=" + std::to_string(Ah) +
                  " Al=" + std::to_string(Al));
    for (int i = 0; i < ns; ++i) {
      Comp& c = *sc[i];
      if (c.td > 3 || !dc[c.td].set)
        throw Error("JPEG scan uses an undefined Huffman table");
    }
    for (int i = 0; i < ns; ++i) {
      Comp& c = *sc[i];
      build_huff(dc[c.td], true, true);
      c.pw = c.bw;
      if (c.plane.empty()) c.plane.assign(size_t(c.bw) * c.bh, 0);
      c.scanned = true;
    }
    const int per_row = ns > 1 ? mcux : sc[0]->dw;  // MCUs in an MCU row
    if (restart % per_row)
      throw Error("bad JPEG restart interval " + std::to_string(restart) +
                  " for a lossless scan of " + std::to_string(per_row) +
                  " MCUs a row");
    // differences, then the undifferenced rows of the current iMCU row
    std::vector<int> diff[4], undiff[4];
    for (int i = 0; i < ns; ++i) {
      diff[i].assign(size_t(sc[i]->bw) * sc[i]->v, 0);
      undiff[i].assign(size_t(sc[i]->bw) * (sc[i]->v + 1), 0);
    }
    BitReader br(d, pos, n, n);
    auto more = [&](size_t q) {
      if (q >= n) throw Error(kTruncated);
    };
    bool first_row = true;
    int rows_to_go = restart / per_row;
    auto diff_of = [&](const HuffDec& h) {
      int s = br.decode(h);
      if (s == 16) return 32768;
      return s ? extend(br.bits(s), s) : 0;
    };
    const int initial = 1 << (8 - Al - 1);
    for (int r = 0; r < mcuy; ++r) {
      // an iMCU row: one MCU row of an interleaved scan, v sample rows of
      // a one-component scan
      int mcu_rows = 1;
      if (ns == 1) {
        int v = sc[0]->v, left = sc[0]->dh - r * v;
        mcu_rows = std::min(v, left);
        if (mcu_rows <= 0) break;
      }
      for (int yo = 0; yo < mcu_rows; ++yo) {
        // jddiffct.c: a restart, or a row met after the data ran out at a
        // marker (zero differences), restarts the undifferencing
        if (restart) {
          if (rows_to_go == 0) {
            br.acc = 0;
            br.nbits = 0;
            read_restart_marker(br.marker, br.p, more);
            if (!br.marker) br.insufficient = false;
            first_row = true;
            rows_to_go = restart / per_row;
          }
          --rows_to_go;
        }
        if (br.insufficient) {
          first_row = true;
          if (ns == 1)
            std::fill_n(&diff[0][size_t(yo) * sc[0]->bw], per_row, 0);
          else
            for (int i = 0; i < ns; ++i)
              std::fill(diff[i].begin(), diff[i].end(), 0);
        } else if (ns == 1) {
          int* row = &diff[0][size_t(yo) * sc[0]->bw];
          const HuffDec& h = dc[sc[0]->td];
          for (int x = 0; x < per_row; ++x) row[x] = diff_of(h);
        } else {
          for (int mx = 0; mx < mcux; ++mx)
            for (int i = 0; i < ns; ++i) {
              Comp& c = *sc[i];
              const HuffDec& h = dc[c.td];
              for (int yy = 0; yy < c.v; ++yy)
                for (int xx = 0; xx < c.h; ++xx)
                  diff[i][size_t(yy) * c.bw + mx * c.h + xx] = diff_of(h);
            }
        }
      }
      // undifference the real rows and columns (jddiffct.c decompress_data)
      for (int i = 0; i < ns; ++i) {
        Comp& c = *sc[i];
        int rows = std::min(c.v, c.dh - r * c.v);
        for (int yy = 0; yy < rows; ++yy) {
          const int* df = &diff[i][size_t(yy) * c.bw];
          int* out = &undiff[i][size_t(yy + 1) * c.bw];
          const int* prev = &undiff[i][size_t(yy) * c.bw];  // row 0: last row
          if (first_row && yy == 0)
            undifference_first(df, out, c.dw, initial);
          else
            undifference(df, prev, out, c.dw, Ss);
          uint8_t* o = &c.plane[size_t(r * c.v + yy) * c.pw];
          for (int x = 0; x < c.dw; ++x) o[x] = uint8_t(out[x] << Al);
        }
        if (rows > 0)  // keep the last row as the next iMCU row's row 0
          memcpy(&undiff[i][0], &undiff[i][size_t(rows) * c.bw],
                 sizeof(int) * c.bw);
      }
      first_row = false;
    }
    pos = br.p;
    unread_marker = br.marker;
  }

  static void undifference_first(const int* df, int* out, int w, int init) {
    int ra = (df[0] + init) & 0xFFFF;
    out[0] = ra;
    for (int x = 1; x < w; ++x) out[x] = ra = (df[x] + ra) & 0xFFFF;
  }

  static void undifference(const int* df, const int* prev, int* out, int w,
                           int psv) {
    int64_t rb = prev[0];
    int64_t ra = (df[0] + rb) & 0xFFFF;
    out[0] = int(ra);
    for (int x = 1; x < w; ++x) {
      int64_t rc = rb;
      rb = prev[x];
      int64_t p;
      switch (psv) {
        case 1: p = ra; break;
        case 2: p = rb; break;
        case 3: p = rc; break;
        case 4: p = ra + rb - rc; break;
        case 5: p = ra + ((rb - rc) >> 1); break;
        case 6: p = rb + ((ra - rc) >> 1); break;
        default: p = (ra + rb) >> 1; break;
      }
      ra = (df[x] + int(p)) & 0xFFFF;
      out[x] = int(ra);
    }
  }

  // ------------------------------------------------------------ output
  // jdcoefct.c smoothing_ok: smooth a progressive image when every
  // component's DC is at least partly known, the first ten quantizers are
  // nonzero and some of the first nine AC coefficients are unsent or
  // unrefined
  bool smoothing_ok() const {
    if (!progressive) return false;
    static const int kQPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < nc; ++i) {
      const Comp& c = comp[i];
      if (!c.latched) return false;
      for (int k = 0; k < 10; ++k)
        if (c.q[kQPos[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // jdcoefct.c decompress_smooth_data for one component: each block's
  // unknown low-frequency coefficients estimated from the DC values of a
  // 5x5 block neighbourhood (and, with no AC data at all, its DC too),
  // then the IDCT
  void idct_smooth(Comp& c) {
    const int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
    // the status latched at the start of output: the final one, and for
    // iMCU rows past the last that the final scan decoded with data, the
    // one before each component's latest scan (-1s after one scan)
    int prev[10];
    for (int k = 1; k < 10; ++k) prev[k] = scans > 1 ? c.prev_coef_bits[k] : -1;
    const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16],
                  Q11 = c.q[9], Q02 = c.q[2], Q03 = c.q[3], Q12 = c.q[10],
                  Q21 = c.q[17], Q30 = c.q[24];
    const int T = mcuy, v = c.v;
    int16_t ws[64];
    // the estimate of one coefficient: num / (Q << 8), rounded, limited to
    // what the unsent bits can hold
    auto estimate = [](int64_t num, int64_t q, int al) {
      int pred;
      if (num >= 0) {
        pred = int(((q << 7) + num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = int(((q << 7) - num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      return int16_t(pred);
    };
    for (int r = 0; r < T; ++r) {
      const int* cb = r > last_good_row ? prev : c.coef_bits;
      const bool change_dc = cb[1] == -1 && cb[2] == -1 && cb[3] == -1 &&
                             cb[4] == -1 && cb[5] == -1 && cb[6] == -1 &&
                             cb[7] == -1 && cb[8] == -1 && cb[9] == -1;
      int block_rows = v;
      if (r == T - 1) {
        block_rows = nby % v;
        if (block_rows == 0) block_rows = v;
      }
      for (int b = 0; b < block_rows; ++b) {
        // libjpeg's row neighbours, clamped as its buffer pointers are
        const int cur = r * v + b;
        const int ibr = r * block_rows + b, ibrs = block_rows * T;
        const int prev = ibr > 0 ? cur - 1 : cur;
        const int pprev = ibr > 1 ? cur - 2 : prev;
        const int next = ibr < ibrs - 1 ? cur + 1 : cur;
        const int nnext = ibr < ibrs - 2 ? cur + 2 : next;
        const int rows[5] = {pprev, prev, cur, next, nnext};
        auto dcv = [&](int ri, int bx) {
          return int(c.coef[(size_t(rows[ri]) * c.bw + bx) * 64]);
        };
        for (int bx = 0; bx < nbx; ++bx) {
          memcpy(ws, &c.coef[(size_t(cur) * c.bw + bx) * 64], sizeof(ws));
          int x[5];
          for (int k = 0; k < 5; ++k)
            x[k] = std::min(std::max(bx + k - 2, 0), nbx - 1);
          int DC[26];
          for (int ri = 0; ri < 5; ++ri)
            for (int k = 0; k < 5; ++k) DC[1 + 5 * ri + k] = dcv(ri, x[k]);
#define D(i) int64_t(DC[i])
          int al;
          if ((al = cb[1]) != 0 && ws[1] == 0) {
            int64_t num =
                Q00 *
                (change_dc
                     ? (-D(1) - D(2) + D(4) + D(5) - 3 * D(6) + 13 * D(7) -
                        13 * D(9) + 3 * D(10) - 3 * D(11) + 38 * D(12) -
                        38 * D(14) + 3 * D(15) - 3 * D(16) + 13 * D(17) -
                        13 * D(19) + 3 * D(20) - D(21) - D(22) + D(24) +
                        D(25))
                     : (-7 * D(11) + 50 * D(12) - 50 * D(14) + 7 * D(15)));
            ws[1] = estimate(num, Q01, al);
          }
          if ((al = cb[2]) != 0 && ws[8] == 0) {
            int64_t num =
                Q00 *
                (change_dc
                     ? (-D(1) - 3 * D(2) - 3 * D(3) - 3 * D(4) - D(5) -
                        D(6) + 13 * D(7) + 38 * D(8) + 13 * D(9) - D(10) +
                        D(16) - 13 * D(17) - 38 * D(18) - 13 * D(19) +
                        D(20) + D(21) + 3 * D(22) + 3 * D(23) + 3 * D(24) +
                        D(25))
                     : (-7 * D(3) + 50 * D(8) - 50 * D(18) + 7 * D(23)));
            ws[8] = estimate(num, Q10, al);
          }
          if ((al = cb[3]) != 0 && ws[16] == 0) {
            int64_t num =
                Q00 * (change_dc
                           ? (D(3) + 2 * D(7) + 7 * D(8) + 2 * D(9) -
                              5 * D(12) - 14 * D(13) - 5 * D(14) +
                              2 * D(17) + 7 * D(18) + 2 * D(19) + D(23))
                           : (-D(3) + 13 * D(8) - 24 * D(13) + 13 * D(18) -
                              D(23)));
            ws[16] = estimate(num, Q20, al);
          }
          if ((al = cb[4]) != 0 && ws[9] == 0) {
            int64_t num =
                Q00 * (change_dc
                           ? (-D(1) + D(5) + 9 * D(7) - 9 * D(9) -
                              9 * D(17) + 9 * D(19) + D(21) - D(25))
                           : (D(10) + D(16) - 10 * D(17) + 10 * D(19) -
                              D(2) - D(20) + D(22) - D(24) + D(4) - D(6) +
                              10 * D(7) - 10 * D(9)));
            ws[9] = estimate(num, Q11, al);
          }
          if ((al = cb[5]) != 0 && ws[2] == 0) {
            int64_t num =
                Q00 * (change_dc
                           ? (2 * D(7) - 5 * D(8) + 2 * D(9) + D(11) +
                              7 * D(12) - 14 * D(13) + 7 * D(14) + D(15) +
                              2 * D(17) - 5 * D(18) + 2 * D(19))
                           : (-D(11) + 13 * D(12) - 24 * D(13) +
                              13 * D(14) - D(15)));
            ws[2] = estimate(num, Q02, al);
          }
          if (change_dc) {
            if ((al = cb[6]) != 0 && ws[3] == 0)
              ws[3] = estimate(Q00 * (D(7) - D(9) + 2 * D(12) - 2 * D(14) +
                                      D(17) - D(19)),
                               Q03, al);
            if ((al = cb[7]) != 0 && ws[10] == 0)
              ws[10] = estimate(Q00 * (D(7) - 3 * D(8) + D(9) - D(17) +
                                       3 * D(18) - D(19)),
                                Q12, al);
            if ((al = cb[8]) != 0 && ws[17] == 0)
              ws[17] = estimate(Q00 * (D(7) - D(9) - 3 * D(12) + 3 * D(14) +
                                       D(17) - D(19)),
                                Q21, al);
            if ((al = cb[9]) != 0 && ws[24] == 0)
              ws[24] = estimate(Q00 * (D(7) + 2 * D(8) + D(9) - D(17) -
                                       2 * D(18) - D(19)),
                                Q30, al);
            int64_t num =
                Q00 * (-2 * D(1) - 6 * D(2) - 8 * D(3) - 6 * D(4) -
                       2 * D(5) - 6 * D(6) + 6 * D(7) + 42 * D(8) +
                       6 * D(9) - 6 * D(10) - 8 * D(11) + 42 * D(12) +
                       152 * D(13) + 42 * D(14) - 8 * D(15) - 6 * D(16) +
                       6 * D(17) + 42 * D(18) + 6 * D(19) - 6 * D(20) -
                       2 * D(21) - 6 * D(22) - 8 * D(23) - 6 * D(24) -
                       2 * D(25));
            ws[0] = estimate(num, Q00, 0);
          }
#undef D
          idct_islow(ws, c.q, &c.plane[size_t(cur) * 8 * c.pw + bx * 8],
                     c.pw);
        }
      }
    }
  }

  void idct_all() {
    const bool smooth = smoothing_ok();
    for (int i = 0; i < nc; ++i) {
      Comp& c = comp[i];
      if (lossless) {
        if (!c.scanned) throw Error("JPEG component was never scanned");
        continue;
      }
      int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
      c.pw = nbx * 8;
      c.plane.assign(size_t(c.pw) * nby * 8, 0);
      if (!c.scanned) {
        // never in a scan: libjpeg's coefficients start at zero and its
        // IDCT table stays zero without a quantization table: 128
        memset(c.plane.data(), 128, c.plane.size());
        continue;
      }
      if (smooth) {
        idct_smooth(c);
        continue;
      }
      for (int by = 0; by < nby; ++by)
        for (int bx = 0; bx < nbx; ++bx)
          idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], c.q,
                     &c.plane[size_t(by) * 8 * c.pw + bx * 8], c.pw);
    }
  }

  // one full-resolution row y of component c into out[0..W)
  void upsample_row(const Comp& c, int y, uint8_t* out,
                    std::vector<int>& colsum) const {
    const int rh = hmax / c.h, rv = vmax / c.v;
    const uint8_t* plane = c.plane.data();
    int pw = c.pw, dw = c.dw, dh = c.dh;
    // int_upsample (box replication) for any other integral ratio, and
    // for every ratio where libjpeg has no fancy upsampling: a lossless
    // image, whose DCT "blocks" are one sample
    if (rh > 2 || rv > 2 || (lossless && (rh > 1 || rv > 1))) {
      const uint8_t* row = plane + size_t(y / rv) * pw;
      if (rh == 1)
        memcpy(out, row, W);
      else
        for (int x = 0; x < W; ++x) out[x] = row[x / rh];
      return;
    }
    bool h2 = rh == 2, v2 = rv == 2;
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
    if (lossless) return true;  // libjpeg-turbo 3 assumes RGB there
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }

  // 4 components: CMYK unless an Adobe marker says otherwise (transform
  // 0 is CMYK, any other YCCK)
  bool is_ycck() const { return adobe && adobe_transform != 0; }

  void output(uint8_t* out) {
    // libjpeg-turbo 3.1 converts no colours in a lossless stream
    if (lossless && ((nc == 3 && !is_rgb()) || (nc == 4 && is_ycck())))
      throw Error(std::string("unsupported JPEG colour conversion: ") +
                  (nc == 3 ? "YCbCr" : "YCCK") + " in a lossless (SOF3) "
                  "stream");
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
    std::vector<uint8_t> a(W), b(W), c(W), k(W);
    if (nc == 4) {
      const bool ycck = is_ycck();
      for (int y = 0; y < H; ++y) {
        upsample_row(comp[0], y, a.data(), colsum);
        upsample_row(comp[1], y, b.data(), colsum);
        upsample_row(comp[2], y, c.data(), colsum);
        upsample_row(comp[3], y, k.data(), colsum);
        uint8_t* o = out + size_t(y) * W * 3;
        for (int x = 0; x < W; ++x) {
          int cmy[3] = {a[x], b[x], c[x]};
          if (ycck) {  // jdcolor.c ycck_cmyk_convert
            int yy = a[x], cb = b[x], cr = c[x];
            cmy[0] = clamp255(255 - (yy + kYcc.cr_r[cr]));
            cmy[1] = clamp255(255 - (yy + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >>
                                              kScaleBits)));
            cmy[2] = clamp255(255 - (yy + kYcc.cb_b[cb]));
          }
          // PIL reads the samples as "CMYK;I" (inverted), then its
          // cmyk2rgb: out = nk - nk * c / 255, nk = 255 - k, rounded as
          // MULDIV255
          int nk = k[x];  // 255 - (255 - K)
          for (int j = 0; j < 3; ++j) {
            int t = (255 - cmy[j]) * nk + 128;
            o[3 * x + j] = clamp255(nk - (((t >> 8) + t) >> 8));
          }
        }
      }
      return;
    }
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
