// JPEG XR codestream decoder (ITU-T T.832 | ISO/IEC 29199-2) for the CZI
// reader's JpgXr subblocks. It follows the standard's decoding process as
// recalled, without its text or jxrlib's source at hand, and is held to
// a test-side encoder written the same way (tests/golden/regenerate_jxr.py),
// not to ZEN-written streams: the VLC code tables, the coefficient syntax,
// the transforms' slot order and the overlap filter's lifting steps are
// unverified against jxrlib. Each tile packet is read only within its
// span of the index table and must end there (but for the padding to a
// whole byte), so a stream written with another syntax mostly raises.
// The parts:
//
// - the image header (WMPHOTO, HARD_TILING_FLAG, TILING_FLAG,
//   FREQUENCY_MODE_CODESTREAM_FLAG, INDEX_TABLE_PRESENT_FLAG, OVERLAP_MODE
//   0/1/2, SHORT_HEADER_FLAG, LONG_WORD_FLAG, WINDOWING_FLAG and its
//   margins, TRIM_FLEXBITS_FLAG, ALPHA_IMAGE_PLANE_FLAG, the output colour
//   format and bit depth, uniform and non-uniform tile partitions);
// - the image plane header (YONLY, YUV420, YUV422, YUV444; NO_SCALED_FLAG;
//   BANDS_PRESENT ALL, NOFLEXBITS, NOHIGHPASS, DCONLY; DC, LP and HP
//   quantizers uniform, separate or independent per channel, per image
//   plane or per tile, several LP and HP quantizers chosen per macroblock;
//   SHIFT_BITS at 16 bits);
// - tiles in spatial and in frequency order (DC, LP, HP and FLEXBITS
//   packets) through the index table;
// - the macroblock layer: CBP prediction and decoding, DC, LP and HP
//   prediction, the adaptive scans, the adaptive VLC tables, model bits
//   and FLEXBITS refinement (and its trimming);
// - the two-stage lapped transform: the PCT at both stages with the
//   4:2:0 and 4:2:2 chroma second stages, and the overlap post-filter at
//   OL1 and OL2, across soft tile edges and not across hard ones;
// - the inverse colour transform, chroma upsampling and the output clip.
//
// Output: 8-bit or unsigned 16-bit samples, 1 or 3 channels, plus the
// alpha image plane as a fourth. Everything else raises by name: YUVK,
// NCOMPONENT and CMYK, signed, float, RGBE, 5-, 10-, 565- and 1-bit
// output, and any reserved value. Every read is bounds-checked: a
// truncated or corrupt stream raises instead of reading past its buffer.
//
// C interface (ctypes releases the GIL around each call):
//   int jxr_info(src, n, int32 dims[4], err, errlen)
//     dims = height, width, channels, bytes per sample; 0, or -1 with a
//     message in err.
//   int jxr_decode(src, n, dst, dst_bytes, err, errlen)
//     (height, width, channels) samples in R, G, B (, A) or Y order.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw Error(what); }

std::string num(long v) { return std::to_string(v); }

// --------------------------------------------------------------- bits

struct Bits {
  const uint8_t* d = nullptr;
  size_t nbits = 0, pos = 0;
  const char* past = "the codestream is truncated";

  Bits() = default;
  Bits(const uint8_t* p, size_t n) : d(p), nbits(n * 8) {}

  uint64_t peek() const {
    size_t byte = pos >> 3, nbytes = nbits >> 3;
    uint64_t v = 0;
    if (byte + 8 <= nbytes) {
      std::memcpy(&v, d + byte, 8);
      v = __builtin_bswap64(v);
    } else {
      for (int i = 0; i < 8; ++i)
        v = (v << 8) | (byte + i < nbytes ? d[byte + i] : 0);
    }
    return v << (pos & 7);
  }
  uint32_t get(int k) {
    if (k == 0) return 0;
    if (pos + k > nbits) fail(past);
    uint32_t v = (uint32_t)(peek() >> (64 - k));
    pos += k;
    return v;
  }
  bool bit() { return get(1) != 0; }
  void align() { pos = (pos + 7) & ~(size_t)7; }
  size_t byte() const { return pos >> 3; }
};

uint64_t vlw_esc(Bits& b) {
  uint32_t v = b.get(8);
  if (v < 0xFB) return (v << 8) | b.get(8);
  if (v == 0xFB) return b.get(32);
  if (v == 0xFC) {
    uint32_t hi = b.get(32), lo = b.get(32);
    if (hi) fail("a VLW_ESC value past 32 bits");
    return lo;
  }
  fail("a VLW_ESC escape code " + num(v));
}

// ------------------------------------------------ adaptive VLC tables
// Code lengths of each table of each alphabet (4, 5, 6, 7 and 12
// symbols); codes are assigned from the longest length up, each length's
// first code one past the longer length's last, shifted down.

const int kMaxLen = 11;

struct Table {
  int len[12] = {};
  uint16_t lut[1 << kMaxLen];  // symbol << 4 | length
};

const int L4[1][12] = {{1, 2, 3, 3}};
const int L5[2][12] = {{1, 2, 3, 4, 4}, {1, 3, 3, 3, 3}};
const int L6[4][12] = {{1, 2, 3, 4, 5, 5},
                       {1, 2, 4, 4, 4, 4},
                       {1, 3, 3, 3, 4, 4},
                       {2, 2, 3, 3, 3, 3}};
const int L7[2][12] = {{1, 2, 3, 4, 5, 6, 6}, {1, 3, 3, 4, 4, 4, 4}};
const int L12[5][12] = {{1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 11},
                        {2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 6, 6},
                        {2, 3, 3, 3, 3, 4, 4, 5, 5, 5, 6, 6},
                        {3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 5, 5},
                        {3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4}};

struct Alphabet {
  int nsym, ntab;
  Table tab[5];
};

void build(Table& t, int nsym, const int* len) {
  std::memcpy(t.len, len, sizeof(int) * nsym);
  int order[12];
  for (int s = 0; s < nsym; ++s) order[s] = s;
  std::stable_sort(order, order + nsym,
                   [&](int a, int b) { return len[a] > len[b]; });
  int code = -1, prev = len[order[0]];
  for (int i = 0; i < nsym; ++i) {
    int s = order[i];
    code = (code + 1) >> (prev - len[s]);
    prev = len[s];
    int lo = code << (kMaxLen - len[s]), hi = (code + 1) << (kMaxLen - len[s]);
    for (int k = lo; k < hi; ++k) t.lut[k] = (uint16_t)(s << 4 | len[s]);
  }
}

struct Alphabets {
  Alphabet a4, a5, a6, a7, a12;
  Alphabets() {
    a4 = {4, 1, {}};
    build(a4.tab[0], 4, L4[0]);
    a5 = {5, 2, {}};
    for (int t = 0; t < 2; ++t) build(a5.tab[t], 5, L5[t]);
    a6 = {6, 4, {}};
    for (int t = 0; t < 4; ++t) build(a6.tab[t], 6, L6[t]);
    a7 = {7, 2, {}};
    for (int t = 0; t < 2; ++t) build(a7.tab[t], 7, L7[t]);
    a12 = {12, 5, {}};
    for (int t = 0; t < 5; ++t) build(a12.tab[t], 12, L12[t]);
  }
};

const Alphabets& alphabets() {
  static const Alphabets a;
  return a;
}

int huff(Bits& b, const Table& t) {
  uint16_t e = t.lut[b.peek() >> (64 - kMaxLen)];
  int n = e & 15;
  if (b.pos + n > b.nbits) fail("the codestream is truncated");
  b.pos += n;
  return e >> 4;
}

const int kThreshold = 8, kMemory = 8;

// One adaptive table: the index moves down when the discriminant falls
// below -8 and up when the (second, for 6 and 12 symbols) discriminant
// passes 8, checked after each macroblock; each symbol adds the
// difference of its code lengths between neighbouring tables.
struct Adaptive {
  const Alphabet* a = nullptr;
  int t = 0, d = 0, d1 = 0;
  bool two = false;
  int delta[12] = {}, delta1[12] = {};
  bool has_lower = false, has_upper = false;

  void init(const Alphabet& al) {
    a = &al;
    two = al.nsym == 6 || al.nsym == 12;
    t = two ? 1 : 0;
    d = d1 = 0;
    set();
  }
  void set() {
    int n = a->nsym, T = a->ntab;
    for (int s = 0; s < n; ++s) {
      if (T == 1) {
        delta[s] = delta1[s] = 0;
      } else if (!two) {
        delta[s] = delta1[s] = a->tab[0].len[s] - a->tab[1].len[s];
      } else {
        int lo = std::max(t, 1), hi = std::min(t, T - 2);
        delta[s] = a->tab[lo - 1].len[s] - a->tab[lo].len[s];
        delta1[s] = a->tab[hi].len[s] - a->tab[hi + 1].len[s];
      }
    }
    has_lower = t > 0;
    has_upper = t < T - 1;
  }
  int get(Bits& b) {
    int s = huff(b, a->tab[t]);
    d += delta[s];
    if (two) d1 += delta1[s];
    return s;
  }
  void adapt() {
    if (a->ntab == 1) return;
    int dl = d, dh = two ? d1 : d;
    if (has_lower && dl < -kThreshold) {
      --t;
      d = d1 = 0;
    } else if (has_upper && dh > kThreshold) {
      ++t;
      d = d1 = 0;
    }
    const int lim = kThreshold * kMemory;
    d = std::min(std::max(d, -lim), lim);
    d1 = std::min(std::max(d1, -lim), lim);
    set();
  }
};

const int kLevelRemap[6] = {2, 3, 4, 6, 10, 14};
const int kLevelFlc[6] = {0, 0, 1, 2, 2, 2};
const int kRunRemap[15] = {1, 2, 3, 5, 7, 1, 2, 3, 5, 7, 1, 2, 3, 4, 5};
const int kRunFlc[15] = {0, 0, 1, 1, 3, 0, 0, 1, 1, 2, 0, 0, 0, 0, 1};

// an absolute level of 2 or more
uint32_t get_level(Bits& b, Adaptive& tab) {
  int i = tab.get(b);
  if (i < 6) return kLevelRemap[i] + b.get(kLevelFlc[i]);
  int k = (int)b.get(4) + 4;
  if (k == 19) {
    k += b.get(2);
    if (k == 22) k += b.get(3);
  }
  return 2u + (1u << k) + b.get(k);
}

// a run of 1..maxrun zeros
int get_run(Bits& b, Adaptive& tab, int maxrun) {
  if (maxrun < 1) fail("a run where no coefficient is left");
  if (maxrun == 1) return 1;
  if (maxrun < 5) {
    if (b.bit()) return 1;
    if (maxrun == 2 || b.bit()) return 2;
    if (maxrun == 3 || b.bit()) return 3;
    return 4;
  }
  int bin = maxrun <= 6 ? 2 : (maxrun <= 10 ? 1 : 0);
  int i = tab.get(b) + 5 * bin;
  int r = kRunRemap[i] + (int)b.get(kRunFlc[i]);
  if (r > maxrun) fail("a run past the end of a block");
  return r;
}

struct BandTables {
  Adaptive first[2], cont[2], last2, run, level[2];
  void init() {
    const Alphabets& A = alphabets();
    for (int c = 0; c < 2; ++c) {
      first[c].init(A.a12);
      cont[c].init(A.a6);
      level[c].init(A.a7);
    }
    last2.init(A.a4);
    run.init(A.a5);
  }
  void adapt() {
    for (int c = 0; c < 2; ++c) {
      first[c].adapt();
      cont[c].adapt();
      level[c].adapt();
    }
    run.adapt();
  }
};

// Run-level decoding of a block of n coefficients in scan order into v;
// returns the number of nonzero ones (at least one).
int get_block(Bits& b, BandTables& tb, int cls, int n, int32_t* v) {
  for (int i = 0; i < n; ++i) v[i] = 0;
  int sym = tb.first[cls].get(b);
  int sr = sym & 1, sl = (sym >> 1) & 1, nxt = sym >> 2;
  int p = sr ? get_run(b, tb.run, n - 1) : 0;
  int count = 0;
  for (;;) {
    if (p > n - 1) fail("a coefficient past the end of a block");
    int rem = n - 1 - p;
    if ((rem == 0 && nxt) || (rem == 1 && nxt == 2))
      fail("a coefficient past the end of a block");
    bool neg = b.bit();
    uint32_t mag = sl ? get_level(b, tb.level[cls]) : 1;
    v[p] = neg ? (int32_t)(0u - mag) : (int32_t)mag;
    ++count;
    if (!nxt) break;
    int prev = p;
    p = prev + 1 + (nxt == 2 ? get_run(b, tb.run, n - prev - 2) : 0);
    if (p > n - 1) fail("a coefficient past the end of a block");
    sym = (n - 1 - p <= 1) ? tb.last2.get(b) : tb.cont[cls].get(b);
    nxt = sym >> 1;
    sl = sym & 1;
  }
  return count;
}

// Model bits of one band (0 DC, 1 LP, 2 HP), luma and chroma apart.
struct Model {
  int band = 0, bits[2] = {0, 0}, state[2] = {0, 0};
  void init(int b) {
    band = b;
    bits[0] = bits[1] = state[0] = state[1] = 0;
  }
  void update(int fmt, int nch, int lap0, int lap1) {
    static const int W0[3] = {240, 12, 1};
    static const int W1[3][4] = {{0, 240, 120, 80}, {0, 12, 6, 4},
                                 {0, 16, 8, 5}};
    static const int W420[3] = {120, 37, 2}, W422[3] = {120, 18, 1};
    int lap[2] = {lap0 * W0[band], lap1};
    if (fmt == 1) {
      lap[1] *= W420[band];
    } else if (fmt == 2) {
      lap[1] *= W422[band];
    } else {
      lap[1] *= W1[band][nch - 1];
      if (band == 2) lap[1] >>= 4;
    }
    for (int j = 0; j < (nch == 1 ? 1 : 2); ++j) {
      int ms = state[j], delta = (lap[j] - 70) >> 2;
      if (delta <= -8) {
        ms += std::max(delta + 4, -16);
        if (ms < -8) {
          if (bits[j] == 0) {
            ms = -8;
          } else {
            ms = 0;
            --bits[j];
          }
        }
      } else if (delta >= 8) {
        ms += std::min(delta - 4, 15);
        if (ms > 8) {
          if (bits[j] >= 15) {
            bits[j] = 15;
            ms = 8;
          } else {
            ms = 0;
            ++bits[j];
          }
        }
      }
      state[j] = ms;
    }
  }
};

// An adaptive scan: a nonzero at a position raises its count, which
// moves the position one place forward when it passes the one before.
struct Scan {
  int n = 0, slot[15], total[15];
  void init(const int* slots, int count) {
    n = count;
    for (int i = 0; i < n; ++i) {
      slot[i] = slots[i];
      total[i] = 32 - 2 * i;
    }
  }
  void update(const int32_t* vscan) {
    bool nz[15];
    for (int i = 0; i < n; ++i) nz[i] = vscan[i] != 0;
    for (int i = 0; i < n; ++i) {
      if (!nz[i]) continue;
      ++total[i];
      if (i && total[i] > total[i - 1]) {
        std::swap(slot[i], slot[i - 1]);
        std::swap(total[i], total[i - 1]);
      }
    }
  }
};

// natural frequency index (row * 4 + column) -> coefficient slot
const int kNat2Slot[16] = {0, 4, 2, 5, 8, 12, 10, 13, 1, 6, 3, 7, 9, 14, 11, 15};
// slots predicted from above (first row) and from the left (first column)
const int kRow16[3] = {4, 2, 5}, kCol16[3] = {8, 1, 9};
const int kRow4[1] = {2}, kCol4[1] = {1};
const int kRow8[1] = {3}, kCol8[2] = {1, 2};

struct Scans {
  int lp16[15], lp4[3], lp8[7], horiz[15], vert[15];
  Scans() {
    const int nl[15] = {4, 1, 5, 8, 2, 12, 9, 6, 3, 13, 10, 7, 14, 11, 15};
    const int nh[15] = {1, 4, 5, 2, 8, 6, 9, 3, 12, 10, 7, 13, 11, 14, 15};
    const int nv[15] = {4, 8, 5, 1, 12, 9, 6, 2, 13, 3, 15, 7, 10, 14, 11};
    for (int i = 0; i < 15; ++i) {
      lp16[i] = kNat2Slot[nl[i]];
      horiz[i] = kNat2Slot[nh[i]];
      vert[i] = kNat2Slot[nv[i]];
    }
    const int l4[3] = {1, 2, 3}, l8[7] = {1, 2, 3, 5, 6, 4, 7};
    std::memcpy(lp4, l4, sizeof l4);
    std::memcpy(lp8, l8, sizeof l8);
  }
};

const Scans& scans() {
  static const Scans s;
  return s;
}

// --------------------------------------------------------- transforms

inline void t2x2h(int32_t& a, int32_t& b, int32_t& c, int32_t& d, int r) {
  a += d;
  b -= c;
  int32_t t = (a - b + r) >> 1;
  int32_t c0 = c;
  c = t - d;
  d = t - c0;
  a -= d;
  b += c;
}

inline void inv_odd(int32_t& a, int32_t& b, int32_t& c, int32_t& d) {
  b += d;
  a -= c;
  d -= b >> 1;
  c += (a + 1) >> 1;
  a -= (3 * b + 4) >> 3;
  b += (3 * a + 4) >> 3;
  c -= (3 * d + 4) >> 3;
  d += (3 * c + 4) >> 3;
  c -= (b + 1) >> 1;
  d = ((a + 1) >> 1) - d;
  b += c;
  a -= d;
}

inline void inv_oddodd(int32_t& a, int32_t& b, int32_t& c, int32_t& d) {
  d += a;
  c -= b;
  int32_t t1 = d >> 1, t2 = c >> 1;
  a -= t1;
  b += t2;
  a -= (b * 3 + 3) >> 3;
  b += (a * 3 + 3) >> 2;
  a -= (b * 3 + 4) >> 3;
  b -= t2;
  a += t1;
  c += b;
  d -= a;
  b = -b;
  c = -c;
}

const int kGroups[4][4] = {{0, 3, 12, 15}, {1, 2, 13, 14}, {4, 7, 8, 11},
                           {5, 6, 9, 10}};

// the inverse 4 x 4 PCT: slots -> pixels in raster order
void ict4(const int32_t* in, int32_t* x) {
  int32_t p[16];
  std::memcpy(p, in, sizeof p);
  inv_oddodd(p[15], p[14], p[13], p[12]);
  inv_odd(p[8], p[10], p[11], p[9]);
  inv_odd(p[4], p[5], p[7], p[6]);
  t2x2h(p[0], p[1], p[2], p[3], 1);
  for (int k = 0; k < 4; ++k) {
    int32_t a = p[k], b = p[8 + k], c = p[4 + k], d = p[12 + k];
    t2x2h(a, b, c, d, 0);
    x[kGroups[k][0]] = a;
    x[kGroups[k][1]] = b;
    x[kGroups[k][2]] = c;
    x[kGroups[k][3]] = d;
  }
}

void ict420(const int32_t* p, int32_t* x) {
  int32_t a = p[0], b = p[1], c = p[2], d = p[3];
  t2x2h(a, b, c, d, 1);
  x[0] = a;
  x[1] = b;
  x[2] = c;
  x[3] = d;
}

void ict422(const int32_t* p, int32_t* x) {
  int32_t at = p[0] - (p[1] >> 1);
  int32_t ab = p[1] + at;
  int32_t a = at, b = p[2], c = p[3], d = p[4];
  t2x2h(a, b, c, d, 1);
  x[0] = a, x[1] = b, x[2] = c, x[3] = d;
  a = ab, b = p[5], c = p[6], d = p[7];
  t2x2h(a, b, c, d, 1);
  x[4] = a, x[5] = b, x[6] = c, x[7] = d;
}

// the overlap post-filters: 4 samples across the edge between b and c,
// and 2 samples across the edge between them
inline void post4(int32_t& a, int32_t& b, int32_t& c, int32_t& d) {
  d -= a;
  c -= b;
  a += (d + 1) >> 1;
  b += (c + 1) >> 1;
  d -= (3 * c + 4) >> 3;
  c += (3 * d + 4) >> 3;
  b -= (c + 1) >> 1;
  a -= (d + 1) >> 1;
  c += b;
  d += a;
}

inline void post2(int32_t& a, int32_t& b) {
  int32_t d = b - a;
  a += (3 * d + 8) >> 4;
  b = a + d;
}

struct Region {
  int y0, y1, x0, x1;
};

// an int32 buffer left uninitialised: every sample is written before it
// is read
struct Buf {
  std::unique_ptr<int32_t[]> p;
  void alloc(size_t n) { p.reset(new int32_t[n]); }
  int32_t& operator[](size_t i) { return p[i]; }
  const int32_t& operator[](size_t i) const { return p[i]; }
  int32_t* data() { return p.get(); }
};

// The inverse overlap filter of one stage on a plane of `stride` columns,
// in each region, across every inner edge of the grid (gv rows, gh
// columns) with half-widths sv, sh: horizontal edges, then vertical ones.
void post_filter(int32_t* pl, size_t stride, const std::vector<Region>& regs,
                 int gv, int gh, int sv, int sh) {
  for (const Region& r : regs) {
    for (int y = r.y0 + gv; y < r.y1; y += gv)
      for (int x = r.x0; x < r.x1; ++x) {
        int32_t* c = pl + (size_t)y * stride + x;
        if (sv == 2)
          post4(c[-2 * (long)stride], c[-(long)stride], c[0], c[stride]);
        else
          post2(c[-(long)stride], c[0]);
      }
    for (int y = r.y0; y < r.y1; ++y) {
      int32_t* row = pl + (size_t)y * stride;
      for (int x = r.x0 + gh; x < r.x1; x += gh) {
        if (sh == 2)
          post4(row[x - 2], row[x - 1], row[x], row[x + 1]);
        else
          post2(row[x - 1], row[x]);
      }
    }
  }
}

// --------------------------------------------------------- the image

enum { YONLY = 0, YUV420 = 1, YUV422 = 2, YUV444 = 3 };
enum { BD8 = 1, BD16 = 2 };
enum { ALL = 0, NOFLEXBITS = 1, NOHIGHPASS = 2, DCONLY = 3 };

const char* kClrName[16] = {"YONLY", "YUV420", "YUV422", "YUV444", "CMYK",
                            "CMYKDIRECT", "NCOMPONENT", "RGB", "RGBE",
                            "reserved 9", "reserved 10", "reserved 11",
                            "reserved 12", "reserved 13", "reserved 14",
                            "reserved 15"};
const char* kDepthName[16] = {"BD1WHITE1", "BD8", "BD16", "BD16S", "BD16F",
                              "reserved 5", "BD32S", "BD32F", "BD5", "BD10",
                              "BD565", "reserved 11", "reserved 12",
                              "reserved 13", "reserved 14", "BD1BLACK1"};
const char* kInternalName[8] = {"YONLY", "YUV420", "YUV422", "YUV444",
                                "YUVK", "reserved 5", "NCOMPONENT",
                                "reserved 7"};

struct Quant {
  int32_t step[3] = {1, 1, 1};
};

int32_t remap(int idx, bool scaled, int shift) {
  if (idx == 0) return 1;
  int man, e;
  if (!scaled) {
    if (idx < 32) {
      man = (idx + 3) >> 2, e = 0;
    } else if (idx < 48) {
      man = (16 + (idx & 15) + 1) >> 1, e = (idx >> 4) - 2;
    } else {
      man = 16 + (idx & 15), e = (idx >> 4) - 3;
    }
  } else if (idx < 16) {
    man = idx, e = shift;
  } else {
    man = 16 + (idx & 15), e = (idx >> 4) - 1 + shift;
  }
  return man << e;
}

// a quantizer: its channel mode, then QP indices; DC and LP chroma steps
// are not shifted under scaled arithmetic
Quant read_quant(Bits& b, int nch, bool scaled, bool shifted_uv) {
  int mode = nch > 1 ? (int)b.get(2) : 0;
  if (mode == 3) fail("a quantizer channel mode 3 (reserved)");
  int idx[3];
  idx[0] = b.get(8);
  if (mode == 0) {
    idx[1] = idx[2] = idx[0];
  } else if (mode == 1) {
    idx[1] = idx[2] = b.get(8);
  } else {
    for (int c = 1; c < nch; ++c) idx[c] = b.get(8);
  }
  Quant q;
  for (int c = 0; c < nch; ++c)
    q.step[c] = remap(idx[c], scaled, (c && shifted_uv) ? 0 : 1);
  return q;
}

struct TileQuant {
  Quant dc;
  std::vector<Quant> lp, hp;
  bool hp_uses_lp = false;
};

int qbits(int n) {
  return n < 2 ? 0 : (n < 4 ? 1 : (n < 6 ? 2 : (n < 10 ? 3 : 4)));
}

struct Image;

struct Plane {
  Image* im = nullptr;
  int fmt = 0, nch = 1, bands = 0, shift_bits = 0;
  bool scaled = false;
  bool dc_uniform = true, lp_use_dc = true, lp_uniform = true;
  bool hp_use_lp = true, hp_uniform = true, lp_tile = false, hp_tile = false;
  Quant dcq, lpq, hpq;
  std::vector<TileQuant> tq;
  int bh[3] = {4, 4, 4}, bw[3] = {4, 4, 4}, nlp[3] = {16, 16, 16};
  Buf lp[3], hp[3];
  std::vector<uint8_t> cbp[3];
  std::vector<uint8_t> lpidx, hpidx, kh;
  // coding state, reset at each tile
  Adaptive dcl[2], cbpq[2];
  BandTables lpt, hpt;
  Model model[3];
  Scan lps[3], hps[2];
  int trim = 0;

  int cls(int c) const { return c ? 1 : 0; }
  size_t nblocks(int c) const { return (size_t)bh[c] * bw[c]; }

  void read_header(Bits& b, int depth, int mbs);
  void tile_header(Bits& b, int t, char which);
  void reset();
  void mb_indices(Bits& b, int t, size_t mb, bool lp, bool hp);
  int dc_mode(int my, int mx, int t0y, int t0x) const;
  void decode_dc(Bits& b, int my, int mx, int t0y, int t0x);
  void decode_lp(Bits& b, int my, int mx, int t0y, int t0x);
  void decode_hp(Bits& b, int my, int mx, int t0y, int t0x);
  void decode_flex(Bits* b, int my, int mx);
  void reconstruct_hp(int my, int mx);
  void cbp_decode(Bits& b, int c, int my, int mx, int t0y, int t0x);
  void output(Buf chans[3], const std::vector<int>& tiles);
};

struct Image {
  int width = 0, height = 0, depth = 0, out_fmt = 0;
  bool hard = false, tiling = false, frequency = false, index = false;
  int overlap = 0;
  bool short_header = false, windowing = false, trim_flag = false;
  bool alpha = false;
  int top = 0, left = 0, bottom = 0, right = 0;
  int mbw = 0, mbh = 0;
  std::vector<int> tx, ty;  // tile bounds in macroblocks
  Plane planes[2];
  int nplanes = 1;
  size_t data_start = 0;
  std::vector<uint64_t> offsets;

  void read_header(const uint8_t* src, size_t n);
  int channels() const { return (out_fmt == YONLY ? 1 : 3) + (alpha ? 1 : 0); }
};

void Image::read_header(const uint8_t* src, size_t n) {
  if (n < 8 || std::memcmp(src, "WMPHOTO", 8) != 0)
    fail("not a JPEG XR codestream (no WMPHOTO signature)");
  Bits b(src, n);
  b.pos = 64;
  int version = b.get(4);
  if (version != 1)
    fail("RESERVED_B (the codec version) " + num(version) + " is not 1");
  hard = b.bit();
  int sub = b.get(3);
  if (sub != 1) fail("RESERVED_C " + num(sub) + " is not 1");
  tiling = b.bit();
  frequency = b.bit();
  int xfrm = b.get(3);
  if (xfrm)
    fail("SPATIAL_XFRM_SUBORDINATE " + num(xfrm) +
         " (a flipped or rotated image) is not supported");
  index = b.bit();
  overlap = b.get(2);
  if (overlap == 3) fail("OVERLAP_MODE 3 is reserved");
  short_header = b.bit();
  b.get(1);  // LONG_WORD_FLAG: intermediates are 32-bit here either way
  windowing = b.bit();
  trim_flag = b.bit();
  int resd = b.get(3);
  if (resd) fail("RESERVED_D " + num(resd) + " is not 0");
  alpha = b.bit();
  out_fmt = b.get(4);
  depth = b.get(4);
  if (out_fmt != YONLY && out_fmt != 7)
    fail(std::string("OUTPUT_CLR_FMT ") + kClrName[out_fmt] +
         " is not supported (only YONLY and RGB)");
  if (depth != BD8 && depth != BD16)
    fail(std::string("OUTPUT_BITDEPTH ") + kDepthName[depth] +
         " is not supported (only BD8 and BD16)");
  if (out_fmt == YONLY && alpha)
    fail("ALPHA_IMAGE_PLANE_FLAG with OUTPUT_CLR_FMT YONLY is not "
         "supported");
  int nb = short_header ? 16 : 32;
  width = (int)std::min<uint64_t>((uint64_t)b.get(nb) + 1, 1u << 30);
  height = (int)std::min<uint64_t>((uint64_t)b.get(nb) + 1, 1u << 30);
  int ncols = 1, nrows = 1;
  if (tiling) {
    ncols = b.get(12) + 1;
    nrows = b.get(12) + 1;
  }
  std::vector<long> tw(ncols - 1), th(nrows - 1);
  for (auto& v : tw) v = b.get(short_header ? 8 : 16);
  for (auto& v : th) v = b.get(short_header ? 8 : 16);
  if (windowing) {
    top = b.get(6);
    left = b.get(6);
    bottom = b.get(6);
    right = b.get(6);
  } else {
    bottom = (16 - height % 16) % 16;
    right = (16 - width % 16) % 16;
  }
  long cw = (long)left + width + right, ch = (long)top + height + bottom;
  if (cw % 16 || ch % 16)
    fail("the window (" + num(top) + ", " + num(left) + ", " + num(bottom) +
         ", " + num(right) + ") does not make whole macroblocks");
  mbw = (int)(cw / 16);
  mbh = (int)(ch / 16);
  // every macroblock takes at least a bit of every plane's DC
  if ((double)mbw * mbh > 8.0 * n || (double)cw * ch > (double)(1 << 28))
    fail("the codestream is too short for an image of " + num(width) +
         " x " + num(height));
  tx.assign(1, 0);
  for (long v : tw) tx.push_back(tx.back() + (int)v);
  ty.assign(1, 0);
  for (long v : th) ty.push_back(ty.back() + (int)v);
  for (size_t i = 1; i < tx.size(); ++i)
    if (tx[i] <= tx[i - 1] || tx[i] >= mbw)
      fail("a tile width of 0 or past the image");
  for (size_t i = 1; i < ty.size(); ++i)
    if (ty[i] <= ty[i - 1] || ty[i] >= mbh)
      fail("a tile height of 0 or past the image");
  tx.push_back(mbw);
  ty.push_back(mbh);
  b.align();
  nplanes = alpha ? 2 : 1;
  for (int p = 0; p < nplanes; ++p) {
    planes[p].im = this;
    planes[p].read_header(b, depth, mbw * mbh);
  }
  if (out_fmt == YONLY && planes[0].fmt != YONLY)
    fail(std::string("INTERNAL_CLR_FMT ") + kInternalName[planes[0].fmt] +
         " with OUTPUT_CLR_FMT YONLY");
  if (out_fmt != YONLY && planes[0].fmt == YONLY)
    fail("INTERNAL_CLR_FMT YONLY with OUTPUT_CLR_FMT RGB");
  if (alpha && planes[1].fmt != YONLY)
    fail(std::string("an alpha image plane of INTERNAL_CLR_FMT ") +
         kInternalName[planes[1].fmt]);
  size_t ntiles = (tx.size() - 1) * (ty.size() - 1);
  int minb = planes[0].bands;
  if (alpha) minb = std::min(minb, planes[1].bands);
  size_t nbands = frequency ? 4 - minb : 1;
  if (!index && (frequency || ntiles > 1))
    fail("INDEX_TABLE_PRESENT_FLAG 0 with frequency order or several tiles");
  offsets.clear();
  if (index) {
    uint32_t start = b.get(16);
    if (start != 1) fail("an INDEX_TABLE_STARTCODE of " + num(start));
    if (ntiles * nbands > 8 * n) fail("an index table past the codestream");
    for (size_t i = 0; i < ntiles * nbands; ++i) offsets.push_back(vlw_esc(b));
  }
  uint64_t skip = vlw_esc(b);
  b.align();
  if (b.byte() + skip > n) fail("SUBSEQUENT_BYTES past the codestream");
  data_start = b.byte() + skip;
  if (!index) offsets.assign(1, 0);
  std::vector<uint64_t> sorted = offsets;
  std::sort(sorted.begin(), sorted.end());
  if (std::adjacent_find(sorted.begin(), sorted.end()) != sorted.end())
    fail("two tile packets at one offset of the index table");
}

void Plane::read_header(Bits& b, int depth, int mbs) {
  fmt = b.get(3);
  if (fmt > YUV444)
    fail(std::string("INTERNAL_CLR_FMT ") + kInternalName[fmt] +
         " is not supported");
  scaled = !b.bit();
  bands = b.get(4);
  if (bands > DCONLY) fail("BANDS_PRESENT " + num(bands) + " is reserved");
  // CHROMA_CENTERING_X/Y and reserved bits: chroma is upsampled one way
  if (fmt != YONLY) b.get(8);
  if (depth == BD16) shift_bits = b.get(8);
  if (shift_bits > 15) fail("SHIFT_BITS " + num(shift_bits) + " past 15");
  nch = fmt == YONLY ? 1 : 3;
  for (int c = 1; c < nch; ++c) {
    bh[c] = fmt == YUV420 ? 2 : 4;
    bw[c] = fmt == YUV444 ? 4 : 2;
    nlp[c] = (int)nblocks(c);
  }
  dc_uniform = b.bit();
  if (dc_uniform) dcq = read_quant(b, nch, scaled, true);
  lp_use_dc = hp_use_lp = true;
  lp_uniform = hp_uniform = false;
  if (bands != DCONLY) {
    lp_use_dc = b.bit();
    if (!lp_use_dc) {
      lp_uniform = b.bit();
      if (lp_uniform) lpq = read_quant(b, nch, scaled, true);
    }
    if (bands < NOHIGHPASS) {
      hp_use_lp = b.bit();
      if (!hp_use_lp) {
        hp_uniform = b.bit();
        if (hp_uniform) hpq = read_quant(b, nch, scaled, false);
      }
    }
  }
  lp_tile = (!lp_use_dc && !lp_uniform) || (lp_use_dc && !dc_uniform);
  hp_tile = (!hp_use_lp && !hp_uniform) || (hp_use_lp && lp_tile);
  b.align();
  for (int c = 0; c < nch; ++c) {
    lp[c].alloc((size_t)mbs * nlp[c]);
    hp[c].alloc((size_t)mbs * nblocks(c) * 16);
    cbp[c].assign((size_t)mbs * nblocks(c), 0);
  }
  lpidx.assign(mbs, 0);
  hpidx.assign(mbs, 0);
  kh.assign((size_t)mbs * 2, 0);
}

void Plane::tile_header(Bits& b, int t, char which) {
  if ((int)tq.size() <= t) tq.resize(t + 1);
  TileQuant& q = tq[t];
  if (which == 'd') {
    q.dc = dc_uniform ? dcq : read_quant(b, nch, scaled, true);
  } else if (which == 'l' && bands != DCONLY) {
    q.lp.clear();
    bool use = lp_tile ? b.bit() : lp_use_dc;
    if (use) {
      q.lp.push_back(q.dc);
    } else if (!lp_tile) {
      q.lp.push_back(lpq);
    } else {
      int n = b.get(4) + 1;
      for (int i = 0; i < n; ++i)
        q.lp.push_back(read_quant(b, nch, scaled, true));
    }
  } else if (which == 'h' && bands < NOHIGHPASS) {
    q.hp.clear();
    bool use = hp_tile ? b.bit() : hp_use_lp;
    q.hp_uses_lp = use;
    if (use) {
      q.hp = q.lp;
    } else if (!hp_tile) {
      q.hp.push_back(hpq);
    } else {
      int n = b.get(4) + 1;
      for (int i = 0; i < n; ++i)
        q.hp.push_back(read_quant(b, nch, scaled, false));
    }
  }
}

void Plane::reset() {
  const Alphabets& A = alphabets();
  const Scans& S = scans();
  for (int c = 0; c < 2; ++c) {
    dcl[c].init(A.a7);
    cbpq[c].init(A.a5);
  }
  lpt.init();
  hpt.init();
  for (int k = 0; k < 3; ++k) model[k].init(k);
  lps[0].init(S.lp16, 15);
  for (int c = 1; c < nch; ++c) {
    if (nlp[c] == 16)
      lps[c].init(S.lp16, 15);
    else if (nlp[c] == 8)
      lps[c].init(S.lp8, 7);
    else
      lps[c].init(S.lp4, 3);
  }
  hps[0].init(S.horiz, 15);
  hps[1].init(S.vert, 15);
}

uint8_t get_index(Bits& b, int n) {
  int k = qbits(n);
  if (!k) return 0;
  int i = b.bit() ? (int)b.get(k) + 1 : 0;
  if (i >= n) fail("a quantizer index " + num(i) + " of " + num(n));
  return (uint8_t)i;
}

void Plane::mb_indices(Bits& b, int t, size_t mb, bool lp_, bool hp_) {
  const TileQuant& q = tq[t];
  if (lp_ && bands != DCONLY) lpidx[mb] = get_index(b, (int)q.lp.size());
  if (hp_ && bands < NOHIGHPASS && !q.hp_uses_lp)
    hpidx[mb] = get_index(b, (int)q.hp.size());
}

int Plane::dc_mode(int my, int mx, int t0y, int t0x) const {
  bool left = mx > t0x, top = my > t0y;
  if (!left && !top) return 0;
  if (!top) return 1;
  if (!left) return 2;
  int W = im->mbw;
  long sh = 0, sv = 0;
  int cs = fmt == YUV444 ? nch : 1;
  for (int c = 0; c < cs; ++c) {
    long tl = lp[c][((size_t)(my - 1) * W + mx - 1) * nlp[c]];
    long l = lp[c][((size_t)my * W + mx - 1) * nlp[c]];
    long t = lp[c][((size_t)(my - 1) * W + mx) * nlp[c]];
    sh += std::labs(tl - l);
    sv += std::labs(tl - t);
  }
  if (sh * 4 < sv) return 2;
  if (sv * 4 < sh) return 1;
  return 3;
}

inline int32_t signed_mag(uint32_t mag, bool neg) {
  return neg ? (int32_t)(0u - mag) : (int32_t)mag;
}

void Plane::decode_dc(Bits& b, int my, int mx, int t0y, int t0x) {
  int mode = dc_mode(my, mx, t0y, t0x);
  int W = im->mbw;
  size_t mb = (size_t)my * W + mx;
  bool nz[3];
  for (int c = 0; c < nch; ++c) nz[c] = b.bit();
  for (int c = 0; c < nch; ++c) {
    int k = model[0].bits[cls(c)];
    uint32_t hi = nz[c] ? get_level(b, dcl[cls(c)]) - 1 : 0;
    uint32_t mag = (hi << k) | b.get(k);
    int32_t r = signed_mag(mag, mag && b.bit());
    int32_t pred = 0;
    const Buf& L = lp[c];
    int n = nlp[c];
    if (mode == 1) {
      pred = L[(mb - 1) * n];
    } else if (mode == 2) {
      pred = L[(mb - W) * n];
    } else if (mode == 3) {
      pred = (int32_t)(((int64_t)L[(mb - 1) * n] + L[(mb - W) * n]) >> 1);
    }
    lp[c][mb * n] = r + pred;
  }
  int chroma = 0;
  for (int c = 1; c < nch; ++c) chroma += nz[c];
  model[0].update(fmt, nch, nz[0], chroma);
  dcl[0].adapt();
  dcl[1].adapt();
}

const int* row_slots(int n, int* count) {
  *count = n == 16 ? 3 : 1;
  return n == 16 ? kRow16 : (n == 8 ? kRow8 : kRow4);
}

const int* col_slots(int n, int* count) {
  *count = n == 16 ? 3 : (n == 8 ? 2 : 1);
  return n == 16 ? kCol16 : (n == 8 ? kCol8 : kCol4);
}

void Plane::decode_lp(Bits& b, int my, int mx, int t0y, int t0x) {
  int mode = dc_mode(my, mx, t0y, t0x);
  int W = im->mbw;
  size_t mb = (size_t)my * W + mx;
  bool nz[3];
  for (int c = 0; c < nch; ++c) nz[c] = b.bit();
  int32_t v[3][16] = {};
  int lap[2] = {0, 0};
  for (int c = 0; c < nch; ++c) {
    int n = nlp[c] - 1;
    int32_t vscan[15] = {};
    if (nz[c]) lap[cls(c)] += get_block(b, lpt, cls(c), n, vscan);
    for (int i = 0; i < n; ++i) v[c][lps[c].slot[i]] = vscan[i];
    lps[c].update(vscan);
  }
  for (int c = 0; c < nch; ++c) {
    int n = nlp[c], k = model[1].bits[cls(c)];
    int32_t* L = &lp[c][mb * n];
    for (int s = 1; s < n; ++s) {
      uint32_t lo = b.get(k);
      int32_t V = v[c][s];
      uint32_t mag = ((uint32_t)std::abs((long)V) << k) + lo;
      bool neg = V ? V < 0 : (lo && b.bit());
      L[s] = signed_mag(mag, neg);
    }
    int cnt;
    if (mode == 1 && lpidx[mb - 1] == lpidx[mb]) {
      const int* sl = col_slots(n, &cnt);
      for (int i = 0; i < cnt; ++i) L[sl[i]] += lp[c][(mb - 1) * n + sl[i]];
    } else if (mode == 2 && lpidx[mb - W] == lpidx[mb]) {
      const int* sl = row_slots(n, &cnt);
      for (int i = 0; i < cnt; ++i) L[sl[i]] += lp[c][(mb - W) * n + sl[i]];
    }
  }
  model[1].update(fmt, nch, lap[0], lap[1]);
  lpt.adapt();
}

// a set of four flags: how many (an adaptive 5-symbol table, or the fixed
// 4-symbol one when the set cannot be empty), then which
int get_set(Bits& b, Adaptive* tab) {
  static const int pairs[6] = {0x3, 0x5, 0x9, 0x6, 0xA, 0xC};
  int k = tab ? tab->get(b) : huff(b, alphabets().a4.tab[0]) + 1;
  if (k == 0) return 0;
  if (k == 1) return 1 << b.get(2);
  if (k == 2) {
    int i = b.get(3);
    if (i > 5) fail("a coded block pattern of " + num(i));
    return pairs[i];
  }
  if (k == 3) return 0xF ^ (1 << b.get(2));
  return 0xF;
}

void Plane::cbp_decode(Bits& b, int c, int my, int mx, int t0y, int t0x) {
  int W = im->mbw, bhc = bh[c], bwc = bw[c];
  size_t mb = (size_t)my * W + mx, nb = nblocks(c);
  int nq = (int)nb / 4, mask;
  if (nq == 1) {
    mask = b.bit();
  } else if (nq == 2) {
    mask = 0;
    if (b.bit()) mask = b.bit() ? 3 : 1 << b.get(1);
  } else {
    mask = get_set(b, &cbpq[cls(c)]);
  }
  uint8_t diff[16] = {};
  int q = 0;
  for (int qy = 0; qy < bhc / 2; ++qy)
    for (int qx = 0; qx < bwc / 2; ++qx, ++q) {
      if (!(mask >> q & 1)) continue;
      int pat = get_set(b, nullptr);
      for (int i = 0; i < 4; ++i)
        diff[(2 * qy + i / 2) * bwc + 2 * qx + i % 2] = pat >> i & 1;
    }
  uint8_t* bits = &cbp[c][mb * nb];
  for (size_t k = 0; k < nb; ++k) {
    int r = (int)k / bwc, col = (int)k % bwc, pred;
    if (col) {
      pred = bits[k - 1];
    } else if (mx > t0x) {
      pred = cbp[c][(mb - 1) * nb + r * bwc + bwc - 1];
    } else if (r) {
      pred = bits[k - bwc];
    } else if (my > t0y) {
      pred = cbp[c][(mb - W) * nb + (bhc - 1) * bwc];
    } else {
      pred = 0;
    }
    bits[k] = diff[k] ^ pred;
  }
}

void Plane::decode_hp(Bits& b, int my, int mx, int t0y, int t0x) {
  int W = im->mbw;
  size_t mb = (size_t)my * W + mx;
  const int32_t* L = &lp[0][mb * 16];
  long er = 0, ec = 0;
  for (int i = 0; i < 3; ++i) {
    er += std::labs((long)L[kRow16[i]]);
    ec += std::labs((long)L[kCol16[i]]);
  }
  int mode = er * 4 < ec ? 1 : (ec * 4 < er ? 2 : 0);
  Scan& scan = hps[mode == 1 ? 1 : 0];
  for (int c = 0; c < nch; ++c) cbp_decode(b, c, my, mx, t0y, t0x);
  int lap[2] = {0, 0};
  for (int c = 0; c < nch; ++c) {
    size_t nb = nblocks(c);
    for (size_t k = 0; k < nb; ++k) {
      int32_t* H = &hp[c][(mb * nb + k) * 16];
      int32_t vscan[15] = {};
      if (cbp[c][mb * nb + k])
        lap[cls(c)] += get_block(b, hpt, cls(c), 15, vscan);
      H[0] = 0;
      for (int i = 0; i < 15; ++i) H[scan.slot[i]] = vscan[i];
      scan.update(vscan);
    }
  }
  kh[mb * 2] = (uint8_t)model[2].bits[0];
  kh[mb * 2 + 1] = (uint8_t)model[2].bits[1];
  model[2].update(fmt, nch, lap[0], lap[1]);
  hpt.adapt();
  cbpq[0].adapt();
  cbpq[1].adapt();
}

// FLEXBITS (or none, b null): the HP values become residuals, each with
// its model bits' refinement (less the trimmed bits) below it
void Plane::decode_flex(Bits* b, int my, int mx) {
  size_t mb = (size_t)my * im->mbw + mx;
  for (int c = 0; c < nch; ++c) {
    int k = kh[mb * 2 + cls(c)], n = b ? k - trim : 0;
    size_t nb = nblocks(c);
    for (size_t blk = 0; blk < nb; ++blk) {
      int32_t* H = &hp[c][(mb * nb + blk) * 16];
      for (int s = 1; s < 16; ++s) {
        uint32_t lo = n > 0 ? b->get(n) : 0;
        int32_t V = H[s];
        uint32_t mag = ((uint32_t)std::abs((long)V) << k) +
                       (n > 0 ? lo << trim : 0);
        bool neg = V ? V < 0 : (lo && b->bit());
        H[s] = signed_mag(mag, neg);
      }
    }
  }
  reconstruct_hp(my, mx);
}

void Plane::reconstruct_hp(int my, int mx) {
  size_t mb = (size_t)my * im->mbw + mx;
  const int32_t* L = &lp[0][mb * 16];
  long er = 0, ec = 0;
  for (int i = 0; i < 3; ++i) {
    er += std::labs((long)L[kRow16[i]]);
    ec += std::labs((long)L[kCol16[i]]);
  }
  int mode = er * 4 < ec ? 1 : (ec * 4 < er ? 2 : 0);
  if (!mode) return;
  for (int c = 0; c < nch; ++c) {
    size_t nb = nblocks(c);
    int bwc = bw[c];
    for (size_t k = 0; k < nb; ++k) {
      int32_t* H = &hp[c][(mb * nb + k) * 16];
      if (mode == 1 && k % bwc) {
        const int32_t* P = H - 16;
        for (int s : kCol16) H[s] += P[s];
      } else if (mode == 2 && k >= (size_t)bwc) {
        const int32_t* P = H - 16 * bwc;
        for (int s : kRow16) H[s] += P[s];
      }
    }
  }
}

// ------------------------------------------------------------ tiles

// Tile packet k spans from its offset to the next packet's offset, or to
// the codestream's end. Its reader stops at that end, and end_packet
// refuses a packet that leaves more than the padding to a whole byte
// unread: a stream read with another syntax than it was written with
// raises here instead of decoding on into the next packet's bytes.
Bits packet(const uint8_t* src, size_t n, const Image& im, size_t k) {
  if (im.offsets[k] > n || im.data_start + im.offsets[k] + 4 > n)
    fail("a tile packet past the codestream");
  uint64_t off = im.data_start + im.offsets[k], end = n;
  for (uint64_t o : im.offsets)
    if (o <= n && im.data_start + o > off)
      end = std::min(end, im.data_start + o);
  const uint8_t* p = src + off;
  if (p[0] || p[1] || p[2] != 1) fail("a tile packet without its start code");
  Bits b(p, end - off);
  b.pos = 32;
  b.past = "a tile packet read past its end (the next packet's offset)";
  return b;
}

void end_packet(const Bits& b, size_t k) {
  if (b.nbits - b.pos >= 8)
    fail("tile packet " + num(k) + " ends " + num((b.nbits - b.pos) / 8) +
         " bytes before the next packet's offset");
}

void decode_tiles(const uint8_t* src, size_t n, Image& im) {
  size_t ncol = im.tx.size() - 1, nrow = im.ty.size() - 1;
  int minb = im.planes[0].bands;
  if (im.alpha) minb = std::min(minb, im.planes[1].bands);
  size_t nbands = im.frequency ? 4 - minb : 1;
  for (size_t j = 0; j < nrow; ++j)
    for (size_t i = 0; i < ncol; ++i) {
      int t = (int)(j * ncol + i);
      int t0x = im.tx[i], t0y = im.ty[j];
      for (int p = 0; p < im.nplanes; ++p) {
        im.planes[p].reset();
        im.planes[p].trim = 0;
      }
      auto each_mb = [&](auto fn) {
        for (int my = im.ty[j]; my < im.ty[j + 1]; ++my)
          for (int mx = im.tx[i]; mx < im.tx[i + 1]; ++mx)
            for (int p = 0; p < im.nplanes; ++p) fn(im.planes[p], my, mx);
      };
      if (!im.frequency) {
        Bits b = packet(src, n, im, t);
        int trim = im.trim_flag ? (int)b.get(4) : 0;
        for (int p = 0; p < im.nplanes; ++p) {
          Plane& pl = im.planes[p];
          pl.trim = trim;
          pl.tile_header(b, t, 'd');
          pl.tile_header(b, t, 'l');
          pl.tile_header(b, t, 'h');
        }
        each_mb([&](Plane& pl, int my, int mx) {
          size_t mb = (size_t)my * im.mbw + mx;
          pl.mb_indices(b, t, mb, true, true);
          if (pl.bands < NOHIGHPASS && pl.tq[t].hp_uses_lp)
            pl.hpidx[mb] = pl.lpidx[mb];
          pl.decode_dc(b, my, mx, t0y, t0x);
          if (pl.bands != DCONLY) pl.decode_lp(b, my, mx, t0y, t0x);
          if (pl.bands < NOHIGHPASS) {
            pl.decode_hp(b, my, mx, t0y, t0x);
            pl.decode_flex(pl.bands == ALL ? &b : nullptr, my, mx);
          }
        });
        end_packet(b, t);
        continue;
      }
      Bits bs[4];
      for (size_t k = 0; k < nbands; ++k)
        bs[k] = packet(src, n, im, t * nbands + k);
      int trim = nbands == 4 && im.trim_flag ? (int)bs[3].get(4) : 0;
      for (int p = 0; p < im.nplanes; ++p) {
        Plane& pl = im.planes[p];
        pl.trim = trim;
        pl.tile_header(bs[0], t, 'd');
        if (nbands > 1) pl.tile_header(bs[1], t, 'l');
        if (nbands > 2) pl.tile_header(bs[2], t, 'h');
      }
      each_mb([&](Plane& pl, int my, int mx) {
        pl.decode_dc(bs[0], my, mx, t0y, t0x);
      });
      each_mb([&](Plane& pl, int my, int mx) {
        if (nbands > 1 && pl.bands != DCONLY) {
          pl.mb_indices(bs[1], t, (size_t)my * im.mbw + mx, true, false);
          pl.decode_lp(bs[1], my, mx, t0y, t0x);
        }
      });
      each_mb([&](Plane& pl, int my, int mx) {
        if (nbands > 2 && pl.bands < NOHIGHPASS) {
          size_t mb = (size_t)my * im.mbw + mx;
          pl.mb_indices(bs[2], t, mb, false, true);
          if (pl.tq[t].hp_uses_lp) pl.hpidx[mb] = pl.lpidx[mb];
          pl.decode_hp(bs[2], my, mx, t0y, t0x);
        }
      });
      each_mb([&](Plane& pl, int my, int mx) {
        if (pl.bands < NOHIGHPASS)
          pl.decode_flex(nbands > 3 && pl.bands == ALL ? &bs[3] : nullptr,
                         my, mx);
      });
      for (size_t k = 0; k < nbands; ++k) end_packet(bs[k], t * nbands + k);
    }
}

// -------------------------------------------------------- the output

std::vector<Region> regions(const Image& im, int uh, int uw) {
  std::vector<Region> r;
  if (!im.hard) {
    r.push_back({0, im.mbh * uh, 0, im.mbw * uw});
    return r;
  }
  for (size_t j = 0; j + 1 < im.ty.size(); ++j)
    for (size_t i = 0; i + 1 < im.tx.size(); ++i)
      r.push_back({im.ty[j] * uh, im.ty[j + 1] * uh, im.tx[i] * uw,
                   im.tx[i + 1] * uw});
  return r;
}

// dequantization and the inverse transforms of each channel, into
// planes of the coded size (chroma at its own resolution)
void Plane::output(Buf chans[3], const std::vector<int>& tile) {
  const Image& I = *im;
  int W = I.mbw, H = I.mbh;
  for (int c = 0; c < nch; ++c) {
    int bhc = bh[c], bwc = bw[c], n = nlp[c];
    size_t nb = nblocks(c);
    size_t dw = (size_t)W * bwc, dh = (size_t)H * bhc;
    Buf dcimg;
    dcimg.alloc(dw * dh);
    for (int my = 0; my < H; ++my)
      for (int mx = 0; mx < W; ++mx) {
        size_t mb = (size_t)my * W + mx;
        const TileQuant& q = tq[tile[mb]];
        int32_t p[16], x[16];
        const int32_t* L = &lp[c][mb * n];
        p[0] = L[0] * q.dc.step[c];
        if (bands != DCONLY) {
          int32_t st = q.lp[lpidx[mb]].step[c];
          for (int s = 1; s < n; ++s) p[s] = L[s] * st;
        } else {
          for (int s = 1; s < n; ++s) p[s] = 0;
        }
        if (n == 16)
          ict4(p, x);
        else if (n == 8)
          ict422(p, x);
        else
          ict420(p, x);
        for (int r = 0; r < bhc; ++r)
          for (int k = 0; k < bwc; ++k)
            dcimg[((size_t)my * bhc + r) * dw + (size_t)mx * bwc + k] =
                x[r * bwc + k];
      }
    if (I.overlap == 2)
      post_filter(dcimg.data(), dw, regions(I, bhc, bwc), bhc, bwc,
                  bhc == 4 ? 2 : 1, bwc == 4 ? 2 : 1);
    size_t pw = dw * 4, ph = dh * 4;
    Buf& out = chans[c];
    out.alloc(pw * ph);
    for (int my = 0; my < H; ++my)
      for (int mx = 0; mx < W; ++mx) {
        size_t mb = (size_t)my * W + mx;
        bool has_hp = bands < NOHIGHPASS;
        int32_t st = has_hp ? tq[tile[mb]].hp[hpidx[mb]].step[c] : 0;
        for (size_t k = 0; k < nb; ++k) {
          int r = (int)k / bwc, col = (int)k % bwc;
          size_t by = (size_t)my * bhc + r, bx = (size_t)mx * bwc + col;
          int32_t p[16] = {}, x[16];
          p[0] = dcimg[by * dw + bx];
          if (has_hp) {
            const int32_t* Hc = &hp[c][(mb * nb + k) * 16];
            for (int s = 1; s < 16; ++s) p[s] = Hc[s] * st;
          }
          ict4(p, x);
          for (int yy = 0; yy < 4; ++yy)
            std::memcpy(&out[(by * 4 + yy) * pw + bx * 4], x + 4 * yy,
                        4 * sizeof(int32_t));
        }
      }
    if (I.overlap >= 1)
      post_filter(out.data(), pw, regions(I, 4 * bhc, 4 * bwc), 4, 4, 2, 2);
  }
}

// chroma at even positions, odd ones the rounded mean of their
// neighbours (the last repeated)
Buf upsample(const Buf& c, size_t w, size_t h, bool vertical) {
  Buf o;
  o.alloc(w * h * 2);
  if (vertical) {
    for (size_t y = 0; y < h; ++y) {
      const int32_t* a = &c[y * w];
      const int32_t* b = &c[std::min(y + 1, h - 1) * w];
      for (size_t x = 0; x < w; ++x) {
        o[2 * y * w + x] = a[x];
        o[(2 * y + 1) * w + x] = (a[x] + b[x] + 1) >> 1;
      }
    }
  } else {
    for (size_t y = 0; y < h; ++y) {
      const int32_t* a = &c[y * w];
      int32_t* r = &o[y * w * 2];
      for (size_t x = 0; x < w; ++x) {
        r[2 * x] = a[x];
        r[2 * x + 1] = (a[x] + a[std::min(x + 1, w - 1)] + 1) >> 1;
      }
    }
  }
  return o;
}

template <typename T>
void write_out(const Image& im, Buf planes[4], int nout,
               const bool* scaled, int sb, T* dst) {
  int cw = im.mbw * 16;
  int off = (im.depth == BD8 ? 128 : 32768) >> sb;
  int hi = (im.depth == BD8 ? 255 : 65535) >> sb;
  for (int y = 0; y < im.height; ++y)
    for (int x = 0; x < im.width; ++x) {
      size_t at = (size_t)(y + im.top) * cw + x + im.left;
      for (int c = 0; c < nout; ++c) {
        int32_t v = planes[c][at];
        if (scaled[c]) v = (v + 4) >> 3;
        v += off;
        v = std::min(std::max(v, 0), hi);
        dst[((size_t)y * im.width + x) * nout + c] = (T)(v << sb);
      }
    }
}

void decode(const uint8_t* src, size_t n, void* dst, size_t dst_bytes) {
  Image im;
  im.read_header(src, n);
  size_t bytes = (size_t)im.width * im.height * im.channels() *
                 (im.depth == BD8 ? 1 : 2);
  if (bytes != dst_bytes) fail("the output buffer is of another size");
  decode_tiles(src, n, im);
  std::vector<int> tile((size_t)im.mbw * im.mbh);
  for (size_t j = 0; j + 1 < im.ty.size(); ++j)
    for (size_t i = 0; i + 1 < im.tx.size(); ++i)
      for (int my = im.ty[j]; my < im.ty[j + 1]; ++my)
        for (int mx = im.tx[i]; mx < im.tx[i + 1]; ++mx)
          tile[(size_t)my * im.mbw + mx] =
              (int)(j * (im.tx.size() - 1) + i);
  Buf out[4];
  bool scaled[4];
  Plane& P = im.planes[0];
  Buf ch[3];
  P.output(ch, tile);
  size_t cw = (size_t)im.mbw * 16, chh = (size_t)im.mbh * 16;
  int nout;
  if (P.fmt == YONLY) {
    out[0] = std::move(ch[0]);
    nout = 1;
  } else {
    for (int c = 1; c < 3; ++c) {
      size_t w = cw / (P.fmt == YUV444 ? 1 : 2);
      if (P.fmt == YUV420) ch[c] = upsample(ch[c], w, chh / 2, true);
      if (P.fmt != YUV444) ch[c] = upsample(ch[c], w, chh, false);
    }
    for (int c = 0; c < 3; ++c) out[c].alloc(cw * chh);
    for (size_t k = 0; k < cw * chh; ++k) {
      int32_t r = -ch[1][k], g = ch[0][k], b = ch[2][k];
      g -= r >> 1;
      r -= ((b + 1) >> 1) - g;
      b += r;
      out[0][k] = r;
      out[1][k] = g;
      out[2][k] = b;
    }
    nout = 3;
  }
  for (int c = 0; c < nout; ++c) scaled[c] = P.scaled;
  if (im.alpha) {
    Buf a[3];
    im.planes[1].output(a, tile);
    out[nout] = std::move(a[0]);
    scaled[nout] = im.planes[1].scaled;
    ++nout;
  }
  if (im.depth == BD8)
    write_out(im, out, nout, scaled, 0, (uint8_t*)dst);
  else
    write_out(im, out, nout, scaled, P.shift_bits, (uint16_t*)dst);
}

void put_err(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg);
}

}  // namespace

extern "C" {

int jxr_info(const uint8_t* src, long n, int32_t* dims, char* err,
             int errlen) {
  try {
    if (n < 0) fail("a negative size");
    Image im;
    im.read_header(src, (size_t)n);
    dims[0] = im.height;
    dims[1] = im.width;
    dims[2] = im.channels();
    dims[3] = im.depth == BD8 ? 1 : 2;
    return 0;
  } catch (const std::exception& e) {
    put_err(err, errlen, e.what());
    return -1;
  }
}

int jxr_decode(const uint8_t* src, long n, void* dst, long dst_bytes,
               char* err, int errlen) {
  try {
    if (n < 0 || dst_bytes < 0) fail("a negative size");
    decode(src, (size_t)n, dst, (size_t)dst_bytes);
    return 0;
  } catch (const std::exception& e) {
    put_err(err, errlen, e.what());
    return -1;
  }
}

}  // extern "C"
