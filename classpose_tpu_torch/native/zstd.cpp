// Zstandard frame decoder (RFC 8878) for the CZI reader: frames with and
// without a content size, skippable frames, raw, RLE and compressed blocks,
// raw, RLE, Huffman (1 and 4 streams) and treeless literals, predefined,
// RLE, FSE and repeat sequence tables carried from block to block, repeat
// offsets and the XXH64 content checksum (checked). A dictionary is
// refused. Every read is bounds-checked: a corrupt or truncated frame
// raises where libzstd's streaming decoder (python-zstandard's
// decompressobj) raises, and no byte outside the input is read.
//
// C interface (ctypes releases the GIL around each call):
//   long zstd_decompress(src, n, dst, cap, out, err, errlen)
//     decodes every frame of src; into dst (cap bytes) when dst is not
//     null, else into a buffer it allocates and returns through *out (free
//     it with zstd_free). Returns the decoded size, or -1 with a message in
//     err.
//   void zstd_free(void*)

#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw Error(what); }

const uint32_t kMagic = 0xFD2FB528u;
const size_t kBlockMax = 128 * 1024;
const uint64_t kWindowLimit = 1ull << 27;  // libzstd's default decoder limit
const int kWindowLogMax = 31;

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}
uint64_t rd64(const uint8_t* p) {
  return rd32(p) | ((uint64_t)rd32(p + 4) << 32);
}

// --------------------------------------------------------------- output

struct Out {
  uint8_t* buf = nullptr;
  size_t len = 0, cap = 0;
  bool grow = false;

  void need(size_t n) {
    if (len + n <= cap && buf) return;
    if (!grow) fail("the decoded data is larger than its buffer");
    size_t c = cap ? cap : 1 << 16;
    while (c < len + n) c *= 2;
    uint8_t* p = (uint8_t*)realloc(buf, c);
    if (!p) fail("out of memory");
    buf = p;
    cap = c;
  }
};

// --------------------------------------------------------------- XXH64

const uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
               P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
               P5 = 0x27D4EB2F165667C5ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  acc += in * P2;
  return rotl(acc, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  acc ^= xround(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = P5;
  }
  h += n;
  while (p + 8 <= end) {
    h ^= xround(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)rd32(p) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------ backward bitstream

// Read from the end towards the start; the last byte's highest set bit
// marks where the stream begins. Bits before the start read as zeros and
// make `left` negative (an overflow).
struct BackBits {
  const uint8_t* p;
  size_t n;
  int64_t left;  // bits not yet read

  void init(const uint8_t* src, size_t size) {
    if (size == 0) fail("an empty bitstream");
    uint8_t last = src[size - 1];
    if (last == 0) fail("a bitstream without its end marker");
    p = src;
    n = size;
    left = (int64_t)size * 8 - (8 - highbit(last));
  }
  // the next k (<= 56) bits without consuming them
  inline uint64_t peek(int k) const {
    if (k == 0) return 0;
    int64_t lo = left - k;
    if (lo >= 0) {
      size_t byte = (size_t)(lo >> 3);
      uint64_t w;
      if (byte + 8 <= n) {
        w = rd64(p + byte);
      } else {
        w = 0;
        for (size_t i = 0; byte + i < n && i < 8; i++)
          w |= (uint64_t)p[byte + i] << (8 * i);
      }
      return (w >> (lo & 7)) & ((1ull << k) - 1);
    }
    // some bits lie before the start: they are zeros
    if (left <= 0) return 0;
    uint64_t w = 0;
    for (size_t i = 0; i < 8 && i < n; i++) w |= (uint64_t)p[i] << (8 * i);
    w &= (left >= 64) ? ~0ull : ((1ull << left) - 1);
    return w << (-lo);
  }
  inline uint64_t read(int k) {
    uint64_t v = peek(k);
    left -= k;
    return v;
  }
};

// ---------------------------------------------------------------- FSE

struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct Fse {
  int log = 0;
  FseEntry t[1 << 9];
};

// FSE_readNCount: the normalised counts of a table description starting
// at src; returns the bytes it took.
size_t read_ncount(const uint8_t* src, size_t size, int max_log, int max_sym,
                   int16_t* norm, int* nsym, int* log_out) {
  // a forward bit reader that reads zeros past the end
  auto bit = [&](size_t pos, int k) -> uint32_t {
    uint32_t v = 0;
    for (int i = 0; i < k; i++) {
      size_t b = pos + i;
      if ((b >> 3) < size && (src[b >> 3] >> (b & 7)) & 1) v |= 1u << i;
    }
    return v;
  };
  if (size == 0) fail("an empty FSE table description");
  size_t pos = 0;
  int log = bit(pos, 4) + 5;
  pos += 4;
  if (log > 15) fail("an FSE table log above 15");
  if (log > max_log) fail("an FSE table log above its maximum");
  for (int i = 0; i <= max_sym; i++) norm[i] = 0;
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int sym = 0;
  bool prev0 = false;
  for (;;) {
    if (prev0) {
      for (;;) {
        uint32_t r = bit(pos, 2);
        pos += 2;
        sym += r;
        if (r != 3) break;
      }
      if (sym >= max_sym + 1) break;
    }
    int mx = (2 * threshold - 1) - remaining;
    uint32_t v = bit(pos, nbits);
    int count;
    if ((int)(v & (threshold - 1)) < mx) {
      count = v & (threshold - 1);
      pos += nbits - 1;
    } else {
      count = v & (2 * threshold - 1);
      if (count >= threshold) count -= mx;
      pos += nbits;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = (int16_t)count;
    prev0 = count == 0;
    if (remaining < threshold) {
      if (remaining <= 1) break;
      nbits = highbit(remaining) + 1;
      threshold = 1 << (nbits - 1);
    }
    if (sym >= max_sym + 1) break;
  }
  if (remaining != 1) fail("an FSE table description that does not sum up");
  if (sym > max_sym + 1) fail("an FSE table with too many symbols");
  size_t used = (pos + 7) >> 3;
  if (used > size) fail("a truncated FSE table description");
  *nsym = sym;
  *log_out = log;
  return used;
}

// FSE_buildDTable: spread the symbols, "less than 1" ones at the top.
void build_fse(Fse& f, const int16_t* norm, int nsym, int log) {
  int size = 1 << log, high = size - 1;
  uint16_t next[256];
  f.log = log;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] == -1) {
      f.t[high--].symbol = (uint16_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint16_t)norm[s];
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; s++) {
    for (int i = 0; i < norm[s]; i++) {
      f.t[pos].symbol = (uint16_t)s;
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail("an FSE table that does not spread");
  for (int u = 0; u < size; u++) {
    int s = f.t[u].symbol;
    uint32_t ns = next[s]++;
    int nb = log - highbit(ns);
    f.t[u].bits = (uint8_t)nb;
    f.t[u].base = (uint16_t)((ns << nb) - size);
  }
}

void build_rle(Fse& f, int symbol) {
  f.log = 0;
  f.t[0] = {(uint16_t)symbol, 0, 0};
}

// ------------------------------------------------------------- Huffman

struct Huf {
  int bits = 0;  // the table's log, 0 when there is none
  uint8_t sym[1 << 12];
  uint8_t len[1 << 12];
};

const int kHufLogMax = 12;  // libzstd's limit (RFC 8878 writes at most 11)

// The tree description at src (the literals section's compressed part);
// returns the bytes it took.
size_t read_huffman(Huf& h, const uint8_t* src, size_t size) {
  if (size == 0) fail("an empty Huffman tree description");
  uint8_t w[256];
  int nw = 0;
  size_t used;
  int head = src[0];
  if (head >= 128) {
    nw = head - 127;
    size_t nb = (nw + 1) / 2;
    if (nb + 1 > size) fail("a truncated Huffman tree description");
    for (int i = 0; i < nw; i += 2) {
      w[i] = src[1 + i / 2] >> 4;
      if (i + 1 < nw) w[i + 1] = src[1 + i / 2] & 15;
    }
    used = nb + 1;
  } else {
    size_t csize = head;
    if (csize + 1 > size) fail("a truncated Huffman tree description");
    int16_t norm[256];
    int nsym, log;
    size_t hs = read_ncount(src + 1, csize, 6, 255, norm, &nsym, &log);
    Fse f;
    build_fse(f, norm, nsym, log);
    BackBits b;
    b.init(src + 1 + hs, csize - hs);
    uint32_t s1 = (uint32_t)b.read(log), s2 = (uint32_t)b.read(log);
    auto dec = [&](uint32_t& s) {
      const FseEntry& e = f.t[s];
      s = e.base + (uint32_t)b.read(e.bits);
      return (uint8_t)e.symbol;
    };
    for (;;) {
      if (nw > 253) fail("too many Huffman weights");
      w[nw++] = dec(s1);
      if (b.left < 0) {
        w[nw++] = dec(s2);
        break;
      }
      if (nw > 253) fail("too many Huffman weights");
      w[nw++] = dec(s2);
      if (b.left < 0) {
        w[nw++] = dec(s1);
        break;
      }
    }
    used = csize + 1;
  }
  // the weights, then the implicit last one
  uint32_t total = 0;
  int rank1 = 0;
  for (int i = 0; i < nw; i++) {
    if (w[i] > kHufLogMax) fail("a Huffman weight above 12");
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail("Huffman weights that are all zero");
  int log = highbit(total) + 1;
  if (log > kHufLogMax) fail("a Huffman table of more than 12 bits");
  uint32_t rest = (1u << log) - total;
  if (rest != (1u << highbit(rest)))
    fail("Huffman weights whose last one is not a power of two");
  w[nw++] = (uint8_t)(highbit(rest) + 1);
  if (nw > 256) fail("too many Huffman symbols");
  for (int i = 0; i < nw; i++) rank1 += w[i] == 1;
  if (rank1 < 2 || (rank1 & 1)) fail("Huffman weights of a broken tree");
  // lowest weight first, in symbol order: consecutive table ranges
  h.bits = log;
  int pos = 0;
  for (int wt = 1; wt <= log; wt++) {
    for (int s = 0; s < nw; s++) {
      if (w[s] != wt) continue;
      int n = 1 << (wt - 1);
      uint8_t nb = (uint8_t)(log + 1 - wt);
      for (int i = 0; i < n; i++) {
        h.sym[pos + i] = (uint8_t)s;
        h.len[pos + i] = nb;
      }
      pos += n;
    }
  }
  return used;
}

void huf_stream(const Huf& h, const uint8_t* src, size_t size, uint8_t* dst,
                size_t count) {
  BackBits b;
  b.init(src, size);
  for (size_t i = 0; i < count; i++) {
    uint32_t v = (uint32_t)b.peek(h.bits);
    dst[i] = h.sym[v];
    b.left -= h.len[v];
  }
  if (b.left != 0) fail("a Huffman stream that does not end where it should");
}

// Four streams as libzstd 1.5.7 decodes them on x86-64 (HUF's "fast" C
// loop, which it takes when the table has at most 11 bits, every stream
// holds 8 bytes or more and the fourth segment is not empty): each stream
// is a 64-bit container read from its end, 5 symbols a turn, until the
// first stream nears the start of the jump table; then each stream goes on
// alone through libzstd's BIT_DStream, whose reads may reach back into
// the streams before it (down to the jump table) and, past that, wrap
// around its last container. Nothing checks that a stream ends where the
// next begins: a corrupt stream gives other literals, not an error, unless
// the loop left it more than 8 bytes before its start. Returns false where
// libzstd takes its plain decoder instead (huf_stream, which checks the
// ends).
const int kFastLog = 11;

bool huf4_fast(const Huf& h, const uint8_t* src, size_t size, uint8_t* dst,
               size_t n) {
  if (h.bits > kFastLog || n == 0) return false;
  size_t l1 = src[0] | (src[1] << 8), l2 = src[2] | (src[3] << 8),
         l3 = src[4] | (src[5] << 8);
  size_t l4 = size - 6 - l1 - l2 - l3;  // checked by the caller
  if (l1 < 8 || l2 < 8 || l3 < 8 || l4 < 8) return false;
  size_t seg = (n + 3) / 4;
  if (3 * seg >= n) return false;
  const int shift = kFastLog - h.bits;
  int64_t iend[4] = {6, (int64_t)(6 + l1), (int64_t)(6 + l1 + l2),
                     (int64_t)(6 + l1 + l2 + l3)};
  int64_t ip[4] = {iend[1] - 8, iend[2] - 8, iend[3] - 8,
                   (int64_t)size - 8};
  size_t op[4] = {0, seg, 2 * seg, 3 * seg};
  uint64_t bits[4];
  for (int s = 0; s < 4; s++) {
    uint8_t last = src[ip[s] + 7];
    int used = last ? 8 - highbit(last) : 0;
    bits[s] = (rd64(src + ip[s]) | 1) << used;
  }
  for (;;) {
    size_t oiters = (n - op[3]) / 5, iiters = (size_t)ip[0] / 7;
    size_t olimit = op[3] + 5 * (oiters < iiters ? oiters : iiters);
    if (op[3] == olimit) break;
    bool crossed = false;
    for (int s = 1; s < 4; s++) crossed |= ip[s] < ip[s - 1];
    if (crossed) break;
    do {
      for (int k = 0; k < 5; k++) {
        for (int s = 0; s < 4; s++) {
          uint32_t v = (uint32_t)(bits[s] >> 53) >> shift;
          bits[s] <<= h.len[v];
          dst[op[s] + k] = h.sym[v];
        }
      }
      for (int s = 0; s < 4; s++) {
        int ctz = __builtin_ctzll(bits[s]);
        op[s] += 5;
        ip[s] -= ctz >> 3;
        bits[s] = (rd64(src + ip[s]) | 1) << (ctz & 7);
      }
    } while (op[3] < olimit);
  }
  for (int s = 0; s < 4; s++) {
    size_t end = s < 3 ? (s + 1) * seg : n;
    if (ip[s] < iend[s] - 8)
      fail("a Huffman stream read past its start");
    // BIT_DStream over [jump table, ...): container, consumed, ptr
    uint64_t c = rd64(src + ip[s]);
    unsigned used = __builtin_ctzll(bits[s]);
    int64_t ptr = ip[s];
    auto reload = [&]() -> int {  // 0 unfinished, 1 end of buffer, 2 over
      if (used > 64) return 2;
      if (ptr >= 8) {
        ptr -= used >> 3;
        used &= 7;
        c = rd64(src + ptr);
        return 0;
      }
      if (ptr == 0) return 1;
      int64_t nb = used >> 3;
      int r = 0;
      if (ptr - nb < 0) {
        nb = ptr;
        r = 1;
      }
      ptr -= nb;
      used -= (unsigned)nb * 8;
      c = rd64(src + ptr);
      return r;
    };
    auto decode = [&]() {
      uint32_t v = (uint32_t)((c << (used & 63)) >> (64 - kFastLog)) >> shift;
      used += h.len[v];
      return h.sym[v];
    };
    size_t p = op[s];
    if (end - p > 3) {
      while ((reload() == 0) & (p < end - 3)) {
        for (int k = 0; k < 4; k++) dst[p++] = decode();
      }
    } else {
      reload();
    }
    while (p < end) dst[p++] = decode();
  }
  return true;
}

// ------------------------------------------------------------ sequences

const uint32_t LL_BASE[36] = {
    0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26,  27,  28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41, 43, 47,  51,  59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2,  2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2,  2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,  1,  1,  1,  1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Kind {
  int max_sym, max_log;
  const int16_t* dflt;
  int dflt_n, dflt_log;
};
const Kind KINDS[3] = {{35, 9, LL_DEFAULT, 36, 6},
                       {31, 8, OF_DEFAULT, 29, 5},
                       {52, 9, ML_DEFAULT, 53, 6}};

// ----------------------------------------------------------------- frame

// The state carried from block to block within a frame. One lives on each
// thread and is reset for every frame: its ~140 KB would otherwise be
// mapped and unmapped per frame, which serialises the reader threads.
struct Frame {
  Out* outp = nullptr;
  size_t start = 0;  // where this frame's output begins
  size_t block_max = 0;
  Huf huf;
  Fse tab[3];  // LL, OF, ML
  bool have[3] = {false, false, false};
  uint64_t rep[3] = {1, 4, 8};
  uint8_t lit[kBlockMax + 64];

  void reset(Out& o) {
    outp = &o;
    start = o.len;
    huf.bits = 0;
    have[0] = have[1] = have[2] = false;
    rep[0] = 1;
    rep[1] = 4;
    rep[2] = 8;
  }

  // the literals section; returns its size, the literals in lit[0, *n)
  size_t literals(const uint8_t* src, size_t size, size_t* n) {
    if (size < 2) fail("a compressed block too short for its literals");
    int type = src[0] & 3, fmt = (src[0] >> 2) & 3;
    if (type < 2) {
      size_t hs, regen;
      if (fmt == 0 || fmt == 2) {
        hs = 1;
        regen = src[0] >> 3;
      } else if (fmt == 1) {
        hs = 2;
        regen = (src[0] >> 4) + (src[1] << 4);
      } else {
        if (size < 3) fail("a truncated literals header");
        hs = 3;
        regen = (src[0] >> 4) + (src[1] << 4) + ((size_t)src[2] << 12);
      }
      if (regen > block_max) fail("more literals than a block holds");
      *n = regen;
      if (type == 0) {
        if (hs + regen > size) fail("truncated raw literals");
        memcpy(lit, src + hs, regen);
        return hs + regen;
      }
      if (hs + 1 > size) fail("truncated RLE literals");
      memset(lit, src[hs], regen);
      return hs + 1;
    }
    if (size < 5) fail("a compressed block too short for its literals");
    size_t hs, regen, csize;
    bool single = fmt == 0;
    uint64_t hdr = rd32(src) | ((uint64_t)src[4] << 32);
    if (fmt < 2) {
      hs = 3;
      regen = (hdr >> 4) & 0x3FF;
      csize = (hdr >> 14) & 0x3FF;
    } else if (fmt == 2) {
      hs = 4;
      regen = (hdr >> 4) & 0x3FFF;
      csize = (hdr >> 18) & 0x3FFF;
    } else {
      hs = 5;
      regen = (hdr >> 4) & 0x3FFFF;
      csize = (hdr >> 22) & 0x3FFFF;
    }
    if (regen > block_max) fail("more literals than a block holds");
    if (!single && regen < 6) fail("too few literals for four streams");
    if (hs + csize > size) fail("truncated compressed literals");
    const uint8_t* p = src + hs;
    size_t left = csize;
    if (type == 2) {
      size_t t = read_huffman(huf, p, left);
      p += t;
      left -= t;
    } else if (huf.bits == 0) {
      fail("treeless literals before any Huffman table");
    }
    *n = regen;
    if (single) {
      huf_stream(huf, p, left, lit, regen);
    } else {
      if (left < 6) fail("a truncated jump table");
      size_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8),
             s3 = p[4] | (p[5] << 8);
      if (s1 + s2 + s3 > left - 6) fail("a jump table past its literals");
      size_t s4 = left - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      const uint8_t* q = p + 6;
      if (huf4_fast(huf, p, left, lit, regen)) return hs + csize;
      huf_stream(huf, q, s1, lit, seg);
      huf_stream(huf, q + s1, s2, lit + seg, seg);
      huf_stream(huf, q + s1 + s2, s3, lit + 2 * seg, seg);
      huf_stream(huf, q + s1 + s2 + s3, s4, lit + 3 * seg, regen - 3 * seg);
    }
    return hs + csize;
  }

  void table(int k, int mode, const uint8_t* src, size_t size,
             size_t* used) {
    const Kind& kd = KINDS[k];
    *used = 0;
    if (mode == 0) {
      build_fse(tab[k], kd.dflt, kd.dflt_n, kd.dflt_log);
    } else if (mode == 1) {
      if (size < 1) fail("a truncated RLE sequence table");
      if (src[0] > kd.max_sym) fail("an RLE sequence symbol out of range");
      build_rle(tab[k], src[0]);
      *used = 1;
    } else if (mode == 2) {
      int16_t norm[64];
      int nsym, log;
      *used = read_ncount(src, size, kd.max_log, kd.max_sym, norm, &nsym,
                          &log);
      build_fse(tab[k], norm, nsym, log);
    } else if (!have[k]) {
      fail("a repeated sequence table before any table");
    }
    have[k] = true;
  }

  void block(const uint8_t* src, size_t size) {
    if (size > block_max) fail("a compressed block larger than allowed");
    size_t nlit;
    size_t pos = literals(src, size, &nlit);
    if (pos >= size) fail("a block without its sequences section");
    size_t nseq = src[pos++];
    if (nseq >= 128) {
      if (nseq == 255) {
        if (pos + 2 > size) fail("a truncated sequences header");
        nseq = src[pos] + (src[pos + 1] << 8) + 0x7F00;
        pos += 2;
      } else {
        if (pos >= size) fail("a truncated sequences header");
        nseq = ((nseq - 128) << 8) + src[pos++];
      }
    }
    Out& out = *outp;
    size_t base = out.len;
    const uint8_t* lp = lit;
    const uint8_t* lend = lit + nlit;
    if (nseq > 0) {
      if (pos >= size) fail("a truncated sequences header");
      int modes = src[pos++];
      if (modes & 3) fail("reserved bits set in the sequence modes");
      const int mode[3] = {modes >> 6, (modes >> 4) & 3, (modes >> 2) & 3};
      for (int k = 0; k < 3; k++) {
        size_t used;
        table(k, mode[k], src + pos, size - pos, &used);
        pos += used;
      }
      BackBits b;
      b.init(src + pos, size - pos);
      Fse &LL = tab[0], &OF = tab[1], &ML = tab[2];
      uint32_t sl = (uint32_t)b.read(LL.log), so = (uint32_t)b.read(OF.log),
               sm = (uint32_t)b.read(ML.log);
      for (size_t i = 0; i < nseq; i++) {
        int ofc = OF.t[so].symbol, llc = LL.t[sl].symbol,
            mlc = ML.t[sm].symbol;
        if (ofc > 31) fail("an offset code above 31");
        uint64_t ofv = (1ull << ofc) + b.read(ofc);
        uint64_t ml = ML_BASE[mlc] + b.read(ML_BITS[mlc]);
        uint64_t ll = LL_BASE[llc] + b.read(LL_BITS[llc]);
        uint64_t off;
        if (ofv > 3) {
          off = ofv - 3;
          rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = off;
        } else {
          int idx = (int)ofv - 1 + (ll == 0);
          if (idx == 0) {
            off = rep[0];
          } else {
            off = idx == 3 ? rep[0] - 1 : rep[idx];
            if (off == 0) fail("a repeat offset of zero");
            if (idx != 1) rep[2] = rep[1];
            rep[1] = rep[0];
            rep[0] = off;
          }
        }
        if (i + 1 < nseq) {
          const FseEntry &el = LL.t[sl], &em = ML.t[sm], &eo = OF.t[so];
          sl = el.base + (uint32_t)b.read(el.bits);
          sm = em.base + (uint32_t)b.read(em.bits);
          so = eo.base + (uint32_t)b.read(eo.bits);
        }
        if (b.left < 0) fail("a sequences bitstream read past its start");
        if (ll > (size_t)(lend - lp)) fail("a sequence past its literals");
        if (out.len - base + ll + ml > block_max)
          fail("a block decoded larger than allowed");
        out.need(ll + ml);
        memcpy(out.buf + out.len, lp, ll);
        lp += ll;
        out.len += ll;
        if (off > out.len - start) fail("a match offset before the frame");
        uint8_t* d = out.buf + out.len;
        const uint8_t* s = d - off;
        if (off >= ml) {
          memcpy(d, s, ml);
        } else {
          for (uint64_t j = 0; j < ml; j++) d[j] = s[j];
        }
        out.len += ml;
      }
      if (b.left != 0) fail("a sequences bitstream that does not end");
    } else if (pos != size) {
      fail("data after an empty sequences section");
    }
    size_t rest = lend - lp;
    if (out.len - base + rest > block_max)
      fail("a block decoded larger than allowed");
    out.need(rest);
    memcpy(out.buf + out.len, lp, rest);
    out.len += rest;
  }
};

// one frame or skippable frame at src; returns the bytes it took
size_t frame(const uint8_t* src, size_t n, Out& out) {
  if (n < 4) fail("a truncated frame header");
  uint32_t magic = rd32(src);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    if (n < 8) fail("a truncated skippable frame");
    uint64_t sz = rd32(src + 4);
    if (8 + sz > n) fail("a truncated skippable frame");
    return 8 + sz;
  }
  if (magic != kMagic) fail("unknown frame descriptor (not a zstd frame)");
  if (n < 5) fail("a truncated frame header");
  int fhd = src[4];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
      dict_flag = fhd & 3;
  if (fhd & 8) fail("the frame header's reserved bit is set");
  size_t fcs_size = fcs_flag == 0 ? single : (1u << fcs_flag);
  size_t dict_size = dict_flag == 3 ? 4 : dict_flag;
  size_t hs = 5 + !single + dict_size + fcs_size;
  if (hs > n) fail("a truncated frame header");
  size_t pos = 5;
  uint64_t window = 0;
  if (!single) {
    int wd = src[pos++];
    int wlog = 10 + (wd >> 3);
    if (wlog > kWindowLogMax) fail("a frame window larger than 2 GiB");
    uint64_t wbase = 1ull << wlog;
    window = wbase + (wbase / 8) * (wd & 7);
  }
  uint32_t dict = 0;
  for (size_t i = 0; i < dict_size; i++) dict |= (uint32_t)src[pos + i] << (8 * i);
  pos += dict_size;
  if (dict != 0) fail("a dictionary (ID " + std::to_string(dict) + ") is not supported");
  bool has_fcs = fcs_size > 0;
  uint64_t fcs = 0;
  for (size_t i = 0; i < fcs_size; i++) fcs |= (uint64_t)src[pos + i] << (8 * i);
  if (fcs_size == 2) fcs += 256;
  pos += fcs_size;
  if (single) window = fcs;
  if (window > kWindowLimit)
    fail("a frame that needs a window above 128 MiB");
  thread_local std::unique_ptr<Frame> tls;
  if (!tls) tls.reset(new Frame);
  Frame* f = tls.get();
  f->reset(out);
  f->block_max = window < kBlockMax ? (size_t)window : kBlockMax;
  for (;;) {
      if (pos + 3 > n) fail("a truncated block header");
      uint32_t bh = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
      pos += 3;
      int last = bh & 1, type = (bh >> 1) & 3;
      size_t size = bh >> 3;
      if (type == 3) fail("a block of the reserved type");
      size_t csize = type == 1 ? 1 : size;
      if (pos + csize > n) fail("a truncated block");
      if (type == 0) {
        if (size > f->block_max) fail("a block decoded larger than allowed");
        out.need(size);
        memcpy(out.buf + out.len, src + pos, size);
        out.len += size;
      } else if (type == 1) {
        if (size > f->block_max) fail("a block decoded larger than allowed");
        out.need(size);
        memset(out.buf + out.len, src[pos], size);
        out.len += size;
      } else {
        f->block(src + pos, size);
      }
      pos += csize;
      if (has_fcs && out.len - f->start > fcs)
        fail("a frame larger than its content size");
      if (last) break;
    }
    if (has_fcs && out.len - f->start != fcs)
      fail("a frame smaller than its content size");
    if (checksum) {
      if (pos + 4 > n) fail("a truncated content checksum");
      uint32_t want = rd32(src + pos);
      uint32_t got = (uint32_t)xxh64(out.buf + f->start, out.len - f->start);
      if (want != got) fail("the content checksum does not match");
      pos += 4;
    }
  return pos;
}

}  // namespace

extern "C" {

long zstd_decompress(const uint8_t* src, long n, uint8_t* dst, long cap,
                     uint8_t** out_ptr, char* err, int errlen) {
  Out out;
  if (dst) {
    out.buf = dst;
    out.cap = (size_t)cap;
  } else {
    out.grow = true;
  }
  try {
    size_t pos = 0;
    while (pos < (size_t)n) pos += frame(src + pos, (size_t)n - pos, out);
  } catch (const std::exception& e) {
    if (out.grow) free(out.buf);
    snprintf(err, errlen, "%s", e.what());
    return -1;
  }
  if (out.grow) *out_ptr = out.buf;
  return (long)out.len;
}

void zstd_free(void* p) { free(p); }
}
