// JPEG 2000 Part-1 and HT (Part 15) decoder for the slide reader (Aperio
// SVS tiles, TIFF compressions 33003 and 33005): raw codestreams and JP2
// files.
//
// It follows the decoding path of OpenJPEG 2.5 step by step, and PIL 12's
// unpacking of what OpenJPEG gives it, so its pixels equal those of
// PIL's Image.open(...).convert("RGB") bit for bit:
//   - the JP2 file format: the signature, ftyp, jp2h (ihdr, bpcc, colr,
//     pclr, cmap, cdef; res and other boxes skipped), jp2c and skipped
//     top-level boxes, XLBox lengths and LBox 0; OpenJPEG's checks
//     (box order and sizes, ihdr against SIZ, one pclr, cmap after it,
//     one cdef), its colour space from the first colr box of method 1 or
//     2, and PIL's own reading of the first jp2h box (its mode from ihdr,
//     CMYK from a colr box, a palette from pclr, built as its getcolor
//     builds it); pclr, cmap and cdef change no sample (PIL decodes tile
//     by tile, where OpenJPEG applies none of them);
//   - main and tile-part headers: SIZ (component precisions 1 to 31 bits,
//     signed or not, mixed; component subsampling XRsiz, YRsiz of 1 to
//     255, each tile-component on its own grid, B.3), COD, COC, QCD,
//     QCC, RGN, POC, COM, TLM, PLM,
//     PLT, CRG, PPM, PPT, SOT/SOD/EOC, several tiles and tile-parts,
//     image and tile offsets; COD/COC/QCD/QCC precedence as in Annex A, a
//     tile's POC progressions after the main header's;
//   - tier 2: the five progression orders (the position-driven ones in
//     the order of Annex B.12) and POC, each packet read once (OpenJPEG's
//     include table), packet headers with tag trees, Lblock, empty
//     packets and codeword segments, SOP/EPH markers where the COD says
//     so; the headers read from the packets, or packed: PPM segments
//     joined in Zppm order, their Nppm fields dropped and their runs read
//     on across tile-parts and segments in the order OpenJPEG decodes the
//     tiles, or a tile's PPT segments joined in Zppt order; past the end
//     of its source a header reads zero bits (empty packets), as
//     OpenJPEG's bit reader does;
//   - tier 1: the MQ decoder (Annex C) with OpenJPEG's 0xFFFF tail on
//     each segment, the raw segments of the bypass mode, the three coding
//     passes with the cleanup run mode (Annex D), the code-block style
//     flags (bypass, context reset, termination on each pass, vertically
//     causal contexts, predictable termination, segmentation symbols),
//     the maximum-shift ROI, and OpenJPEG's reconstruction: every
//     coefficient carries one bit below its last decoded bit plane, set
//     to one half (a mid-point);
//   - dequantization: reversible coefficients are halved with C integer
//     division; irreversible ones are multiplied by 0.5f times the step
//     size (1 + mu / 2048) * 2^(R - eps) of every band, R the component's
//     precision (no band gain, as OpenJPEG's decoder computes it),
//     expounded or derived;
//   - the inverse 5/3 (integer) and 9/7 (float32) lifting with symmetric
//     extension, rows first, then columns, on subband origins of either
//     parity; the 9/7 scales the low band by K and the high band by
//     OpenJPEG's 1.625732422f, and leaves a one-sample line as it is;
//   - inverse RCT (5/3) or ICT (9/7, OpenJPEG's constants) over components
//     of one size (OpenJPEG fails the tile otherwise), the DC level shift
//     2^(R - 1), lrintf (round to nearest even) and clamping to the
//     component's range;
//   - PIL's unpackers for its mode (from SIZ, or from ihdr and colr in a
//     JP2 file), OpenJPEG's colour space, the component count and the
//     first subsampled component (an unspecified space with 3 or 4
//     components is sYCC where that is Cb or Cr, else sRGB; grey, LA, L,
//     I;16 and palette unpackers read no subsampled stream): each sample
//     as OpenJPEG stores it (1, 2 or 4 bytes), plus the signed offset and
//     half the dropped range, shifted to 8 bits (16 for I;16) and cut to
//     them; subsampled planes read at PIL's integer-division offsets and
//     strides (pil_layout: nearest-neighbour upsampling at sizes the
//     factors divide, a skewed read elsewhere); then convert("RGB"): grey
//     replicated (I;16 clipped to 255), alpha dropped, sYCC through PIL's
//     YCbCr tables, CMYK through its cmyk2rgb, palette indices through its
//     palette (black past its end).
// Float operations are written one at a time and the source is built with
// -ffp-contract=off, so no multiply-add is fused on any host.
//
// Part 15 (HTJ2K): Rsiz bit 14, and CAP and CPF segments in the main
// header, skipped; HT code-blocks (style bit 0x40) through the HT block
// decoder below, as OpenJPEG 2.5 decodes them (its tier-2 rule for their
// codeword segments, its readers, its malformed-block errors).
// Refused with a message naming the feature: more than four components,
// precisions above 31 bits, mixed HT and Part 1 code-blocks, Part-2
// codestreams (Rsiz, markers, kernels, MCT, quantization, offsets, ROI
// styles), a precinct period XRsiz * 2^(PPx + NL - r) of 2^31 or more in
// a position-driven progression, and what OpenJPEG or PIL refuse:
// malformed boxes, a colour space with no unpacker for PIL's mode (one
// or two components with any subsampling among them), the RCT or ICT
// over components of different sizes, more than 256 palette colours,
// PPT beside PPM, an Nppm run past the last PPM segment, a Zppm or Zppt
// read twice, a tile with no data bytes. Component 0 subsampled is read
// as PIL reads it: at the SIZ's size, sRGB, by the same rule. Truncated
// or corrupt streams raise; nothing is read outside the buffer.
//
// Entry points (C ABI, loaded with ctypes, which releases the GIL; the
// decoder keeps no mutable static state, so threads decode in parallel):
//   j2k_info(data, n, dims[3], err, errlen)   -> 0, or 1 with a message;
//       dims = (height, width, components of the codestream)
//   j2k_decode(data, n, out, cap, err, errlen) -> 0, or 1 with a message;
//       out receives (H, W, 3) RGB uint8 as PIL's convert("RGB") gives it

#include <algorithm>
#include <climits>
#include <cmath>
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

[[noreturn]] void fail(const std::string& msg) { throw Error(msg); }

constexpr int64_t kMaxPixels = int64_t(1) << 26;  // per image
constexpr int64_t kMaxPrecincts = int64_t(1) << 20;  // per tile
constexpr int64_t kMaxPackets = int64_t(1) << 24;    // per tile

// -------------------------------------------------------------- bytes
struct Bytes {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  Bytes(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  void need(size_t k) const {
    if (k > n - pos) fail("truncated codestream");
  }
  uint8_t u8() {
    need(1);
    return p[pos++];
  }
  uint16_t u16() {
    need(2);
    uint16_t v = uint16_t(p[pos] << 8 | p[pos + 1]);
    pos += 2;
    return v;
  }
  uint32_t u32() {
    need(4);
    uint32_t v = uint32_t(p[pos]) << 24 | uint32_t(p[pos + 1]) << 16 |
                 uint32_t(p[pos + 2]) << 8 | uint32_t(p[pos + 3]);
    pos += 4;
    return v;
  }
};

std::string hex(unsigned m) {
  char b[16];
  snprintf(b, sizeof b, "0x%04X", m);
  return b;
}

int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
int64_t ceildivpow2(int64_t a, int e) {
  return (a + (int64_t(1) << e) - 1) >> e;
}
int64_t floordivpow2(int64_t a, int e) { return a >> e; }
int floorlog2(uint32_t v) {
  int l = 0;
  while (v > 1) {
    v >>= 1;
    ++l;
  }
  return l;
}

// ------------------------------------------------------- coding style
struct Spc {  // SPcod / SPcoc and the precinct bit of Scod / Scoc
  int nl = 0;
  int cbw = 0, cbh = 0;  // exponents
  int cbstyle = 0;
  int qmfbid = 0;  // 1: reversible 5/3, 0: irreversible 9/7
  uint8_t ppx[33], ppy[33];
};

struct Quant {
  int style = 0;  // 0 none, 1 scalar derived, 2 scalar expounded
  int guard = 0;
  int nsteps = 0;
  uint16_t expn[97], mant[97];
};

struct Cod {
  bool sop = false, eph = false;
  int prog = 0, layers = 1, mct = 0;
  Spc spc;
};

struct Poc {  // one progression of a POC marker
  int res0, comp0, lay1, res1, comp1, prog;
};

void parse_spc(Bytes& b, size_t end, bool custom, Spc& s) {
  s.nl = b.u8();
  if (s.nl > 32) fail("COD/COC: " + std::to_string(s.nl) +
                      " decomposition levels (at most 32)");
  s.cbw = b.u8() + 2;
  s.cbh = b.u8() + 2;
  if (s.cbw > 10 || s.cbh > 10 || s.cbw + s.cbh > 12)
    fail("COD/COC: code-block size out of range");
  s.cbstyle = b.u8();
  if (s.cbstyle & 0x80)
    fail("code-block style " + hex(unsigned(s.cbstyle)) +
         ": mixed HT and Part 1 code-blocks (HTMIXED) are not supported");
  int t = b.u8();
  if (t > 1) fail("COD/COC: wavelet transform " + std::to_string(t) +
                  " (Part 2 arbitrary kernels) is not supported");
  s.qmfbid = t;
  for (int r = 0; r <= s.nl; ++r) {
    if (custom) {
      int v = b.u8();
      s.ppx[r] = uint8_t(v & 15);
      s.ppy[r] = uint8_t(v >> 4);
      if (r > 0 && (s.ppx[r] == 0 || s.ppy[r] == 0))
        fail("COD/COC: precinct exponent 0 above resolution 0");
    } else {
      s.ppx[r] = s.ppy[r] = 15;
    }
  }
  if (b.pos != end) fail("COD/COC: bad segment length");
}

void parse_quant(Bytes& b, size_t end, Quant& q) {
  int sq = b.u8();
  q.guard = sq >> 5;
  q.style = sq & 31;
  if (q.style > 2) fail("QCD/QCC: quantization style " +
                        std::to_string(q.style) +
                        " (Part 2 trellis or unknown) is not supported");
  size_t left = end - b.pos;
  if (q.style == 0) {
    q.nsteps = int(left);
    if (q.nsteps < 1 || q.nsteps > 97) fail("QCD/QCC: bad length");
    for (int i = 0; i < q.nsteps; ++i) {
      q.expn[i] = uint16_t(b.u8() >> 3);
      q.mant[i] = 0;
    }
  } else {
    if (left % 2 || left < 2) fail("QCD/QCC: bad length");
    q.nsteps = int(left / 2);
    if (q.style == 1 && q.nsteps != 1) fail("QCD/QCC: bad length");
    if (q.nsteps > 97) fail("QCD/QCC: bad length");
    for (int i = 0; i < q.nsteps; ++i) {
      int v = b.u16();
      q.expn[i] = uint16_t(v >> 11);
      q.mant[i] = uint16_t(v & 2047);
    }
  }
}

// ------------------------------------------------------------- header
struct CompSiz {
  bool sgnd;
  int prec;    // 1 to 31 bits
  int dx, dy;  // XRsiz, YRsiz: 1 to 255
};

// the marker segments of packed packet headers (PPM, PPT), by their
// index Zppm or Zppt; OpenJPEG reads each index once and joins them in
// index order
struct Packed {
  std::vector<std::vector<uint8_t>> seg;
  std::vector<uint8_t> set;
  bool any = false;
  void add(const uint8_t* p, size_t n, const char* what) {
    if (n < 2) fail(std::string(what) + ": bad length");
    int z = p[0];
    if (seg.empty()) {
      seg.resize(256);
      set.assign(256, 0);
    }
    if (set[size_t(z)])
      fail(std::string(what) + ": index " + std::to_string(z) +
           " read twice");
    set[size_t(z)] = 1;
    seg[size_t(z)].assign(p + 1, p + n);
    any = true;
  }
};

struct TileData {
  std::vector<uint8_t> bytes;
  int nparts = 0;
  Packed ppt;
  bool has_cod = false, has_qcd = false;
  Cod cod;
  Quant qcd;
  std::vector<int> coc_set, qcc_set, rgn_set, roishift;
  std::vector<Spc> coc;
  std::vector<Quant> qcc;
  std::vector<Poc> poc;  // appended to the main header's
};

struct Codestream {
  int64_t X = 0, Y = 0, X0 = 0, Y0 = 0, TW = 0, TH = 0, TX0 = 0, TY0 = 0;
  int nc = 0;
  std::vector<CompSiz> comp;
  int ntx = 0, nty = 0;
  bool has_cod = false, has_qcd = false;
  Cod cod;
  Quant qcd;
  std::vector<int> coc_set, qcc_set, roishift;
  std::vector<Spc> coc;
  std::vector<Quant> qcc;
  std::vector<Poc> poc;
  std::vector<TileData> tiles;
  std::vector<int> order;  // the tiles in the order OpenJPEG decodes them
  Packed ppm_seg;
  std::vector<uint8_t> ppm;  // the PPM packet headers, Nppm fields out

  int height() const { return int(Y - Y0); }
  int width() const { return int(X - X0); }

  static void refuse_marker(unsigned m) {
    switch (m) {
      case 0xFF60:
        fail("PPM marker in a tile-part header");
      case 0xFF61:
        fail("PPT marker in the main header");
      case 0xFF50: case 0xFF59:
        fail("Part 15 marker " + hex(m) + " (CAP or CPF) in a tile-part "
             "header (OpenJPEG reads them in the main header only)");
      default:
        break;
    }
    if (m >= 0xFF70 && m <= 0xFF7F)
      fail("Part-2 extension marker " + hex(m) + " is not supported");
    fail("unknown marker " + hex(m));
  }

  void parse_siz(Bytes& b) {
    size_t start = b.pos;
    int len = b.u16();
    int rsiz = b.u16();
    // Rsiz bit 14 (Part 15) only signals: OpenJPEG picks HT decoding by
    // each code-block's style, which parse_spc refuses
    if (rsiz & 0x8000) fail("Part-2 extensions (Rsiz " + hex(rsiz) +
                            ") are not supported");
    X = b.u32();
    Y = b.u32();
    X0 = b.u32();
    Y0 = b.u32();
    TW = b.u32();
    TH = b.u32();
    TX0 = b.u32();
    TY0 = b.u32();
    nc = b.u16();
    if (nc < 1 || nc > 4)
      fail(std::to_string(nc) + " components (1 to 4 are supported)");
    if (len != 38 + 3 * nc) fail("SIZ: bad segment length");
    if (X <= X0 || Y <= Y0) fail("SIZ: empty image area");
    if (TW == 0 || TH == 0) fail("SIZ: zero tile size");
    if (TX0 > X0 || TY0 > Y0 || TX0 + TW <= X0 || TY0 + TH <= Y0)
      fail("SIZ: tile grid does not cover the image origin");
    if ((X - X0) * (Y - Y0) > kMaxPixels)
      fail("SIZ: image larger than " + std::to_string(kMaxPixels) +
           " pixels");
    int64_t ntx64 = ceildiv(X - TX0, TW), nty64 = ceildiv(Y - TY0, TH);
    if (ntx64 * nty64 > 65535) fail("SIZ: more than 65535 tiles");
    ntx = int(ntx64);
    nty = int(nty64);
    comp.resize(size_t(nc));
    for (int c = 0; c < nc; ++c) {
      int ssiz = b.u8();
      int dx = b.u8(), dy = b.u8();
      int prec = (ssiz & 0x7F) + 1;
      if (prec > 31)
        fail("component precision " + std::to_string(prec) +
             " bits (OpenJPEG reads 1 to 31)");
      if (dx == 0 || dy == 0)
        fail("SIZ: component subsampling 0");
      comp[size_t(c)].sgnd = ssiz & 0x80;
      comp[size_t(c)].prec = prec;
      comp[size_t(c)].dx = dx;
      comp[size_t(c)].dy = dy;
    }
    if (b.pos != start + size_t(len)) fail("SIZ: bad segment length");
    coc_set.assign(size_t(nc), 0);
    qcc_set.assign(size_t(nc), 0);
    roishift.assign(size_t(nc), 0);
    coc.resize(size_t(nc));
    qcc.resize(size_t(nc));
    tiles.resize(size_t(ntx * nty));
    for (auto& t : tiles) {
      t.coc_set.assign(size_t(nc), 0);
      t.qcc_set.assign(size_t(nc), 0);
      t.rgn_set.assign(size_t(nc), 0);
      t.roishift.assign(size_t(nc), 0);
      t.coc.resize(size_t(nc));
      t.qcc.resize(size_t(nc));
    }
  }

  static void parse_cod(Bytes& b, size_t end, Cod& c) {
    int scod = b.u8();
    if (scod & ~7) fail("COD: Scod " + hex(unsigned(scod)) +
                        " (Part 2 precinct or code-block offsets) is not "
                        "supported");
    c.sop = scod & 2;
    c.eph = scod & 4;
    c.prog = b.u8();
    if (c.prog > 4) fail("COD: unknown progression order " +
                         std::to_string(c.prog));
    c.layers = b.u16();
    if (c.layers < 1) fail("COD: zero quality layers");
    c.mct = b.u8();
    if (c.mct > 1) fail("COD: multiple component transform " +
                        std::to_string(c.mct) + " (Part 2) is not supported");
    parse_spc(b, end, scod & 1, c.spc);
  }

  int comp_index(Bytes& b) const { return nc < 257 ? b.u8() : b.u16(); }

  // POC: progressions appended in the order read; the end indices are
  // clipped to the tile's counts where they are used, as OpenJPEG does
  void parse_poc(Bytes& b, size_t end, std::vector<Poc>& out) {
    size_t entry = nc < 257 ? 7 : 9;
    if (b.pos == end || (end - b.pos) % entry) fail("POC: bad length");
    while (b.pos < end) {
      // a tile's progressions follow the main header's
      if (out.size() + (&out == &poc ? 0 : poc.size()) >= 32)
        fail("POC: more than 32 progressions");
      Poc q;
      q.res0 = b.u8();
      q.comp0 = comp_index(b);
      q.lay1 = b.u16();
      q.res1 = b.u8();
      q.comp1 = comp_index(b);
      q.prog = b.u8();
      if (q.prog > 4) fail("POC: unknown progression order " +
                           std::to_string(q.prog));
      out.push_back(q);
    }
  }

  // RGN: the maximum-shift region of interest of one component
  void parse_rgn(Bytes& b, size_t end, std::vector<int>& shift,
                 std::vector<int>* set) {
    int ci = comp_index(b);
    if (ci >= nc) fail("RGN: component index out of range");
    int style = b.u8();
    if (style != 0) fail("RGN: region style " + std::to_string(style) +
                         " (Part 2) is not supported");
    shift[size_t(ci)] = b.u8();
    if (set) (*set)[size_t(ci)] = 1;
    if (b.pos != end) fail("RGN: bad length");
  }

  // a COC, QCD or QCC segment of the main header (tile == nullptr) or of
  // a tile's first tile-part
  void parse_coding(unsigned m, Bytes& b, size_t end, TileData* t) {
    if (m == 0xFF52) {
      Cod& c = t ? t->cod : cod;
      parse_cod(b, end, c);
      (t ? t->has_cod : has_cod) = true;
    } else if (m == 0xFF53) {
      int ci = comp_index(b);
      if (ci >= nc) fail("COC: component index out of range");
      int scoc = b.u8();
      if (scoc & ~1) fail("COC: bad Scoc");
      Spc& s = t ? t->coc[size_t(ci)] : coc[size_t(ci)];
      parse_spc(b, end, scoc & 1, s);
      (t ? t->coc_set : coc_set)[size_t(ci)] = 1;
    } else if (m == 0xFF5C) {
      parse_quant(b, end, t ? t->qcd : qcd);
      (t ? t->has_qcd : has_qcd) = true;
    } else {  // QCC
      int ci = comp_index(b);
      if (ci >= nc) fail("QCC: component index out of range");
      parse_quant(b, end, t ? t->qcc[size_t(ci)] : qcc[size_t(ci)]);
      (t ? t->qcc_set : qcc_set)[size_t(ci)] = 1;
    }
    if (b.pos != end) fail("marker segment " + hex(m) + ": bad length");
  }

  void parse(const uint8_t* data, size_t n, bool header_only) {
    if (n >= 12 && memcmp(data, "\0\0\0\x0cjP  \r\n\x87\n", 12) == 0)
      fail("JP2 file format (boxed codestream) is not supported: give the "
           "raw codestream");
    Bytes b(data, n);
    if (b.u16() != 0xFF4F) fail("not a JPEG 2000 codestream (no SOC)");
    if (b.u16() != 0xFF51) fail("SIZ must follow SOC");
    parse_siz(b);
    // main header
    for (;;) {
      unsigned m = b.u16();
      if (m == 0xFF90) break;
      if (m == 0xFFD9) fail("codestream has no tile-part");
      if ((m & 0xFF00) != 0xFF00) fail("expected a marker, got " + hex(m));
      size_t seg = b.pos;
      int len = b.u16();
      if (len < 2) fail("marker " + hex(m) + ": bad length");
      b.need(size_t(len) - 2);
      size_t end = seg + size_t(len);
      switch (m) {
        case 0xFF52: case 0xFF53: case 0xFF5C: case 0xFF5D:
          parse_coding(m, b, end, nullptr);
          break;
        case 0xFF5F:
          parse_poc(b, end, poc);
          break;
        case 0xFF5E:
          parse_rgn(b, end, roishift, nullptr);
          break;
        // COM TLM PLM CRG, and Part 15's CAP and CPF, which OpenJPEG
        // 2.5 reads in the main header and skips
        case 0xFF64: case 0xFF55: case 0xFF57: case 0xFF63:
        case 0xFF50: case 0xFF59:
          b.pos = end;
          break;
        case 0xFF60:
          ppm_seg.add(data + b.pos, end - b.pos, "PPM");
          b.pos = end;
          break;
        default:
          refuse_marker(m);
      }
    }
    if (!has_cod) fail("main header has no COD");
    if (!has_qcd) fail("main header has no QCD");
    if (ppm_seg.any) merge_ppm();
    if (header_only) return;
    b.pos -= 2;
    // tile-parts
    for (;;) {
      unsigned m = b.u16();
      if (m == 0xFFD9) break;
      if (m != 0xFF90) fail("expected SOT or EOC, got " + hex(m));
      size_t sot = b.pos - 2;
      if (b.u16() != 10) fail("SOT: bad length");
      int isot = b.u16();
      uint32_t psot = b.u32();
      int tpsot = b.u8();
      int tnsot = b.u8();
      if (isot >= ntx * nty) fail("SOT: tile index out of range");
      TileData& t = tiles[size_t(isot)];
      if (tpsot != t.nparts) fail("tile-parts out of order");
      if (tnsot && tpsot >= tnsot) fail("SOT: TPsot past TNsot");
      // OpenJPEG decodes a tile once its last tile-part is read, the
      // rest at EOC in index order; PPM headers are read in that order
      if (tnsot && tpsot == tnsot - 1) order.push_back(isot);
      size_t end;
      if (psot == 0) {
        if (n < sot + 14 || data[n - 2] != 0xFF || data[n - 1] != 0xD9)
          fail("truncated codestream (no EOC)");
        end = n - 2;
      } else {
        if (psot < 14 || psot > n - sot) fail("truncated codestream");
        end = sot + psot;
      }
      for (;;) {
        unsigned mm = b.u16();
        if (mm == 0xFF93) break;
        if ((mm & 0xFF00) != 0xFF00)
          fail("expected a marker, got " + hex(mm));
        size_t seg = b.pos;
        int len = b.u16();
        if (len < 2 || seg + size_t(len) > end)
          fail("marker " + hex(mm) + ": bad length");
        size_t send = seg + size_t(len);
        switch (mm) {
          case 0xFF52: case 0xFF53: case 0xFF5C: case 0xFF5D:
            if (t.nparts) fail("coding marker after the first tile-part");
            parse_coding(mm, b, send, &t);
            break;
          case 0xFF5E:
            if (t.nparts) fail("RGN marker after the first tile-part");
            parse_rgn(b, send, t.roishift, &t.rgn_set);
            break;
          case 0xFF5F:
            parse_poc(b, send, t.poc);
            break;
          case 0xFF64: case 0xFF58:  // COM PLT
            b.pos = send;
            break;
          case 0xFF61:
            if (ppm_seg.any)
              fail("PPT marker in a codestream with PPM (OpenJPEG refuses "
                   "packet headers in both)");
            t.ppt.add(data + b.pos, send - b.pos, "PPT");
            b.pos = send;
            break;
          default:
            refuse_marker(mm);
        }
      }
      if (b.pos > end) fail("truncated codestream");
      t.bytes.insert(t.bytes.end(), data + b.pos, data + end);
      t.nparts++;
      b.pos = end;
    }
    for (size_t i = 0; i < tiles.size(); ++i) {
      if (!tiles[i].nparts) fail("tile " + std::to_string(i) + " is missing");
      // OpenJPEG keeps no buffer for a tile without data bytes, and does
      // not decode it
      if (tiles[i].bytes.empty())
        fail("tile " + std::to_string(i) + " has no data after its "
             "tile-part headers");
    }
    std::vector<uint8_t> queued(tiles.size(), 0);
    std::vector<int> first;
    for (int i : order)
      if (!queued[size_t(i)]) {
        queued[size_t(i)] = 1;
        first.push_back(i);
      }
    for (size_t i = 0; i < tiles.size(); ++i)
      if (!queued[i]) first.push_back(int(i));
    order = first;
  }

  // opj_j2k_merge_ppm: the segments in Zppm order, each a run of Nppm
  // (4 bytes) and that many bytes of headers; a run may go on into the
  // next segment, and the Nppm fields are dropped
  void merge_ppm() {
    uint32_t left = 0;  // bytes of a run still to come
    for (size_t z = 0; z < 256; ++z) {
      if (!ppm_seg.set[z]) continue;
      const std::vector<uint8_t>& sg = ppm_seg.seg[z];
      size_t at = 0;
      while (at < sg.size()) {
        if (left) {
          size_t k = std::min<size_t>(left, sg.size() - at);
          ppm.insert(ppm.end(), sg.begin() + long(at),
                     sg.begin() + long(at + k));
          at += k;
          left -= uint32_t(k);
          continue;
        }
        if (sg.size() - at < 4) fail("PPM: not enough bytes for Nppm");
        left = uint32_t(sg[at]) << 24 | uint32_t(sg[at + 1]) << 16 |
               uint32_t(sg[at + 2]) << 8 | sg[at + 3];
        at += 4;
        if (ppm.size() + left > (uint64_t(1) << 31))
          fail("PPM: Nppm too large");
      }
    }
    if (left) fail("PPM: Nppm runs past the last PPM segment");
  }
};

// ---------------------------------------------------- JP2 file format
// PIL 12 opens a JP2 file twice over: its Python plugin reads the first
// jp2h box for the image's size and mode (and a palette), and OpenJPEG
// 2.5 reads every box for its own checks and the colour space. Both are
// followed here; what either refuses raises.
enum class Mode { L, I16, LA, RGB, RGBA, CMYK, P, PA };
enum class Space { Unspecified, Srgb, Gray, Sycc, Eycc, Cmyk };

const char* mode_name(Mode m) {
  static const char* n[] = {"L", "I;16", "LA", "RGB", "RGBA", "CMYK", "P",
                            "PA"};
  return n[int(m)];
}

const char* space_name(Space s) {
  static const char* n[] = {"unspecified", "sRGB", "greyscale", "sYCC",
                            "e-sYCC", "CMYK"};
  return n[int(s)];
}

constexpr uint32_t fourcc(const char* s) {
  return uint32_t(uint8_t(s[0])) << 24 | uint32_t(uint8_t(s[1])) << 16 |
         uint32_t(uint8_t(s[2])) << 8 | uint32_t(uint8_t(s[3]));
}

uint32_t be32(const uint8_t* p) {
  return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 |
         p[3];
}

std::string box_name(uint32_t t) {
  std::string s = "'";
  for (int k = 24; k >= 0; k -= 8) {
    char c = char(t >> k & 0xFF);
    s += c >= 32 && c < 127 ? c : '?';
  }
  return s + "'";
}

struct Box {
  uint32_t type = 0;
  size_t start = 0, end = 0;  // the payload
};

struct Jp2 {
  // PIL's view
  Mode mode = Mode::L;
  int64_t width = 0, height = 0;
  std::vector<uint8_t> pal;  // the palette's bytes as getcolor built them
  int pal_entry = 3;         // bytes an entry: 3 (RGB) or 4 (RGBA)
  // OpenJPEG's view
  Space space = Space::Unspecified;
  int64_t ihdr_w = 0, ihdr_h = 0;
  size_t cs_start = 0;  // the codestream runs from here to the end
  // OpenJPEG's state while reading the image header boxes
  bool has_ihdr = false, has_colr = false, has_pclr = false,
       has_cmap = false, has_cdef = false;
  int ihdr_nc = 0, pclr_npc = 0;

  // opj_jp2_read_boxhdr_char inside a superbox of `size` bytes at `p`
  static Box sub_box(const uint8_t* p, size_t pos, size_t size) {
    if (size - pos < 8) fail("JP2: a box in jp2h is shorter than 8 bytes");
    uint64_t len = be32(p + pos);
    size_t hl = 8;
    if (len == 1) {
      if (size - pos < 16) fail("JP2: truncated XLBox in jp2h");
      if (be32(p + pos + 8)) fail("JP2: box of 4 GiB or more");
      len = be32(p + pos + 12);
      hl = 16;
    }
    if (len == 0) fail("JP2: box of undefined size in jp2h");
    if (len < hl || len > size - pos)
      fail("JP2: box length in jp2h is inconsistent");
    Box b;
    b.type = be32(p + pos + 4);
    b.start = pos + hl;
    b.end = pos + size_t(len);
    return b;
  }

  // OpenJPEG's handlers of the image header boxes
  void image_box(const uint8_t* d, const Box& b) {
    const uint8_t* p = d + b.start;
    size_t n = b.end - b.start;
    switch (b.type) {
      case fourcc("ihdr"): {
        if (has_ihdr) return;  // the first counts
        if (n != 14) fail("JP2: ihdr box of " + std::to_string(n) +
                          " bytes (14 expected)");
        ihdr_h = be32(p);
        ihdr_w = be32(p + 4);
        ihdr_nc = p[8] << 8 | p[9];
        if (ihdr_h < 1 || ihdr_w < 1 || ihdr_nc < 1 || ihdr_nc > 16384)
          fail("JP2: ihdr gives " + std::to_string(ihdr_w) + " x " +
               std::to_string(ihdr_h) + " x " + std::to_string(ihdr_nc));
        has_ihdr = true;
        return;
      }
      case fourcc("bpcc"):
        if (n != size_t(ihdr_nc))
          fail("JP2: bpcc box of " + std::to_string(n) + " bytes for " +
               std::to_string(ihdr_nc) + " components");
        return;
      case fourcc("colr"): {
        if (n < 3) fail("JP2: colr box shorter than 3 bytes");
        if (has_colr) return;  // the first counts
        int meth = p[0];
        if (meth != 1 && meth != 2) return;  // ignored
        if (meth == 2 && n == 3) fail("JP2: colr box with an empty ICC "
                                      "profile");
        space = Space::Unspecified;
        if (meth == 1) {
          if (n < 7) fail("JP2: colr box shorter than 7 bytes");
          switch (be32(p + 3)) {
            case 16: space = Space::Srgb; break;
            case 17: space = Space::Gray; break;
            case 18: space = Space::Sycc; break;
            case 24: space = Space::Eycc; break;
            case 12: space = Space::Cmyk; break;
            default: break;  // PIL guesses from the component count
          }
        }  // a restricted ICC profile (2) leaves the space unspecified
        has_colr = true;
        return;
      }
      case fourcc("pclr"): {
        if (has_pclr) fail("JP2: a second pclr box");
        if (n < 3) fail("JP2: pclr box shorter than 3 bytes");
        int ne = p[0] << 8 | p[1], npc = p[2];
        if (ne == 0 || ne > 1024)
          fail("JP2: pclr box with " + std::to_string(ne) + " entries");
        if (npc == 0) fail("JP2: pclr box with no columns");
        if (n < 3 + size_t(npc)) fail("JP2: truncated pclr box");
        size_t need = 3 + size_t(npc);
        for (int i = 0; i < npc; ++i)
          need += size_t(std::min(4, ((p[3 + i] & 0x7F) + 8) >> 3)) * ne;
        if (n < need) fail("JP2: truncated pclr box");
        has_pclr = true;
        pclr_npc = npc;
        return;
      }
      case fourcc("cmap"):
        if (!has_pclr) fail("JP2: cmap box before its pclr box");
        if (has_cmap) fail("JP2: a second cmap box");
        if (n < size_t(pclr_npc) * 4) fail("JP2: truncated cmap box");
        has_cmap = true;
        return;
      case fourcc("cdef"): {
        if (has_cdef) fail("JP2: a second cdef box");
        if (n < 2) fail("JP2: truncated cdef box");
        int k = p[0] << 8 | p[1];
        if (k == 0) fail("JP2: cdef box with no channels");
        if (n < 2 + 6 * size_t(k)) fail("JP2: truncated cdef box");
        has_cdef = true;
        return;
      }
      default:
        return;  // res and any other box inside jp2h: skipped
    }
  }

  static bool is_image_box(uint32_t t) {
    return t == fourcc("ihdr") || t == fourcc("colr") ||
           t == fourcc("bpcc") || t == fourcc("pclr") ||
           t == fourcc("cmap") || t == fourcc("cdef");
  }

  // opj_jp2_read_header_procedure: the top-level boxes up to jp2c
  void read_openjpeg(const uint8_t* d, size_t n) {
    bool sig = false, ftyp = false, header = false;
    size_t pos = 0;
    for (;;) {
      if (n - pos < 8) fail("JP2: no codestream box (jp2c)");
      uint64_t len = be32(d + pos);
      uint32_t type = be32(d + pos + 4);
      size_t hl = 8;
      if (len == 1) {
        if (n - pos < 16) fail("JP2: truncated XLBox");
        if (be32(d + pos + 8)) fail("JP2: box of 4 GiB or more");
        len = be32(d + pos + 12);
        hl = 16;
        if (len == 0) fail("JP2: box of undefined size");
      } else if (len == 0) {
        len = n - pos;  // to the end
      }
      if (type == fourcc("jp2c")) {
        if (!header) fail("JP2: codestream box before the header box jp2h");
        cs_start = pos + hl;
        break;
      }
      if (len < hl) fail("JP2: box " + box_name(type) + " has a bad length");
      if (len > n - pos)
        fail("JP2: box " + box_name(type) + " runs past the end");
      Box b{type, pos + hl, pos + size_t(len)};
      if (type == fourcc("jP  ")) {
        if (sig || ftyp || header)
          fail("JP2: the signature box must be the first box");
        if (b.end - b.start != 4 || be32(d + b.start) != 0x0D0A870A)
          fail("JP2: bad signature box");
        sig = true;
      } else if (type == fourcc("ftyp")) {
        if (!sig || ftyp || header)
          fail("JP2: the ftyp box must be the second box");
        size_t m = b.end - b.start;
        if (m < 8 || (m - 8) % 4) fail("JP2: bad ftyp box size");
        ftyp = true;
      } else if (type == fourcc("jp2h")) {
        if (!ftyp) fail("JP2: jp2h box before the ftyp box");
        size_t sz = b.end - b.start;
        bool ihdr_here = false;
        for (size_t q = 0; q < sz;) {
          Box s = sub_box(d + b.start, q, sz);
          s.start += b.start;
          s.end += b.start;
          image_box(d, s);
          ihdr_here |= s.type == fourcc("ihdr");
          q = s.end - b.start;
        }
        if (!ihdr_here) fail("JP2: jp2h box without an ihdr box");
        header = true;
      } else if (is_image_box(type)) {
        if (header) image_box(d, b);  // misplaced: read once jp2h is
      } else {
        if (!sig) fail("JP2: the signature box must be the first box");
        if (!ftyp) fail("JP2: the ftyp box must be the second box");
      }
      pos = b.end;
    }
  }

  // ImagePalette.getcolor, entry by entry: a colour met before takes its
  // first index; a new one goes at len(palette) // entry size, over what
  // lies there
  void add_colour(const std::vector<uint8_t>& c,
                  std::vector<std::vector<uint8_t>>& seen) {
    for (const auto& s : seen)
      if (s == c) return;
    size_t index = pal.size() / size_t(pal_entry);
    if (index >= 256) fail("JP2: palette of more than 256 colours (PIL "
                           "refuses it)");
    seen.push_back(c);
    size_t at = index * size_t(pal_entry);
    if (at < pal.size()) {
      std::vector<uint8_t> next(pal.begin(), pal.begin() + long(at));
      next.insert(next.end(), c.begin(), c.end());
      if (at + size_t(pal_entry) < pal.size())
        next.insert(next.end(), pal.begin() + long(at + size_t(pal_entry)),
                    pal.end());
      pal.swap(next);
    } else {
      pal.insert(pal.end(), c.begin(), c.end());
    }
  }

  // Jpeg2KImagePlugin._parse_jp2_header: the first jp2h box
  void read_pil(const uint8_t* d, size_t n) {
    size_t pos = 12;  // past the signature box
    Box h;
    for (;;) {
      if (n - pos < 8) fail("JP2: no jp2h box");
      uint64_t len = be32(d + pos);
      size_t hl = 8;
      if (len == 1) {
        if (n - pos < 16) fail("JP2: truncated XLBox");
        len = uint64_t(be32(d + pos + 8)) << 32 | be32(d + pos + 12);
        hl = 16;
      }
      if (len < hl) fail("JP2: box with a bad length before jp2h");
      uint32_t type = be32(d + pos + 4);
      if (type == fourcc("ftyp") && len - hl < 4)
        fail("JP2: ftyp box shorter than its brand");
      if (type == fourcc("jp2h")) {
        if (len > n - pos) fail("JP2: jp2h box runs past the end");
        h = {type, pos + hl, pos + size_t(len)};
        break;
      }
      if (len > n - pos) fail("JP2: no jp2h box");
      pos += size_t(len);
    }
    bool have_size = false, have_mode = false;
    int nc = 0;
    size_t sz = h.end - h.start;
    const uint8_t* base = d + h.start;
    for (size_t q = 0; q < sz;) {
      // BoxReader.next_box_type inside a box of known length
      if (sz - q < 8) fail("JP2: malformed jp2h box");
      uint64_t len = be32(base + q);
      size_t hl = 8;
      if (len == 1) {
        if (sz - q < 16) fail("JP2: malformed jp2h box");
        len = uint64_t(be32(base + q + 8)) << 32 | be32(base + q + 12);
        hl = 16;
      }
      if (len < hl || len > sz - q) fail("JP2: malformed jp2h box");
      uint32_t type = be32(base + q + 4);
      const uint8_t* p = base + q + hl;
      size_t m = size_t(len) - hl;
      if (type == fourcc("ihdr")) {
        if (m < 11) fail("JP2: ihdr box shorter than 11 bytes");
        height = be32(p);
        width = be32(p + 4);
        nc = p[8] << 8 | p[9];
        int bpc = p[10];
        have_size = true;
        if (nc >= 1 && nc <= 4) {
          static const Mode by_nc[] = {Mode::L, Mode::LA, Mode::RGB,
                                       Mode::RGBA};
          mode = nc == 1 && (bpc & 0x7F) > 8 ? Mode::I16 : by_nc[nc - 1];
          have_mode = true;
        }
      } else if (type == fourcc("colr") && nc == 4) {
        if (m < 7) fail("JP2: colr box shorter than 7 bytes");
        if (p[0] == 1 && be32(p + 3) == 12) mode = Mode::CMYK;
      } else if (type == fourcc("pclr") && have_mode &&
                 (mode == Mode::L || mode == Mode::LA)) {
        if (m < 3) fail("JP2: truncated pclr box");
        int ne = p[0] << 8 | p[1], npc = p[2];
        if (m < 3 + size_t(npc)) fail("JP2: truncated pclr box");
        int maxdepth = 0;  // the raw bytes, sign bit and all
        for (int i = 0; i < npc; ++i) maxdepth = std::max(maxdepth, int(p[3 + i]));
        if (maxdepth <= 8) {
          if (m < 3 + size_t(npc) * (1 + size_t(ne)))
            fail("JP2: truncated pclr box");
          pal.clear();
          pal_entry = npc == 4 ? 4 : 3;
          std::vector<std::vector<uint8_t>> seen;
          const uint8_t* e = p + 3 + npc;
          for (int i = 0; i < ne; ++i, e += npc) {
            std::vector<uint8_t> c(e, e + npc);
            add_colour(c, seen);
          }
          mode = mode == Mode::L ? Mode::P : Mode::PA;
        }
      } else if (type == fourcc("res ")) {
        // its resc box, read for the DPI
        for (size_t r = 0; r < m;) {
          if (m - r < 8) fail("JP2: malformed res box");
          uint64_t rl = be32(p + r);
          size_t rh = 8;
          if (rl == 1) {
            if (m - r < 16) fail("JP2: malformed res box");
            rl = uint64_t(be32(p + r + 8)) << 32 | be32(p + r + 12);
            rh = 16;
          }
          if (rl < rh || rl > m - r) fail("JP2: malformed res box");
          if (be32(p + r + 4) == fourcc("resc")) {
            if (rl - rh < 10) fail("JP2: resc box shorter than 10 bytes");
            break;
          }
          r += size_t(rl);
        }
      }
      q += size_t(len);
    }
    if (!have_size || !have_mode) fail("JP2: malformed JP2 header");
  }

  void parse(const uint8_t* d, size_t n) {
    read_pil(d, n);
    read_openjpeg(d, n);
    if (!has_ihdr) fail("JP2: no ihdr box");
  }
};

// ------------------------------------------------------ PIL's unpacking
// Jpeg2KDecode.c's unpacker for PIL's mode, OpenJPEG's colour space, the
// component count and the first subsampled component `sub` (-1: none),
// and what convert("RGB") makes of its pixels
enum class Out { Grey, Grey16, Rgb, Ycc, Cmyk, Palette };

Out unpacker(Mode mode, Space space, const std::vector<CompSiz>& comp) {
  int nc = int(comp.size()), sub = -1;
  for (int c = nc - 1; c >= 0; --c)
    if (comp[size_t(c)].dx != 1 || comp[size_t(c)].dy != 1) sub = c;
  // an unspecified space: grey, or sYCC where Cb or Cr is subsampled
  Space cs = space;
  if (cs == Space::Unspecified)
    cs = nc <= 2 ? Space::Gray
         : sub == 1 || sub == 2 ? Space::Sycc : Space::Srgb;
  struct Row {
    Mode m;
    Space s;
    int n;
    bool sub;  // reads subsampled components
    Out o;
  };
  static const Row rows[] = {
      {Mode::L, Space::Gray, 1, false, Out::Grey},
      {Mode::P, Space::Srgb, 1, false, Out::Palette},
      {Mode::PA, Space::Srgb, 2, false, Out::Palette},
      {Mode::I16, Space::Gray, 1, false, Out::Grey16},
      {Mode::LA, Space::Gray, 2, false, Out::Grey},
      {Mode::RGB, Space::Gray, 1, false, Out::Grey},
      {Mode::RGB, Space::Gray, 2, false, Out::Grey},
      {Mode::RGB, Space::Srgb, 3, true, Out::Rgb},
      {Mode::RGB, Space::Sycc, 3, true, Out::Ycc},
      {Mode::RGB, Space::Srgb, 4, true, Out::Rgb},
      {Mode::RGB, Space::Sycc, 4, true, Out::Ycc},
      {Mode::RGBA, Space::Gray, 1, false, Out::Grey},
      {Mode::RGBA, Space::Gray, 2, false, Out::Grey},
      {Mode::RGBA, Space::Srgb, 3, true, Out::Rgb},
      {Mode::RGBA, Space::Sycc, 3, true, Out::Ycc},
      {Mode::RGBA, Space::Gray, 4, true, Out::Rgb},
      {Mode::RGBA, Space::Srgb, 4, true, Out::Rgb},
      {Mode::RGBA, Space::Sycc, 4, true, Out::Ycc},
      {Mode::CMYK, Space::Cmyk, 4, true, Out::Cmyk}};
  for (const Row& r : rows)
    if (r.m == mode && r.s == cs && r.n == nc && (r.sub || sub < 0))
      return r.o;
  if (sub >= 0)
    fail("component subsampling (" + std::to_string(comp[size_t(sub)].dx) +
         " x " + std::to_string(comp[size_t(sub)].dy) + " in component " +
         std::to_string(sub) + ") of a " + space_name(cs) + " image with " +
         std::to_string(nc) + " component" + (nc > 1 ? "s" : "") +
         " in PIL mode " + mode_name(mode) + " (PIL has no unpacker for it)");
  fail(std::string("JP2: ") + space_name(space) + " colour space with " +
       std::to_string(nc) + " component" + (nc > 1 ? "s" : "") +
       " in PIL mode " + mode_name(mode) + " (PIL has no unpacker for it)");
}

// Pillow's YCbCr to RGB tables (ConvertYCbCr.c, 6 fraction bits)
struct YccTables {
  int r_cr[256], g_cb[256], g_cr[256], b_cb[256];
  YccTables() {
    for (int i = 0; i < 256; ++i) {
      double x = double(i - 128);
      r_cr[i] = int(1.402 * x * 64.0 + 0.5);
      g_cb[i] = int(-0.34414 * x * 64.0 + 0.5);
      g_cr[i] = int(-0.71414 * x * 64.0 + 0.5);
      b_cb[i] = int(1.772 * x * 64.0 + 0.5);
    }
  }
};

const YccTables& ycc() {
  static const YccTables t;  // built once, read only afterwards
  return t;
}

uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// one component as PIL's j2ku_* functions read OpenJPEG's tile buffer:
// the sample in 1, 2 or 4 bytes (3 round up to 4), plus the signed
// offset and half the dropped range, shifted to `bits` bits
struct Unpack {
  uint32_t mask, off;
  int shift;
  Unpack(int prec, bool sgnd, int bits) {
    int csiz = (prec + 7) >> 3;
    mask = csiz == 1 ? 0xFFu : csiz == 2 ? 0xFFFFu : 0xFFFFFFFFu;
    shift = bits - prec;
    off = sgnd ? uint32_t(1) << (prec - 1) : 0;
    if (shift < 0) off += uint32_t(1) << (-shift - 1);
  }
  uint32_t operator()(int32_t v) const {
    uint32_t x = off + (uint32_t(v) & mask);
    return shift < 0 ? x >> -shift : x << shift;
  }
};

struct Pil {
  Mode mode = Mode::RGB;
  Space space = Space::Unspecified;
  Out out = Out::Rgb;
  std::vector<uint8_t> pal;
  int pal_entry = 3;
};

// ----------------------------------------------------------- tag tree
struct TagTree {
  struct Node {
    int parent;
    int value;
    int low;
  };
  std::vector<Node> nodes;
  void init(int w, int h) {
    nodes.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<int> lw, lh;
    int cw = w, ch = h;
    for (;;) {
      lw.push_back(cw);
      lh.push_back(ch);
      if (cw == 1 && ch == 1) break;
      cw = (cw + 1) / 2;
      ch = (ch + 1) / 2;
    }
    size_t total = 0;
    for (size_t k = 0; k < lw.size(); ++k) total += size_t(lw[k]) * lh[k];
    nodes.assign(total, Node{-1, 999, 0});
    size_t base = 0;
    for (size_t k = 0; k + 1 < lw.size(); ++k) {
      size_t next = base + size_t(lw[k]) * lh[k];
      for (int y = 0; y < lh[k]; ++y)
        for (int x = 0; x < lw[k]; ++x)
          nodes[base + size_t(y) * lw[k] + x].parent =
              int(next + size_t(y / 2) * lw[k + 1] + x / 2);
      base = next;
    }
  }
};

// packet header bit reader (bit stuffing after 0xFF); past the end of
// the tile's data it reads zero bits, as OpenJPEG's does, so packets that
// an encoder left out read as empty (one such byte each); a header that
// needs more of them is truncated
struct Bio {
  const uint8_t* p;
  size_t n, pos = 0;
  uint32_t buf = 0;
  int ct = 0, past_end = 0;
  Bio(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (pos < n)
      buf |= p[pos++];
    else if (++past_end > 2)
      fail("truncated packet header");
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t read(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) v = v << 1 | bit();
    return v;
  }
  void inalign() {
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
  bool tag_decode(TagTree& t, int leaf, int threshold) {
    int stk[40];
    int sp = 0;
    int node = leaf;
    while (t.nodes[size_t(node)].parent >= 0) {
      if (sp == 40) fail("tag tree too deep");
      stk[sp++] = node;
      node = t.nodes[size_t(node)].parent;
    }
    int low = 0;
    for (;;) {
      TagTree::Node& nd = t.nodes[size_t(node)];
      if (low > nd.low)
        nd.low = low;
      else
        low = nd.low;
      while (low < threshold && low < nd.value) {
        if (bit())
          nd.value = low;
        else
          ++low;
      }
      nd.low = low;
      if (sp == 0) break;
      node = stk[--sp];
    }
    return t.nodes[size_t(node)].value < threshold;
  }
};

// ----------------------------------------------------------- MQ coder
struct QeEntry {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};
const QeEntry kQe[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

enum { kCtxZc = 0, kCtxSc = 9, kCtxMag = 14, kCtxRl = 17, kCtxUni = 18,
       kNumCtx = 19 };

struct Mq {
  const uint8_t* bp;  // the segment, followed by 0xFF 0xFF
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t state[kNumCtx], mps[kNumCtx];

  void reset_contexts() {
    memset(state, 0, sizeof state);
    memset(mps, 0, sizeof mps);
    state[kCtxUni] = 46;
    state[kCtxRl] = 3;
    state[kCtxZc] = 4;
  }
  void bytein() {
    uint32_t next = bp[1];
    if (bp[0] == 0xFF) {
      if (next > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += next << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += next << 8;
      ct = 8;
    }
  }
  // data must have two readable 0xFF bytes after len
  void init(const uint8_t* data, size_t len) {
    bp = data;
    c = len ? uint32_t(*bp) << 16 : 0xFFu << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (!(a & 0x8000));
  }
  int decode(int cx) {
    const QeEntry& e = kQe[state[cx]];
    uint32_t qe = e.qe;
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        a = qe;
        d = mps[cx];
        state[cx] = e.nmps;
      } else {
        a = qe;
        d = !mps[cx];
        if (e.sw) mps[cx] = uint8_t(!mps[cx]);
        state[cx] = e.nlps;
      }
      renorm();
    } else {
      c -= qe << 16;
      if (!(a & 0x8000)) {
        if (a < qe) {
          d = !mps[cx];
          if (e.sw) mps[cx] = uint8_t(!mps[cx]);
          state[cx] = e.nlps;
        } else {
          d = mps[cx];
          state[cx] = e.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
};

// -------------------------------------------------------------- tier 1
// per-sample flags: significance of the eight neighbours, signs of the
// four direct ones, and the sample's own state
enum : uint32_t {
  F_NW = 1u << 0, F_N = 1u << 1, F_NE = 1u << 2, F_W = 1u << 3,
  F_E = 1u << 4, F_SW = 1u << 5, F_S = 1u << 6, F_SE = 1u << 7,
  F_SGN_N = 1u << 8, F_SGN_S = 1u << 9, F_SGN_W = 1u << 10,
  F_SGN_E = 1u << 11, F_SIG = 1u << 12, F_VISIT = 1u << 13,
  F_REFINE = 1u << 14
};

struct Luts {
  uint8_t zc[4][256];  // by band: LL, HL, LH, HH
  uint8_t sc[256];     // low 4 bits: context - 9, bit 4: xor bit
  Luts() {
    for (int orient = 0; orient < 4; ++orient)
      for (int f = 0; f < 256; ++f) {
        int h = !!(f & F_W) + !!(f & F_E);
        int v = !!(f & F_N) + !!(f & F_S);
        int d = !!(f & F_NW) + !!(f & F_NE) + !!(f & F_SW) + !!(f & F_SE);
        int n = 0;
        if (orient == 1) std::swap(h, v);  // HL: horizontally high-pass
        if (orient != 3) {
          if (h == 0) {
            if (v == 0) n = d == 0 ? 0 : d == 1 ? 1 : 2;
            else n = v == 1 ? 3 : 4;
          } else if (h == 1) {
            n = v == 0 ? (d == 0 ? 5 : 6) : 7;
          } else {
            n = 8;
          }
        } else {
          int hv = h + v;
          if (d == 0) n = hv == 0 ? 0 : hv == 1 ? 1 : 2;
          else if (d == 1) n = hv == 0 ? 3 : hv == 1 ? 4 : 5;
          else if (d == 2) n = hv == 0 ? 6 : 7;
          else n = 8;
        }
        zc[orient][f] = uint8_t(kCtxZc + n);
      }
    // sc index bits: 0 N sig, 1 S sig, 2 W sig, 3 E sig, 4 N neg, 5 S
    // neg, 6 W neg, 7 E neg
    for (int i = 0; i < 256; ++i) {
      auto contrib = [&](int sig, int neg) {
        return (i >> sig & 1) ? ((i >> neg & 1) ? -1 : 1) : 0;
      };
      int hc = contrib(2, 6) + contrib(3, 7);
      int vc = contrib(0, 4) + contrib(1, 5);
      hc = std::max(-1, std::min(1, hc));
      vc = std::max(-1, std::min(1, vc));
      int ctx, x = 0;
      if (hc < 0) {
        x = 1;
        hc = -hc;
        vc = -vc;
      } else if (hc == 0 && vc < 0) {
        x = 1;
        vc = -vc;
      }
      if (hc == 0) ctx = vc == 0 ? 9 : 10;
      else ctx = vc == 1 ? 13 : vc == 0 ? 12 : 11;
      sc[i] = uint8_t((ctx - kCtxSc) | x << 4);
    }
  }
};

const Luts& luts() {
  static const Luts t;  // built once, read only afterwards
  return t;
}

// the bypass (raw) bit reader of selective arithmetic coding bypass: a
// byte after 0xFF gives 7 bits; a marker (0xFF then > 0x8F) gives ones
struct Raw {
  const uint8_t* bp;
  uint32_t c = 0;
  int ct = 0;
  void init(const uint8_t* data) {
    bp = data;
    c = 0;
    ct = 0;
  }
  int decode() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (*bp > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = *bp++;
          ct = 7;
        }
      } else {
        c = *bp++;
        ct = 8;
      }
    }
    --ct;
    return int(c >> ct & 1);
  }
};

// code-block style flags; predictable termination (16) changes nothing
// for a decoder; HT (64) selects Part 15's block coder
enum : int { kBypass = 1, kReset = 2, kTermAll = 4, kVsc = 8, kSegSym = 32,
             kHt = 64 };

struct CodewordSegment {
  int maxpasses, passes = 0;
  size_t len = 0;
};

// ------------------------------------------------------- tier 1: HT
// HT code-blocks (ITU-T T.814 | ISO/IEC 15444-15, Part 15), decoded as
// OpenJPEG 2.5's HT block decoder decodes them, so that PIL's pixels
// follow bit for bit, malformed blocks included:
//   - the cleanup segment of length Lcup ends in Scup, the length of its
//     MEL and VLC streams (2 <= Scup <= min(Lcup, 4079)); MagSgn is read
//     forward from its start (0xFF past its end), MEL forward from
//     Lcup - Scup (the byte before the last ORed with 0xF, 0xFF past it)
//     and VLC backward from byte Lcup - 2 (its high nibble first, zeros
//     past its start); SigProp forward and MagRef backward over the
//     second segment (zeros past either end);
//   - each reader's bit stuffing as OpenJPEG's readers apply it: in the
//     forward streams a byte after 0xFF gives 7 bits, in the backward
//     ones a byte whose low 7 bits are ones gives 7 after a byte above
//     0x8F, and the dropped top bit is ORed onto the next byte's first
//     (it is zero in a well-formed stream), MEL drops it;
//   - the cleanup pass over quad rows, quads in pairs (a last lone quad
//     without a partner): MEL events for quads of context 0 and, in the
//     first row, for pairs whose u_off are both set; the CxtVLC codeword
//     of each quad from T.814's tables (context from the left quad in
//     the first row, else from the row above and the left quad); the
//     U-VLC of the pair (prefix, prefix, suffix, suffix; the first row's
//     MEL and one-bit rules); kappa from the row above's exponents;
//     MagSgn values of U_q - e_k bits with e_1 as their top bit;
//   - SigProp over 4-row stripes in groups of four columns (the group's
//     significance bits, then its signs; the stripe below ignored under
//     the vertically causal style), MagRef over the stripes;
//   - OpenJPEG's values: sign and magnitude with a half-bin below the
//     last plane, bit planes counted as in tier 1 (p = numbps), then the
//     same dequantization as the other blocks;
//   - OpenJPEG's rules: at most 3 passes (placeholder passes raise), Mb
//     at most 30, the zero bit planes at most Mb - 1 (one pass only where
//     they are Mb - 1), a second pass with no bytes dropped, U_q at most
//     the zero bit planes + 2, no significant sample outside the block,
//     ROI refused, the MEL stream's first bytes checked as OpenJPEG's
//     aligned reader reads them, no limit of 109 passes.

// T.814's CxtVLC tables, one entry per codeword: (c_q << 23) | (rho << 19)
// | (u_off << 18) | (e_k << 14) | (e_1 << 10) | (codeword << 3) | length,
// the codeword's first bit its LSB; the first for the first quad row, the
// second for the others (as OpenJPEG 2.5.4's lookup tables hold them: the
// tables built below equal its own)
constexpr uint32_t kVlcRow0[] = {
    0x0080034, 0x00c45ff, 0x0100003, 0x0148bff, 0x018008d, 0x01c8aff,
    0x01cc4ff, 0x0200013, 0x025109e, 0x0280075, 0x02d111e, 0x02d447f,
    0x030001e, 0x034037f, 0x038017f, 0x03c806e, 0x03c8a7f, 0x0400023,
    0x04621ee, 0x04800ee, 0x04c016e, 0x050000d, 0x05621ae, 0x0568bbf,
    0x05801bf, 0x05c404e, 0x05c46bf, 0x06000f5, 0x06710ae, 0x067212e,
    0x06730bf, 0x068033f, 0x06c453f, 0x06d523f, 0x06f603f, 0x07003df,
    0x0748a5f, 0x076a02e, 0x07791df, 0x07802df, 0x07e64df, 0x07eeb5f,
    0x07f88ce, 0x07f9b9f, 0x07fc59f, 0x07fd14e, 0x07fd45f, 0x07fe1ce,
    0x07ff15f, 0x0800002, 0x0880074, 0x08c44ff, 0x0900034, 0x09489de,
    0x09800de, 0x09c01ee, 0x0a00054, 0x0a5115e, 0x0a8005e, 0x0ad119e,
    0x0ad47ff, 0x0b0009e, 0x0b4011e, 0x0b801ff, 0x0bc801e, 0x0bc8aff,
    0x0c00014, 0x0c620ee, 0x0c8016e, 0x0cc006e, 0x0d001ae, 0x0d620ae,
    0x0d68b7f, 0x0d8017f, 0x0dc408e, 0x0dc467f, 0x0e0000d, 0x0e6212e,
    0x0e7102e, 0x0e8007f, 0x0ec44bf, 0x0ed51ce, 0x0ef63bf, 0x0f001bf,
    0x0f48abf, 0x0f6a0ce, 0x0f7933f, 0x0f8003f, 0x0fe213f, 0x0fe884e,
    0x0fee14e, 0x0ff918e, 0x0ffc63f, 0x1000002, 0x1080074, 0x10c44de,
    0x1100034, 0x11489ff, 0x118015e, 0x11c459e, 0x11ccbff, 0x1200054,
    0x125105e, 0x128000d, 0x12d449e, 0x12d511e, 0x12d557f, 0x130001e,
    0x13402ff, 0x13800ff, 0x13c8b7f, 0x13cc48e, 0x13dd1bf, 0x1400014,
    0x146227f, 0x14801ee, 0x14c00ee, 0x150016e, 0x154006e, 0x158007f,
    0x15c81ae, 0x15c8bbf, 0x16000ae, 0x165112e, 0x16722bf, 0x16800bf,
    0x16e202e, 0x16f11ce, 0x16f473f, 0x170013f, 0x17480ce, 0x1748bdf,
    0x178023f, 0x17c444e, 0x17cc83f, 0x17dd18e, 0x17fc54e, 0x17fe1df,
    0x1800003, 0x1880024, 0x18c45ee, 0x1900065, 0x1948a7f, 0x19800ee,
    0x19c442e, 0x19ccbff, 0x1a000b5, 0x1a5116e, 0x1a80035, 0x1ad446e,
    0x1ad51ae, 0x1ad54d5, 0x1b001ff, 0x1b512ff, 0x1b588ff, 0x1b8037f,
    0x1bd90ae, 0x1bd997f, 0x1bdc52e, 0x1bdc87f, 0x1bdcfbf, 0x1c00055,
    0x1c6203f, 0x1c801ce, 0x1cc45bf, 0x1ce62bf, 0x1d000ce, 0x1d6214e,
    0x1d688bf, 0x1d8033f, 0x1dc463f, 0x1dcc84e, 0x1dec53f, 0x1dee3df,
    0x1e0018e, 0x1e5108e, 0x1e721df, 0x1e802df, 0x1ee64df, 0x1ef450e,
    0x1ef500e, 0x1ef555f, 0x1ef625f, 0x1ef735f, 0x1f0005f, 0x1f5109f,
    0x1f721f6, 0x1f7899f, 0x1f7939f, 0x1f8029f, 0x1fea876, 0x1fee71f,
    0x1ff991f, 0x1ffc4e5, 0x1ffc976, 0x1ffce1f, 0x1ffd015, 0x1ffd4f6,
    0x1ffe095, 0x1fff01f, 0x2000002, 0x2080074, 0x20c45ff, 0x2100034,
    0x21488de, 0x218015e, 0x21c89ee, 0x21cc7ff, 0x2200054, 0x22512ff,
    0x228005e, 0x22c019e, 0x230009e, 0x234011e, 0x23800ff, 0x23d001e,
    0x23d137f, 0x2400014, 0x24620ee, 0x248008e, 0x24c03bf, 0x250000d,
    0x256896e, 0x256a06e, 0x256a97f, 0x258027f, 0x25c01ae, 0x25ec87f,
    0x26000ae, 0x266212e, 0x26711bf, 0x26802bf, 0x26c402e, 0x26c443f,
    0x27000bf, 0x27511ce, 0x27720ce, 0x2778b3f, 0x278013f, 0x27dc84e,
    0x27ddbdf, 0x27e454e, 0x27e663f, 0x27ee18e, 0x27fd1df, 0x2800003,
    0x28800d5, 0x28c47ff, 0x2900055, 0x29488ee, 0x298016e, 0x29cc5ff,
    0x29cc9ce, 0x29cceff, 0x2a00095, 0x2a510ff, 0x2a8006e, 0x2ad11ae,
    0x2ad477f, 0x2b000ae, 0x2b4892e, 0x2b5917f, 0x2b8027f, 0x2bd902e,
    0x2bd9abf, 0x2bdc5bf, 0x2bdcbbf, 0x2bdcc7f, 0x2c00015, 0x2c620ce,
    0x2c80136, 0x2ce20bf, 0x2ce473f, 0x2d000e5, 0x2d6884e, 0x2d6a18e,
    0x2d6a94e, 0x2d8013f, 0x2de608e, 0x2de643f, 0x2dec7df, 0x2dec90e,
    0x2dece3f, 0x2e0000e, 0x2e621f6, 0x2e711df, 0x2e802df, 0x2ee60f6,
    0x2ee675f, 0x2ef455f, 0x2ef5176, 0x2ef54df, 0x2f0025f, 0x2f5985f,
    0x2f78876, 0x2f7929f, 0x2f7a1b6, 0x2f7a99f, 0x2f7b39f, 0x2f8009f,
    0x2fdd71f, 0x2fdd8b6, 0x2fdde1f, 0x2ff641f, 0x2ffc436, 0x2ffc825,
    0x2ffcfef, 0x2ffd065, 0x2ffe0a5, 0x2ffe9ef, 0x2fff11f, 0x3000003,
    0x3080024, 0x30c441e, 0x3100065, 0x314886e, 0x31800d5, 0x31cc4ee,
    0x31cc96e, 0x31ccdee, 0x3200055, 0x32511ff, 0x32801ae, 0x32c44ae,
    0x32d53ff, 0x330012e, 0x3348aff, 0x33590ff, 0x338037f, 0x33d902e,
    0x33d9a7f, 0x33dc5b6, 0x33dcbbf, 0x33dcd7f, 0x3400095, 0x346207f,
    0x34801ce, 0x34c45bf, 0x34e62bf, 0x35000ce, 0x354894e, 0x356a0bf,
    0x358033f, 0x35e444e, 0x35e663f, 0x35ec98e, 0x35ee3df, 0x35ee93f,
    0x360008e, 0x36711df, 0x367210e, 0x367303f, 0x36802df, 0x36d500e,
    0x36d559f, 0x36f20df, 0x36f475f, 0x370015f, 0x374885f, 0x3778a5f,
    0x377929f, 0x377a1f6, 0x377b39f, 0x378009f, 0x37d98f6, 0x37ee71f,
    0x37fa976, 0x37fc4e5, 0x37fc815, 0x37fcc76, 0x37fd136, 0x37fd51f,
    0x37fe036, 0x37ff0b6, 0x3800095, 0x388002e, 0x38c47ff, 0x39001ce,
    0x39489ff, 0x39802ff, 0x39cc57f, 0x39ccb7f, 0x39cccff, 0x3a0027f,
    0x3a5107f, 0x3a802bf, 0x3ac44ce, 0x3ad53bf, 0x3b001bf, 0x3b4014e,
    0x3b800bf, 0x3bd9b3f, 0x3bdc44e, 0x3bdca3f, 0x3bdcd3f, 0x3bdd03f,
    0x3bdd4df, 0x3c003df, 0x3c621df, 0x3c802df, 0x3cc018e, 0x3d0029f,
    0x3d4888e, 0x3d6a35f, 0x3d8015f, 0x3de665f, 0x3dec79f, 0x3dec90e,
    0x3decc5f, 0x3dee09f, 0x3dee99f, 0x3e0031f, 0x3e6211f, 0x3e7121f,
    0x3e8001f, 0x3ee67ef, 0x3ef440e, 0x3ef51f6, 0x3ef56ef, 0x3ef60ef,
    0x3ef71ef, 0x3f0036f, 0x3f5996f, 0x3f788f6, 0x3f793af, 0x3f7a076,
    0x3f7a86f, 0x3f7b26f, 0x3f800af, 0x3ffc404, 0x3ffc864, 0x3ffcc55,
    0x3ffd044, 0x3ffd4d5, 0x3ffd9b6, 0x3ffdeaf, 0x3ffe024, 0x3ffe576,
    0x3ffe815, 0x3ffed2f, 0x3fff0b6, 0x3fff5af, 0x3fffb2f, 0x3fffc35
};
constexpr uint32_t kVlcRows[] = {
    0x0080003, 0x00c453e, 0x0100033, 0x01488be, 0x018006d, 0x01c01de,
    0x0200013, 0x025103e, 0x02800ad, 0x02c015e, 0x030000d, 0x03403ff,
    0x03800ff, 0x03c00de, 0x0400023, 0x046202d, 0x04800cd, 0x04c009e,
    0x050004d, 0x056205e, 0x05689ff, 0x05802ff, 0x05c019e, 0x060008d,
    0x066211e, 0x067137f, 0x068007f, 0x06c001e, 0x070017f, 0x07501ee,
    0x075127f, 0x07803bf, 0x07c40ee, 0x07c45bf, 0x0800001, 0x088002c,
    0x08c47ff, 0x090004c, 0x09488ff, 0x09800ed, 0x09c45ff, 0x09ccaff,
    0x0a0006d, 0x0a511bf, 0x0a8001e, 0x0ac037f, 0x0b0017f, 0x0b4027f,
    0x0b8007f, 0x0bc03bf, 0x0c0000c, 0x0c620bf, 0x0c8005e, 0x0cc02bf,
    0x0d0019e, 0x0d4033f, 0x0d8013f, 0x0dc015f, 0x0e0009e, 0x0e4023f,
    0x0e8003f, 0x0ec03df, 0x0f001df, 0x0f402df, 0x0f800df, 0x0fd011e,
    0x0fd135f, 0x1000001, 0x108004c, 0x10c47ff, 0x110000c, 0x114891e,
    0x11801ee, 0x11c89ff, 0x11cc4ff, 0x12000ad, 0x12512ff, 0x128001e,
    0x12c037f, 0x130017f, 0x134027f, 0x138007f, 0x13c00bf, 0x140002d,
    0x14623bf, 0x14801bf, 0x14c02bf, 0x15000ee, 0x156896e, 0x156a33f,
    0x156abdf, 0x158013f, 0x15c003f, 0x15eca3f, 0x160006e, 0x16401df,
    0x16802df, 0x16c00df, 0x170035f, 0x175025f, 0x175115f, 0x178005f,
    0x17d139f, 0x17d459f, 0x17dca9f, 0x17fe09f, 0x1800002, 0x1880054,
    0x18c445e, 0x1900014, 0x194891e, 0x1980075, 0x19cc49e, 0x19cc99e,
    0x19ccfff, 0x1a000b5, 0x1a511ff, 0x1a8001e, 0x1ac45ee, 0x1ad50ff,
    0x1b000ee, 0x1b402ff, 0x1b8016e, 0x1bd117f, 0x1bd44f6, 0x1bdcb7f,
    0x1c00035, 0x1c6227f, 0x1c8006e, 0x1cc01ae, 0x1d000ae, 0x1d4892e,
    0x1d6a07f, 0x1d8002e, 0x1de21ce, 0x1dec7bf, 0x1dec8ce, 0x1deccbf,
    0x1e0014e, 0x1e4004e, 0x1e801bf, 0x1ed018e, 0x1ed12bf, 0x1f0033f,
    0x1f5113f, 0x1f7223f, 0x1f78b5f, 0x1f8008e, 0x1fd983f, 0x1fdcfdf,
    0x1fea2df, 0x1ffc5f6, 0x1ffc90e, 0x1ffd15f, 0x1ffd4df, 0x1ffe00e,
    0x1ffe9df, 0x2000001, 0x208006d, 0x20c47ff, 0x21000ad, 0x21489ff,
    0x21802ff, 0x21c037f, 0x220004c, 0x225111e, 0x228019e, 0x22c00ff,
    0x230009e, 0x234017f, 0x238027f, 0x23c02bf, 0x240000c, 0x246207f,
    0x24803bf, 0x24c01bf, 0x25000ee, 0x25400bf, 0x258033f, 0x25c035f,
    0x260002d, 0x267103f, 0x267223f, 0x267313f, 0x26803df, 0x26c01df,
    0x27002df, 0x274801e, 0x27488df, 0x278015f, 0x27c465f, 0x27cc1ee,
    0x27cc85f, 0x2800002, 0x28800f5, 0x28c45de, 0x2900055, 0x29489ff,
    0x29800de, 0x29c005e, 0x2a00014, 0x2a5115e, 0x2a80075, 0x2ad119e,
    0x2ad47ff, 0x2b0009e, 0x2b4037f, 0x2b8011e, 0x2bc80ae, 0x2bc8aff,
    0x2c000b5, 0x2c6201e, 0x2c801ee, 0x2cc00ff, 0x2d000ee, 0x2d4016e,
    0x2d8006e, 0x2dc41ae, 0x2dc467f, 0x2e00035, 0x2e5112e, 0x2e7217f,
    0x2e8002e, 0x2ec47bf, 0x2ed51ce, 0x2ef607f, 0x2f000ce, 0x2f48abf,
    0x2f6a00e, 0x2f791bf, 0x2f800d5, 0x2fdd93f, 0x2fe64bf, 0x2ff573f,
    0x2ffc54e, 0x2ffc90e, 0x2ffcc3f, 0x2ffd18e, 0x2ffe08e, 0x2ffea3f,
    0x2fff04e, 0x3000003, 0x3080014, 0x30c441e, 0x3100064, 0x31489ee,
    0x31800ee, 0x31c886e, 0x31cc7ff, 0x3200024, 0x325116e, 0x3280055,
    0x32d11ae, 0x32d457f, 0x33000ae, 0x33489ff, 0x33592ff, 0x338012e,
    0x33c894e, 0x33cc4ff, 0x33dd37f, 0x34000b5, 0x346202e, 0x34801ce,
    0x34c00ce, 0x3500035, 0x356884e, 0x356a27f, 0x356a87f, 0x3580076,
    0x35c89bf, 0x35ea2bf, 0x35ec63f, 0x35ecbbf, 0x36000d5, 0x367113f,
    0x367233f, 0x36730bf, 0x368018e, 0x36d13df, 0x36f21df, 0x36f455f,
    0x36f503f, 0x370008e, 0x37510df, 0x377899f, 0x37792df, 0x377a10e,
    0x377ab5f, 0x378000e, 0x37cce5f, 0x37dd85f, 0x37ee69f, 0x37fc51f,
    0x37fc9f6, 0x37fd176, 0x37fd49f, 0x37fe0f6, 0x37feb9f, 0x37ff31f,
    0x3800024, 0x388019e, 0x38c449e, 0x390011e, 0x3948bff, 0x398001e,
    0x39c45ff, 0x39ccb7f, 0x3a0016e, 0x3a512ff, 0x3a800b5, 0x3ac45ee,
    0x3ad50ff, 0x3b000ee, 0x3b403bf, 0x3b80035, 0x3bd127f, 0x3bdc46e,
    0x3bdcabf, 0x3bdcc7f, 0x3bdd17f, 0x3c001ae, 0x3c621bf, 0x3c800ae,
    0x3cc013f, 0x3d0012e, 0x3d4014e, 0x3d800d5, 0x3dc473f, 0x3dcc82e,
    0x3dec4bf, 0x3dee3df, 0x3e001ce, 0x3e400ce, 0x3e80065, 0x3ec443f,
    0x3ed504e, 0x3ef463f, 0x3ef60df, 0x3f0018e, 0x3f48adf, 0x3f6a1f6,
    0x3f789df, 0x3f7905f, 0x3f80003, 0x3fdd90e, 0x3fee4f6, 0x3ffc415,
    0x3ffc855, 0x3ffcc8e, 0x3ffd0e5, 0x3ffd576, 0x3ffdd5f, 0x3ffe095,
    0x3ffe80e, 0x3ffee5f, 0x3fff076, 0x3ffff5f
};

// the tables indexed by (c_q << 7) | the next 7 VLC bits: (e_k << 12) |
// (e_1 << 8) | (rho << 4) | (u_off << 3) | codeword length
struct HtLut {
  uint16_t vlc[2][1024];
  HtLut() {
    const uint32_t* src[2] = {kVlcRow0, kVlcRows};
    size_t n[2] = {sizeof kVlcRow0 / sizeof *kVlcRow0,
                   sizeof kVlcRows / sizeof *kVlcRows};
    for (int t = 0; t < 2; ++t) {
      std::fill(vlc[t], vlc[t] + 1024, uint16_t(0));
      for (size_t i = 0; i < n[t]; ++i) {
        uint32_t e = src[t][i];
        int cq = int(e >> 23), len = int(e & 7), cwd = int(e >> 3 & 127);
        auto v = uint16_t((e >> 14 & 15) << 12 | (e >> 10 & 15) << 8 |
                          (e >> 19 & 15) << 4 | (e >> 18 & 1) << 3 |
                          uint32_t(len));
        for (int j = 0; j < 1 << (7 - len); ++j)
          vlc[t][(cq << 7) | (j << len) | cwd] = v;
      }
    }
  }
};

const HtLut& ht_lut() {
  static const HtLut lut;  // built once, thread-safe
  return lut;
}

// forward streams (MagSgn, SigProp), LSB first
struct HtFwd {
  const uint8_t* d = nullptr;
  int64_t n = 0, i = 0;
  uint64_t fill = 0, tmp = 0;
  int bits = 0;
  bool unstuff = false;
  void init(const uint8_t* data, int64_t size, uint8_t x) {
    d = data;
    n = size;
    i = 0;
    fill = x;
    tmp = 0;
    bits = 0;
    unstuff = false;
  }
  uint32_t fetch() {
    while (bits < 32) {
      uint64_t b = i < n ? d[i] : fill;
      ++i;
      tmp |= b << bits;
      bits += unstuff ? 7 : 8;
      unstuff = b == 0xFF;
    }
    return uint32_t(tmp);
  }
  void advance(int k) {
    tmp >>= k;
    bits -= k;
  }
};

// backward streams (VLC, MagRef), LSB first, from d[pos] down
struct HtRev {
  const uint8_t* d = nullptr;
  int64_t pos = 0, left = 0;
  uint64_t tmp = 0;
  int bits = 0;
  bool unstuff = false;
  uint32_t fetch() {
    while (bits < 32) {
      uint64_t b = 0;
      if (left > 0) {
        b = d[pos--];
        --left;
      }
      tmp |= b << bits;
      bits += unstuff && (b & 0x7F) == 0x7F ? 7 : 8;
      unstuff = b > 0x8F;
    }
    return uint32_t(tmp);
  }
  void advance(int k) {
    tmp >>= k;
    bits -= k;
  }
};

// the MEL stream, MSB first, and its adaptive run decoder; a run is
// (zeros << 1) | 1 where it ends in an event, else (2^e - 1) << 1 for
// 2^e zeros (OpenJPEG's encoding of runs)
struct HtMel {
  const uint8_t* d = nullptr;
  int64_t i = 0, left = 0;
  uint32_t cur = 0;
  int bits = 0, k = 0;
  bool unstuff = false;
  void init(const uint8_t* data, int64_t start, int64_t size) {
    d = data;
    i = start;
    left = size;
    bits = k = 0;
    unstuff = false;
  }
  int bit() {
    if (bits == 0) {
      uint32_t b = left > 0 ? d[i] : 0xFF;
      if (left == 1) b |= 0xF;
      if (left > 0) ++i;
      --left;
      bits = unstuff ? 7 : 8;
      cur = b & ((1u << bits) - 1);
      unstuff = b == 0xFF;
    }
    --bits;
    return int(cur >> bits & 1);
  }
  int run() {
    static constexpr int kExp[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};
    int e = kExp[k];
    if (bit()) {
      k = std::min(k + 1, 12);
      return ((1 << e) - 1) << 1;
    }
    int r = 0;
    for (int j = 0; j < e; ++j) r = (r << 1) | bit();
    k = std::max(k - 1, 0);
    return (r << 1) + 1;
  }
};

// OpenJPEG's mel_init reads the first 4 - (address & 3) bytes of the MEL
// stream one at a time and fails on one above 0x8F after 0xFF; `addr` is
// the block's data address mod 4 (the packet's offset in the tile's data
// for a block in one chunk, 0 for one copied from several)
bool ht_mel_start_ok(const uint8_t* cd, int64_t start, int64_t size,
                     int64_t addr) {
  int num = 4 - int((addr + start) & 3);
  bool unstuff = false;
  int64_t pos = start, left = size;
  for (int j = 0; j < num; ++j) {
    if (unstuff && cd[pos] > 0x8F) return false;
    uint32_t b = left > 0 ? cd[pos] : 0xFF;
    if (left == 1) b |= 0xF;
    if (left > 0) ++pos;
    --left;
    unstuff = b == 0xFF;
  }
  return true;
}

// OpenJPEG's U-VLC prefixes by the next three bits: prefix length, suffix
// length << 2, u_pfx << 5
constexpr uint8_t kUvlc[8] = {3 | 5 << 2 | 5 << 5, 1 | 0 << 2 | 1 << 5,
                              2 | 0 << 2 | 2 << 5, 1 | 0 << 2 | 1 << 5,
                              3 | 1 << 2 | 3 << 5, 1 | 0 << 2 | 1 << 5,
                              2 | 0 << 2 | 2 << 5, 1 | 0 << 2 | 1 << 5};

// the pair's U-VLC: u[k] = u_q + 1 of each quad (1 without u_off); mode:
// u_off bits, 4 for the first row's pair with its MEL event set (u_q -
// 2 coded); `first`: the first row's one-bit rule; returns the bits used
int ht_uvlc(uint32_t vlc, int mode, bool first, uint32_t u[2]) {
  int used = 0;
  auto prefix = [&]() {
    uint32_t d = kUvlc[vlc & 7];
    vlc >>= d & 3;
    used += int(d & 3);
    return d;
  };
  auto suffix = [&](uint32_t d) {
    uint32_t n = d >> 2 & 7;
    uint32_t v = (d >> 5) + (vlc & ((1u << n) - 1));
    vlc >>= n;
    used += int(n);
    return v;
  };
  u[0] = u[1] = 1;
  if (mode == 1 || mode == 2) {
    u[mode - 1] = suffix(prefix()) + 1;
  } else if (mode == 3 && first) {
    uint32_t d1 = prefix();
    if ((d1 & 3) > 2) {
      u[1] = (vlc & 1) + 2;
      vlc >>= 1;
      ++used;
      u[0] = suffix(d1) + 1;
    } else {
      uint32_t d2 = prefix();
      u[0] = suffix(d1) + 1;
      u[1] = suffix(d2) + 1;
    }
  } else if (mode >= 3) {
    uint32_t d1 = prefix(), d2 = prefix();
    uint32_t add = mode == 4 ? 3 : 1;
    u[0] = suffix(d1) + add;
    u[1] = suffix(d2) + add;
  }
  return used;
}

struct HtT1 {
  int w = 0, h = 0, pw = 0, ph = 0;
  std::vector<int32_t> data;   // the block, as T1 gives it
  std::vector<uint32_t> val;   // sign and magnitude, padded to whole quads
  std::vector<uint8_t> ex;     // exponents E (bit length of 2 mu - 1)
  std::vector<uint8_t> sig;    // cleanup significance, padded
  std::vector<uint8_t> nsig;   // SigProp's new significance
  std::vector<std::pair<int, int>> signs;

  uint8_t s(int y, int x) const {
    return x < 0 || y < 0 ? 0 : sig[size_t(y) * pw + x];
  }

  // a block of `numbps` planes below `mb`, its first two codeword
  // segments' passes and lengths, the bytes of all its chunks (at least
  // one segment), `addr` as in ht_mel_start_ok
  void decode(int cw, int ch, int mb, int numbps, int style,
              const std::vector<CodewordSegment>& segs,
              const std::vector<uint8_t>& bytes, int64_t addr) {
    w = cw;
    h = ch;
    data.assign(size_t(w) * h, 0);
    // `bytes` holds every segment's bytes: the first two segments fit
    int passes = segs[0].passes + (segs.size() > 1 ? segs[1].passes : 0);
    int64_t len1 = int64_t(segs[0].len);
    int64_t len2 = passes > 1 && segs.size() > 1 ? int64_t(segs[1].len) : 0;
    if (passes > 1 && len2 == 0) passes = 1;  // OpenJPEG warns
    if (passes > 3)
      fail("HT code-block with " + std::to_string(passes) +
           " coding passes (placeholder passes: at most 3 are supported)");
    if (mb > 30)
      fail("HT code-block with " + std::to_string(mb) +
           " bit planes (at most 30)");
    int zbp1 = mb + 1 - numbps;  // the zero bit planes + 1
    if (zbp1 > mb)
      fail("malformed HT code-block: " + std::to_string(zbp1 - 1) +
           " zero bit planes of " + std::to_string(mb));
    if (zbp1 == mb && passes > 1) passes = 1;  // nothing below the cleanup
    int p = numbps;
    if (len1 < 2)
      fail("malformed HT code-block: a cleanup segment of " +
           std::to_string(len1) + " bytes");
    const uint8_t* cd = bytes.data();
    int64_t lcup = len1;
    int64_t scup = (int64_t(cd[lcup - 1]) << 4) + (cd[lcup - 2] & 0xF);
    if (scup < 2 || scup > lcup || scup > 4079)
      fail("malformed HT code-block: Scup " + std::to_string(scup) +
           " out of range (2 <= Scup <= min(Lcup, 4079))");
    if (!ht_mel_start_ok(cd, lcup - scup, scup - 1, addr))
      fail("malformed HT code-block: incorrect MEL segment sequence");
    cleanup(cd, lcup, scup, p, zbp1 + 1);
    if (passes > 1) sigprop(cd + lcup, len2, p, style & kVsc);
    if (passes > 2) magref(cd, lcup + len2, len2, p);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        uint32_t v = val[size_t(y) * pw + x];
        auto mag = int32_t(v & 0x7FFFFFFF);
        data[size_t(y) * w + x] = v >> 31 ? -mag : mag;
      }
  }

  void cleanup(const uint8_t* cd, int64_t lcup, int64_t scup, int p,
               int umax) {
    const HtLut& lut = ht_lut();
    int qw = (w + 1) / 2, qh = (h + 1) / 2;
    pw = 2 * qw + 1;  // the row above is read up to column qx + 2
    ph = 2 * qh;
    val.assign(size_t(pw) * ph, 0);
    ex.assign(size_t(pw) * ph, 0);
    sig.assign(size_t(pw) * ph, 0);
    HtFwd ms;
    ms.init(cd, lcup - scup, 0xFF);
    HtMel mel;
    mel.init(cd, lcup - scup, scup - 1);
    HtRev vlc;
    vlc.d = cd;
    uint32_t b0 = cd[lcup - 2];
    vlc.tmp = b0 >> 4;
    vlc.bits = 4 - ((vlc.tmp & 7) == 7);
    vlc.unstuff = (b0 | 0xF) > 0x8F;
    vlc.pos = lcup - 3;
    vlc.left = scup - 2;
    int run = mel.run();
    auto mel_event = [&]() {
      run -= 2;
      bool one = run == -1;
      if (run < 0) run = mel.run();
      return one;
    };
    for (int qy = 0; qy < qh; ++qy) {
      bool first = qy == 0;
      const uint16_t* tab = lut.vlc[first ? 0 : 1];
      int y = 2 * qy;
      uint32_t rho_left = 0;
      for (int x = 0; x < 2 * qw; x += 4) {
        int nq = x + 2 < w ? 2 : 1;
        uint32_t qinf[2] = {0, 0};
        for (int k = 0; k < nq; ++k) {
          int qx = x + 2 * k;
          uint32_t c;
          if (first) {
            c = (rho_left & 1) | (rho_left >> 1 & 1) |
                (rho_left >> 2 & 1) << 1 | (rho_left >> 3 & 1) << 2;
          } else {
            c = uint32_t(s(y - 1, qx - 1) | s(y - 1, qx)) |
                uint32_t(s(y, qx - 1) | s(y + 1, qx - 1)) << 1 |
                uint32_t(s(y - 1, qx + 1) | s(y - 1, qx + 2)) << 2;
          }
          uint32_t t = tab[c << 7 | (vlc.fetch() & 0x7F)];
          if (c == 0 && !mel_event()) t = 0;
          vlc.advance(int(t & 7));
          qinf[k] = t;
          rho_left = t >> 4 & 15;
          if (((qx + 1 >= w) && (rho_left & 0xC)) ||
              ((y + 1 >= h) && (rho_left & 0xA)))
            fail("malformed HT code-block: significant samples outside the "
                 "code-block");
          for (int n = 0; n < 4; ++n)
            if (rho_left >> n & 1)
              sig[size_t(y + (n & 1)) * pw + qx + (n >> 1)] = 1;
        }
        int mode = int(qinf[0] >> 3 & 1) | int(qinf[1] >> 3 & 1) << 1;
        if (first && mode == 3 && mel_event()) mode = 4;
        uint32_t u[2];
        vlc.advance(ht_uvlc(vlc.fetch(), mode, first, u));
        for (int k = 0; k < nq; ++k) {
          int qx = x + 2 * k;
          uint32_t rho = qinf[k] >> 4 & 15;
          uint32_t uq = u[k];
          if (!first) {
            uint32_t kappa = 1;
            if (rho & (rho - 1)) {
              int emax = 0;
              for (int xx = std::max(0, qx - 1); xx <= qx + 2; ++xx)
                emax = std::max(emax, int(ex[size_t(y - 1) * pw + xx]));
              kappa = uint32_t(std::max(1, emax - 1));
            }
            uq += kappa - 1;
          }
          if (uq > uint32_t(umax))
            fail("malformed HT code-block: U_q " + std::to_string(uq) +
                 " above the zero bit planes + 2");
          for (int n = 0; n < 4; ++n) {
            if (!(rho >> n & 1)) continue;
            uint32_t v = ms.fetch();
            int m = int(uq) - int(qinf[k] >> (12 + n) & 1);
            ms.advance(m);
            uint32_t vn = v & ((uint32_t(1) << m) - 1);
            vn |= (qinf[k] >> (8 + n) & 1) << m;
            vn |= 1;
            size_t at = size_t(y + (n & 1)) * pw + qx + (n >> 1);
            val[at] = v << 31 | (vn + 2) << (p - 1);
            ex[at] = uint8_t(32 - __builtin_clz(vn));
          }
        }
      }
    }
  }

  void sigprop(const uint8_t* seg, int64_t len, int p, bool causal) {
    HtFwd sp;
    sp.init(seg, len, 0);
    nsig.assign(size_t(w) * h, 0);
    auto next = [&]() {
      uint32_t v = sp.fetch() & 1;
      sp.advance(1);
      return v;
    };
    for (int y0 = 0; y0 < h; y0 += 4) {
      int y1 = std::min(y0 + 4, h);
      for (int x0 = 0; x0 < w; x0 += 4) {
        signs.clear();
        for (int x = x0; x < std::min(x0 + 4, w); ++x)
          for (int y = y0; y < y1; ++y) {
            if (sig[size_t(y) * pw + x]) continue;
            bool member = false;
            for (int dy = -1; dy <= 1 && !member; ++dy)
              for (int dx = -1; dx <= 1 && !member; ++dx) {
                int yy = y + dy, xx = x + dx;
                if ((dy == 0 && dx == 0) || yy < 0 || xx < 0 || yy >= ph)
                  continue;
                if (sig[size_t(yy) * pw + xx] &&
                    !(causal && yy >= y0 + 4))
                  member = true;
                else if (yy < h && xx < w && nsig[size_t(yy) * w + xx])
                  member = true;
              }
            if (member && next()) {
              nsig[size_t(y) * w + x] = 1;
              signs.emplace_back(y, x);
            }
          }
        for (auto [y, x] : signs)
          val[size_t(y) * pw + x] = next() << 31 | 3u << (p - 2);
      }
    }
  }

  void magref(const uint8_t* cd, int64_t end, int64_t len, int p) {
    HtRev mr;
    mr.d = cd;
    mr.pos = end - 1;
    mr.left = len;
    mr.unstuff = true;
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < std::min(y0 + 4, h); ++y) {
          if (!sig[size_t(y) * pw + x]) continue;
          uint32_t b = mr.fetch() & 1;
          mr.advance(1);
          uint32_t& v = val[size_t(y) * pw + x];
          v ^= (b ^ 1) << (p - 1);
          v |= 1u << (p - 2);
        }
  }
};


struct T1 {
  int w = 0, h = 0, fs = 0;
  bool vsc = false;
  HtT1 ht;
  std::vector<int32_t> data;
  std::vector<uint32_t> flags;
  std::vector<uint8_t> seg;
  Mq mq;
  Raw raw;

  uint32_t& fl(int x, int y) { return flags[size_t(y + 1) * fs + x + 1]; }

  void set_sig(int x, int y, int neg) {
    uint32_t* f = &fl(x, y);
    *f |= F_SIG;
    // vertically causal: the stripe above never learns of its south
    // neighbours in this one
    if (!(vsc && (y & 3) == 0)) {
      f[-fs - 1] |= F_SE;
      f[-fs] |= F_S | (neg ? uint32_t(F_SGN_S) : 0u);
      f[-fs + 1] |= F_SW;
    }
    f[-1] |= F_E | (neg ? uint32_t(F_SGN_E) : 0u);
    f[1] |= F_W | (neg ? uint32_t(F_SGN_W) : 0u);
    f[fs - 1] |= F_NE;
    f[fs] |= F_N | (neg ? uint32_t(F_SGN_N) : 0u);
    f[fs + 1] |= F_NW;
  }

  int decode_sign(uint32_t f) {
    int i = (!!(f & F_N)) | (!!(f & F_S)) << 1 | (!!(f & F_W)) << 2 |
            (!!(f & F_E)) << 3 | (!!(f & F_SGN_N)) << 4 |
            (!!(f & F_SGN_S)) << 5 | (!!(f & F_SGN_W)) << 6 |
            (!!(f & F_SGN_E)) << 7;
    int e = luts().sc[i];
    return mq.decode(kCtxSc + (e & 15)) ^ (e >> 4);
  }

  template <bool kRaw>
  void sigpass(int bp, const uint8_t* zc) {
    int32_t oph = (1 << bp) | (1 << bp >> 1);
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < std::min(y0 + 4, h); ++y) {
          uint32_t f = fl(x, y);
          if (!(f & (F_SIG | F_VISIT)) && (f & 0xFF)) {
            if (kRaw ? raw.decode() : mq.decode(zc[f & 0xFF])) {
              int neg = kRaw ? raw.decode() : decode_sign(f);
              data[size_t(y) * w + x] = neg ? -oph : oph;
              set_sig(x, y, neg);
            }
            fl(x, y) |= F_VISIT;
          }
        }
  }

  template <bool kRaw>
  void refpass(int bp) {
    int32_t half = (1 << bp) >> 1;
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < std::min(y0 + 4, h); ++y) {
          uint32_t& f = fl(x, y);
          if ((f & (F_SIG | F_VISIT)) == F_SIG) {
            int v;
            if (kRaw) {
              v = raw.decode();
            } else {
              int cx = (f & F_REFINE) ? kCtxMag + 2
                                      : (f & 0xFF) ? kCtxMag + 1 : kCtxMag;
              v = mq.decode(cx);
            }
            int32_t& d = data[size_t(y) * w + x];
            d += (v ^ (d < 0)) ? half : -half;
            f |= F_REFINE;
          }
        }
  }

  void clnpass(int bp, const uint8_t* zc, bool segsym) {
    int32_t oph = (1 << bp) | (1 << bp >> 1);
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        int y1 = std::min(y0 + 4, h);
        int ystart = y0;
        if (y1 - y0 == 4) {
          uint32_t agg = 0;
          for (int y = y0; y < y1; ++y)
            agg |= fl(x, y) & (F_SIG | F_VISIT | 0xFF);
          if (!agg) {
            if (!mq.decode(kCtxRl)) continue;
            int run = mq.decode(kCtxUni) << 1;
            run |= mq.decode(kCtxUni);
            int y = y0 + run;
            int neg = decode_sign(fl(x, y));
            data[size_t(y) * w + x] = neg ? -oph : oph;
            set_sig(x, y, neg);
            ystart = y + 1;
          }
        }
        for (int y = ystart; y < y1; ++y) {
          uint32_t f = fl(x, y);
          if (!(f & (F_SIG | F_VISIT))) {
            if (mq.decode(zc[f & 0xFF])) {
              int neg = decode_sign(f);
              data[size_t(y) * w + x] = neg ? -oph : oph;
              set_sig(x, y, neg);
            }
          }
        }
        for (int y = y0; y < y1; ++y) fl(x, y) &= ~F_VISIT;
      }
    if (segsym) {  // the four symbols 1010, read and not checked
      for (int i = 0; i < 4; ++i) mq.decode(kCtxUni);
    }
  }

  // decodes a code-block of `numbps` bit planes from its codeword
  // segments (concatenated in `bytes`), then undoes the ROI shift
  void decode(int cw, int ch, int orient, int numbps, int roishift,
              int style, const std::vector<CodewordSegment>& segs,
              const std::vector<uint8_t>& bytes) {
    w = cw;
    h = ch;
    fs = w + 2;
    vsc = style & kVsc;
    data.assign(size_t(w) * h, 0);
    flags.assign(size_t(fs) * (h + 2), 0);
    mq.reset_contexts();
    const uint8_t* zc = luts().zc[orient];
    int bp = numbps + roishift, type = 2;
    if (bp >= 31)
      fail("code-block with " + std::to_string(bp) +
           " bit planes (at most 30)");
    size_t at = 0;
    for (const CodewordSegment& sg : segs) {
      if (bp < 1) break;
      // each segment ends in OpenJPEG's artificial 0xFF 0xFF
      seg.assign(bytes.begin() + long(at), bytes.begin() + long(at + sg.len));
      at += sg.len;
      seg.push_back(0xFF);
      seg.push_back(0xFF);
      bool is_raw = (style & kBypass) && type < 2 && bp <= numbps - 4;
      if (is_raw)
        raw.init(seg.data());
      else
        mq.init(seg.data(), sg.len);
      for (int p = 0; p < sg.passes && bp >= 1; ++p) {
        if (type == 0) {
          if (is_raw) sigpass<true>(bp, zc);
          else sigpass<false>(bp, zc);
        } else if (type == 1) {
          if (is_raw) refpass<true>(bp);
          else refpass<false>(bp);
        } else {
          clnpass(bp, zc, style & kSegSym);
        }
        if ((style & kReset) && !is_raw) mq.reset_contexts();
        if (++type == 3) {
          type = 0;
          --bp;
        }
      }
    }
    if (roishift) {
      int32_t thresh = int32_t(1) << roishift;
      for (int32_t& v : data) {
        int32_t mag = v < 0 ? -v : v;
        if (mag >= thresh) {
          mag >>= roishift;
          v = v < 0 ? -mag : mag;
        }
      }
    }
  }
};

// --------------------------------------------------------- tile model
struct Cblk {
  int64_t x0, y0, x1, y1;
  bool included = false;
  int numbps = 0, lblock = 3, passes = 0;
  int chunks = 0;      // packet parts read, empty ones too
  int64_t first = 0;   // the first one's offset in the tile's data
  std::vector<CodewordSegment> segs;
  std::vector<uint8_t> bytes;
};

struct Prec {
  int cw = 0, ch = 0;
  std::vector<Cblk> cb;
  TagTree incl, imsb;
};

struct Band {
  int bandno = 0;
  int64_t x0, y0, x1, y1;
  int mb = 0;
  float step = 0;  // 0.5f * step size (9/7)
  std::vector<Prec> prec;
  bool empty() const { return x0 >= x1 || y0 >= y1; }
};

struct Res {
  int64_t x0, y0, x1, y1;
  int pdx, pdy, pw = 0, ph = 0, nb = 0;
  Band band[3];
};

struct TileComp {
  int64_t x0, y0, x1, y1;  // on the component's grid: the tile / (dx, dy)
  int dx = 1, dy = 1;
  Spc spc;
  Quant q;
  bool sgnd = false;
  int prec = 8;
  int roishift = 0;
  std::vector<Res> res;
  std::vector<int32_t> idata;
  std::vector<float> fdata;
  int64_t width() const { return x1 - x0; }
  int64_t height() const { return y1 - y0; }
};

void build_comp(TileComp& tc, int64_t& nprec_total) {
  const Spc& s = tc.spc;
  const Quant& q = tc.q;
  int nl = s.nl;
  tc.res.resize(size_t(nl + 1));
  for (int r = 0; r <= nl; ++r) {
    Res& R = tc.res[size_t(r)];
    int lev = nl - r;
    R.x0 = ceildivpow2(tc.x0, lev);
    R.y0 = ceildivpow2(tc.y0, lev);
    R.x1 = ceildivpow2(tc.x1, lev);
    R.y1 = ceildivpow2(tc.y1, lev);
    R.pdx = s.ppx[r];
    R.pdy = s.ppy[r];
    int64_t px0 = floordivpow2(R.x0, R.pdx) << R.pdx;
    int64_t py0 = floordivpow2(R.y0, R.pdy) << R.pdy;
    int64_t px1 = ceildivpow2(R.x1, R.pdx) << R.pdx;
    int64_t py1 = ceildivpow2(R.y1, R.pdy) << R.pdy;
    R.pw = R.x0 == R.x1 ? 0 : int((px1 - px0) >> R.pdx);
    R.ph = R.y0 == R.y1 ? 0 : int((py1 - py0) >> R.pdy);
    int64_t np = int64_t(R.pw) * R.ph;
    nprec_total += np;
    if (nprec_total > kMaxPrecincts) fail("too many precincts in a tile");
    int64_t cbgx0, cbgy0;
    int cbgw, cbgh;
    if (r == 0) {
      cbgx0 = px0;
      cbgy0 = py0;
      cbgw = R.pdx;
      cbgh = R.pdy;
      R.nb = 1;
    } else {
      cbgx0 = ceildivpow2(px0, 1);
      cbgy0 = ceildivpow2(py0, 1);
      cbgw = R.pdx - 1;
      cbgh = R.pdy - 1;
      R.nb = 3;
    }
    int cbw = std::min(s.cbw, cbgw), cbh = std::min(s.cbh, cbgh);
    for (int bi = 0; bi < R.nb; ++bi) {
      Band& B = R.band[bi];
      B.bandno = r == 0 ? 0 : bi + 1;
      if (r == 0) {
        B.x0 = R.x0;
        B.y0 = R.y0;
        B.x1 = R.x1;
        B.y1 = R.y1;
      } else {
        int nb = nl - r + 1;
        int64_t ox = (B.bandno & 1) ? int64_t(1) << (nb - 1) : 0;
        int64_t oy = (B.bandno & 2) ? int64_t(1) << (nb - 1) : 0;
        B.x0 = ceildivpow2(tc.x0 - ox, nb);
        B.y0 = ceildivpow2(tc.y0 - oy, nb);
        B.x1 = ceildivpow2(tc.x1 - ox, nb);
        B.y1 = ceildivpow2(tc.y1 - oy, nb);
      }
      int idx = r == 0 ? 0 : 3 * (r - 1) + bi + 1;
      int expn, mant;
      if (q.style == 1) {
        expn = std::max(0, int(q.expn[0]) - (idx - 1) / 3);  // idx 0: eps0
        mant = q.mant[0];
      } else {
        if (idx >= q.nsteps)
          fail("QCD/QCC gives " + std::to_string(q.nsteps) +
               " step sizes, the decomposition needs " +
               std::to_string(3 * nl + 1));
        expn = q.expn[idx];
        mant = q.mant[idx];
      }
      B.mb = expn + q.guard - 1;
      if (s.qmfbid == 0) {
        // (1 + mu / 2^11) * 2^(R - eps) in double, cast to float: R is
        // the precision alone, with no band gain, for the irreversible
        // path (OpenJPEG compensates its 9/7 high-band scale there)
        float st = float((1.0 + mant / 2048.0) *
                         std::pow(2.0, tc.prec - expn));
        B.step = 0.5f * st;
      }
      B.prec.resize(size_t(np));
      if (B.empty()) continue;
      for (int64_t p = 0; p < np; ++p) {
        Prec& P = B.prec[size_t(p)];
        int64_t gx0 = cbgx0 + ((p % R.pw) << cbgw);
        int64_t gy0 = cbgy0 + ((p / R.pw) << cbgh);
        int64_t qx0 = std::max(gx0, B.x0), qy0 = std::max(gy0, B.y0);
        int64_t qx1 = std::min(gx0 + (int64_t(1) << cbgw), B.x1);
        int64_t qy1 = std::min(gy0 + (int64_t(1) << cbgh), B.y1);
        if (qx0 >= qx1 || qy0 >= qy1) continue;
        int64_t bx0 = floordivpow2(qx0, cbw) << cbw;
        int64_t by0 = floordivpow2(qy0, cbh) << cbh;
        int64_t bx1 = ceildivpow2(qx1, cbw) << cbw;
        int64_t by1 = ceildivpow2(qy1, cbh) << cbh;
        P.cw = int((bx1 - bx0) >> cbw);
        P.ch = int((by1 - by0) >> cbh);
        P.cb.resize(size_t(P.cw) * P.ch);
        for (int j = 0; j < P.ch; ++j)
          for (int i = 0; i < P.cw; ++i) {
            Cblk& C = P.cb[size_t(j) * P.cw + i];
            int64_t cx0 = bx0 + (int64_t(i) << cbw);
            int64_t cy0 = by0 + (int64_t(j) << cbh);
            C.x0 = std::max(cx0, qx0);
            C.y0 = std::max(cy0, qy0);
            C.x1 = std::min(cx0 + (int64_t(1) << cbw), qx1);
            C.y1 = std::min(cy0 + (int64_t(1) << cbh), qy1);
          }
        P.incl.init(P.cw, P.ch);
        P.imsb.init(P.cw, P.ch);
      }
    }
  }
}

// ------------------------------------------------------------- tier 2
// a new codeword segment's pass capacity (OpenJPEG's opj_t2_init_seg):
// one pass each with termall; with bypass, 10 MQ passes, then raw
// significance + refinement pairs and MQ cleanups in turn
int seg_maxpasses(int style, const std::vector<CodewordSegment>& segs) {
  if (style & kTermAll) return 1;
  if (style & kBypass) {
    if (segs.empty()) return 10;
    int prev = segs.back().maxpasses;
    return prev == 1 || prev == 10 ? 2 : 1;
  }
  return 109;
}

// reads each packet's header from the tile's data or, with PPM or PPT,
// from the packed headers `h` at `*hpos`, and its body from the tile's data
struct PacketReader {
  const std::vector<uint8_t>& d;
  size_t pos = 0;
  const std::vector<uint8_t>& h;
  size_t& hp;
  bool sop, eph;
  PacketReader(const std::vector<uint8_t>& d_, const std::vector<uint8_t>* h_,
               size_t* hpos, bool sop_, bool eph_)
      : d(d_), h(h_ ? *h_ : d_), hp(h_ ? *hpos : pos), sop(sop_),
        eph(eph_) {}

  void read(TileComp& tc, int r, int p, int layer) {
    Res& R = tc.res[size_t(r)];
    int style = tc.spc.cbstyle;
    if (sop && d.size() - pos >= 6 && d[pos] == 0xFF && d[pos + 1] == 0x91)
      pos += 6;
    Bio bio(h.data() + hp, h.size() - hp);
    struct Part {  // bytes of this packet for one codeword segment
      Cblk* cb;
      size_t seg;
      int passes;
      uint32_t len;
    };
    std::vector<Part> parts;
    if (bio.bit()) {
      for (int bi = 0; bi < R.nb; ++bi) {
        Band& B = R.band[bi];
        if (B.empty()) continue;
        Prec& P = B.prec[size_t(p)];
        for (int k = 0; k < P.cw * P.ch; ++k) {
          Cblk& C = P.cb[size_t(k)];
          bool inc;
          if (!C.included)
            inc = bio.tag_decode(P.incl, k, layer + 1);
          else
            inc = bio.bit();
          if (!inc) continue;
          if (!C.included) {
            int i = 0;
            while (!bio.tag_decode(P.imsb, k, i)) {
              if (++i > 64) fail("corrupt packet header (zero bit planes)");
            }
            C.numbps = B.mb + 1 - i;
            C.included = true;
          }
          int np;
          if (!bio.bit()) np = 1;
          else if (!bio.bit()) np = 2;
          else if ((np = int(bio.read(2))) != 3) np += 3;
          else if ((np = int(bio.read(5))) != 31) np += 6;
          else np = 37 + int(bio.read(7));
          while (bio.bit()) {
            if (++C.lblock > 32) fail("corrupt packet header (Lblock)");
          }
          C.passes += np;
          if (C.passes > 109 && !(style & kHt))
            fail("corrupt packet header (more than 109 coding passes)");
          // the passes fill the open segment, then new ones; each part
          // has its own length
          if (C.segs.empty() ||
              C.segs.back().passes == C.segs.back().maxpasses)
            C.segs.push_back({seg_maxpasses(style, C.segs)});
          size_t sg = C.segs.size() - 1;
          for (;;) {
            // HT (OpenJPEG's rule): the first segment takes one pass each
            // time it is open, the next one the rest
            int nn = style & kHt ? (sg == 0 ? 1 : np)
                     : std::min(C.segs[sg].maxpasses - C.segs[sg].passes, np);
            int nbits = C.lblock + floorlog2(uint32_t(nn));
            if (nbits > 32) fail("corrupt packet header (length bits)");
            parts.push_back({&C, sg, nn, bio.read(nbits)});
            np -= nn;
            if (np <= 0) break;
            C.segs.push_back({seg_maxpasses(style, C.segs)});
            sg = C.segs.size() - 1;
          }
        }
      }
    }
    bio.inalign();
    hp += bio.pos;
    if (eph && h.size() - hp >= 2 && h[hp] == 0xFF && h[hp + 1] == 0x92)
      hp += 2;
    for (const Part& pt : parts) {
      if (pt.len > d.size() - pos) fail("truncated packet body");
      CodewordSegment& sg = pt.cb->segs[pt.seg];
      if (pt.cb->chunks++ == 0) pt.cb->first = int64_t(pos);
      pt.cb->bytes.insert(pt.cb->bytes.end(), d.begin() + long(pos),
                          d.begin() + long(pos + pt.len));
      sg.len += pt.len;
      sg.passes += pt.passes;
      pos += pt.len;
    }
  }
};

struct PacketKey {
  int64_t k0, k1, k2, k3;
  int c, r, p;
};

// the packets of one progression over the resolutions [r0, r1), the
// components [c0, c1) and the layers [0, l1), each read once: a POC's
// progressions skip what an earlier one read (OpenJPEG's include table)
struct Progression {
  std::vector<TileComp>& tcs;
  PacketReader& pr;
  int64_t tx0, ty0;
  std::vector<std::vector<std::vector<uint8_t>>> done;  // [c][r][p*L + l]
  int L;

  Progression(std::vector<TileComp>& t, PacketReader& r, int64_t x0,
              int64_t y0, int layers)
      : tcs(t), pr(r), tx0(x0), ty0(y0), L(layers) {
    int64_t n = 0;
    for (const TileComp& tc : tcs)
      for (const Res& R : tc.res) n += int64_t(R.pw) * R.ph * L;
    if (n > kMaxPackets) fail("too many packets in a tile");
    done.resize(tcs.size());
    for (size_t c = 0; c < tcs.size(); ++c)
      for (const Res& R : tcs[c].res)
        done[c].push_back(std::vector<uint8_t>(size_t(R.pw) * R.ph * L, 0));
  }

  void packet(int c, int r, int p, int l) {
    uint8_t& d = done[size_t(c)][size_t(r)][size_t(p) * L + l];
    if (d) return;
    d = 1;
    pr.read(tcs[size_t(c)], r, p, l);
  }

  int nprec(int c, int r) const {
    const Res& R = tcs[size_t(c)].res[size_t(r)];
    return R.pw * R.ph;
  }
  bool has(int c, int r) const { return r <= tcs[size_t(c)].spc.nl; }

  void run(int prog, int r0, int r1, int c0, int c1, int l1) {
    if (prog == 0) {  // LRCP
      for (int l = 0; l < l1; ++l)
        for (int r = r0; r < r1; ++r)
          for (int c = c0; c < c1; ++c)
            if (has(c, r))
              for (int p = 0; p < nprec(c, r); ++p) packet(c, r, p, l);
      return;
    }
    if (prog == 1) {  // RLCP
      for (int r = r0; r < r1; ++r)
        for (int l = 0; l < l1; ++l)
          for (int c = c0; c < c1; ++c)
            if (has(c, r))
              for (int p = 0; p < nprec(c, r); ++p) packet(c, r, p, l);
      return;
    }
    // RPCL, PCRL, CPRL: each precinct is met at the first position (x, y)
    // of the tile's reference grid where Annex B.12's loops reach it: a
    // multiple of XRsiz * 2^(PPx + NL - r), or the tile's x0 where the
    // resolution's origin is off that grid; likewise for y. OpenJPEG
    // steps x from x0 over the multiples of the least such period (of
    // every component and resolution in RPCL and PCRL, of the component's
    // own in CPRL): a precinct off those steps (with subsampling by other
    // than a power of two) is never met and has no packets.
    auto period = [&](int c, bool horizontal) {
      const TileComp& tc = tcs[size_t(c)];
      int64_t m = 0;
      for (int r = 0; r <= tc.spc.nl; ++r) {
        int e = (horizontal ? tc.spc.ppx[r] : tc.spc.ppy[r]) + tc.spc.nl - r;
        int64_t v = int64_t(horizontal ? tc.dx : tc.dy) << e;
        if (v < (int64_t(1) << 31)) m = m ? std::min(m, v) : v;
      }
      return m;
    };
    int64_t stepx = 0, stepy = 0;
    if (prog != 4)
      for (int c = 0; c < int(tcs.size()); ++c) {
        int64_t sx = period(c, true), sy = period(c, false);
        if (sx) stepx = stepx ? std::min(stepx, sx) : sx;
        if (sy) stepy = stepy ? std::min(stepy, sy) : sy;
      }
    std::vector<PacketKey> keys;
    for (int c = c0; c < c1; ++c) {
      TileComp& tc = tcs[size_t(c)];
      if (prog == 4) {
        stepx = period(c, true);
        stepy = period(c, false);
      }
      for (int r = r0; r < std::min(r1, tc.spc.nl + 1); ++r) {
        Res& R = tc.res[size_t(r)];
        if (R.pw == 0 || R.ph == 0) continue;
        int lev = tc.spc.nl - r;
        int64_t mx = int64_t(tc.dx) << (R.pdx + lev);
        int64_t my = int64_t(tc.dy) << (R.pdy + lev);
        if (mx >= (int64_t(1) << 31) || my >= (int64_t(1) << 31))
          fail("precinct exponent plus decomposition level of 31 or more "
               "in a position-driven progression is not supported");
        for (int j = 0; j < R.ph; ++j) {
          int64_t y = (j == 0 && (R.y0 & ((int64_t(1) << R.pdy) - 1)))
                          ? ty0 : ((R.y0 >> R.pdy) + j) * my;
          if (y != ty0 && (!stepy || y % stepy)) continue;
          for (int i = 0; i < R.pw; ++i) {
            int64_t x = (i == 0 && (R.x0 & ((int64_t(1) << R.pdx) - 1)))
                            ? tx0 : ((R.x0 >> R.pdx) + i) * mx;
            if (x != tx0 && (!stepx || x % stepx)) continue;
            PacketKey k{0, 0, 0, 0, c, r, j * R.pw + i};
            if (prog == 2) {  // RPCL
              k.k0 = r; k.k1 = y; k.k2 = x; k.k3 = c;
            } else if (prog == 3) {  // PCRL
              k.k0 = y; k.k1 = x; k.k2 = c; k.k3 = r;
            } else {  // CPRL
              k.k0 = c; k.k1 = y; k.k2 = x; k.k3 = r;
            }
            keys.push_back(k);
          }
        }
      }
    }
    std::sort(keys.begin(), keys.end(), [](const PacketKey& a,
                                           const PacketKey& b) {
      if (a.k0 != b.k0) return a.k0 < b.k0;
      if (a.k1 != b.k1) return a.k1 < b.k1;
      if (a.k2 != b.k2) return a.k2 < b.k2;
      return a.k3 < b.k3;
    });
    for (const PacketKey& k : keys)
      for (int l = 0; l < l1; ++l) packet(k.c, k.r, k.p, l);
  }
};

void decode_packets(std::vector<TileComp>& tcs, const Cod& cod,
                    const std::vector<Poc>& poc,
                    const std::vector<uint8_t>& bytes,
                    const std::vector<uint8_t>* headers, size_t* hpos,
                    int64_t tx0, int64_t ty0) {
  PacketReader pr(bytes, headers, hpos, cod.sop, cod.eph);
  int nc = int(tcs.size());
  int maxres = 0;
  for (auto& tc : tcs) maxres = std::max(maxres, tc.spc.nl + 1);
  Progression prog(tcs, pr, tx0, ty0, cod.layers);
  if (poc.empty()) {
    prog.run(cod.prog, 0, maxres, 0, nc, cod.layers);
    return;
  }
  for (const Poc& q : poc)
    prog.run(q.prog, q.res0, std::min(q.res1, maxres), q.comp0,
             std::min(q.comp1, nc), std::min(q.lay1, cod.layers));
}

// --------------------------------------------------------- tier 1 glue
void decode_blocks(TileComp& tc, T1& t1) {
  int64_t stride = tc.width();
  bool rev = tc.spc.qmfbid == 1;
  if (rev)
    tc.idata.assign(size_t(stride * tc.height()), 0);
  else
    tc.fdata.assign(size_t(stride * tc.height()), 0.f);
  for (size_t r = 0; r < tc.res.size(); ++r) {
    Res& R = tc.res[r];
    for (int bi = 0; bi < R.nb; ++bi) {
      Band& B = R.band[bi];
      if (B.empty()) continue;
      int64_t offx = 0, offy = 0;
      if (B.bandno & 1) offx = tc.res[r - 1].x1 - tc.res[r - 1].x0;
      if (B.bandno & 2) offy = tc.res[r - 1].y1 - tc.res[r - 1].y0;
      for (Prec& P : B.prec)
        for (Cblk& C : P.cb) {
          if (!C.passes || C.x1 <= C.x0 || C.y1 <= C.y0) continue;
          int cw = int(C.x1 - C.x0), ch = int(C.y1 - C.y0);
          int64_t ox = C.x0 - B.x0 + offx, oy = C.y0 - B.y0 + offy;
          if (ox < 0 || oy < 0 || ox + cw > stride || oy + ch > tc.height())
            fail("code-block outside its tile-component");
          const std::vector<int32_t>* out = &t1.data;
          if (tc.spc.cbstyle & kHt) {
            if (tc.roishift)
              fail("ROI in HT code-blocks is not supported (as in OpenJPEG)");
            // OpenJPEG reads a block of one chunk in place in the tile's
            // data, several from a copy
            t1.ht.decode(cw, ch, B.mb, C.numbps, tc.spc.cbstyle, C.segs,
                         C.bytes, C.chunks == 1 ? C.first & 3 : 0);
            out = &t1.ht.data;
          } else {
            t1.decode(cw, ch, B.bandno, C.numbps, tc.roishift,
                      tc.spc.cbstyle, C.segs, C.bytes);
          }
          for (int y = 0; y < ch; ++y) {
            const int32_t* src = &(*out)[size_t(y) * cw];
            size_t at = size_t((oy + y) * stride + ox);
            if (rev) {
              int32_t* dst = &tc.idata[at];
              for (int x = 0; x < cw; ++x) dst[x] = src[x] / 2;
            } else {
              float* dst = &tc.fdata[at];
              for (int x = 0; x < cw; ++x) dst[x] = float(src[x]) * B.step;
            }
          }
        }
    }
  }
}

// ---------------------------------------------------------- wavelets
// one line: low samples first, then high; cas = parity of its origin
void idwt53_line(int32_t* v, int n, int cas, std::vector<int32_t>& t) {
  if (n == 1) {
    if (cas) v[0] /= 2;
    return;
  }
  if (n < 1) return;
  int sn = (n + 1 - cas) / 2;
  t.resize(size_t(n));
  for (int i = 0; i < n; ++i) {
    bool low = ((i + cas) & 1) == 0;
    t[size_t(i)] = low ? v[i / 2] : v[sn + i / 2];
  }
  int32_t* x = t.data();
  for (int i = cas; i < n; i += 2) {
    int32_t l = i > 0 ? x[i - 1] : x[i + 1];
    int32_t r = i + 1 < n ? x[i + 1] : x[i - 1];
    x[i] -= (l + r + 2) >> 2;
  }
  for (int i = 1 - cas; i < n; i += 2) {
    int32_t l = i > 0 ? x[i - 1] : x[i + 1];
    int32_t r = i + 1 < n ? x[i + 1] : x[i - 1];
    x[i] += (l + r) >> 1;
  }
  memcpy(v, x, size_t(n) * sizeof(int32_t));
}

const float kK = 1.230174105f;
const float kTwoInvK = 1.625732422f;
const float kLift[4] = {-0.443506852f, -0.882911075f, 0.052980118f,
                        1.586134342f};

void idwt97_line(float* v, int n, int cas, std::vector<float>& t) {
  if (n <= 1) return;
  int sn = (n + 1 - cas) / 2;
  t.resize(size_t(n));
  for (int i = 0; i < n; ++i) {
    bool low = ((i + cas) & 1) == 0;
    t[size_t(i)] = low ? v[i / 2] * kK : v[sn + i / 2] * kTwoInvK;
  }
  float* x = t.data();
  for (int s = 0; s < 4; ++s) {
    const float c = kLift[s];
    // steps 0 and 2 update the low samples, 1 and 3 the high ones
    int start = (s & 1) ? 1 - cas : cas;
    for (int i = start; i < n; i += 2) {
      float l = i > 0 ? x[i - 1] : x[i + 1];
      float r = i + 1 < n ? x[i + 1] : x[i - 1];
      float sum = l + r;
      float prod = sum * c;
      x[i] = x[i] + prod;
    }
  }
  memcpy(v, x, size_t(n) * sizeof(float));
}

template <typename T, typename F>
void idwt(TileComp& tc, std::vector<T>& buf, F line) {
  int64_t stride = tc.width();
  std::vector<T> col, tmp;
  for (size_t r = 1; r < tc.res.size(); ++r) {
    const Res& R = tc.res[r];
    int rw = int(R.x1 - R.x0), rh = int(R.y1 - R.y0);
    int casx = int(R.x0 & 1), casy = int(R.y0 & 1);
    for (int j = 0; j < rh; ++j)
      line(&buf[size_t(j * stride)], rw, casx, tmp);
    col.resize(size_t(rh));
    for (int i = 0; i < rw; ++i) {
      for (int j = 0; j < rh; ++j)
        col[size_t(j)] = buf[size_t(j * stride + i)];
      line(col.data(), rh, casy, tmp);
      for (int j = 0; j < rh; ++j)
        buf[size_t(j * stride + i)] = col[size_t(j)];
    }
  }
}

// --------------------------------------------------------------- tile
// With subsampled components, PIL reads OpenJPEG's tile buffer as if
// each component's plane held (w / dx) x (h / dy) samples, w x h the
// tile's size on the reference grid (Jpeg2KDecode.c, integer division),
// where OpenJPEG packs each plane one after the other at its own size,
// which may be larger (B.3): component n is read from the sum of the
// smaller sizes before it, its sample for pixel (x, y) at
// (y / dy) * (w / dx) + x / dx, in the component's 1, 2 or 4 bytes. The
// buffer is PIL's: the tile at full size in every component where that is
// larger, zero past the planes (where the last component's reads may run
// at odd tile sizes and offsets). Each tc.idata becomes the w x h plane
// of what PIL reads.
void pil_layout(std::vector<TileComp>& tcs, int64_t w, int64_t h) {
  std::vector<int> csiz;
  size_t full = 0, packed = 0;
  for (const TileComp& tc : tcs) {
    int b = (tc.prec + 7) >> 3;
    csiz.push_back(b == 3 ? 4 : b);
    full += size_t(csiz.back()) * size_t(w * h);
    packed += size_t(csiz.back()) * size_t(tc.width() * tc.height());
  }
  std::vector<uint8_t> buf(std::max(full, packed), 0);
  size_t at = 0;
  for (size_t c = 0; c < tcs.size(); ++c)  // OpenJPEG's packing
    for (int32_t v : tcs[c].idata)
      for (int k = 0; k < csiz[c]; ++k)
        buf[at++] = uint8_t(uint32_t(v) >> (8 * k));
  size_t base = 0;
  for (size_t c = 0; c < tcs.size(); ++c) {
    const TileComp& tc = tcs[c];
    int64_t sw = w / tc.dx, sh = h / tc.dy;
    int b = csiz[c];
    // the last read ends within the floor sizes' sum, so within `full`
    int64_t last = ((h - 1) / tc.dy) * sw + (w - 1) / tc.dx;
    if (base + size_t(b) * size_t(last + 1) > buf.size())
      fail("component plane read past the tile buffer");
    std::vector<int32_t> plane(size_t(w * h));
    for (int64_t y = 0; y < h; ++y) {
      const uint8_t* row = &buf[base + size_t(b) * size_t((y / tc.dy) * sw)];
      int32_t* dst = &plane[size_t(y * w)];
      for (int64_t x = 0; x < w; ++x) {
        const uint8_t* e = row + size_t(b) * size_t(x / tc.dx);
        uint32_t v = e[0];
        for (int k = 1; k < b; ++k) v |= uint32_t(e[k]) << (8 * k);
        dst[x] = int32_t(v);
      }
    }
    tcs[c].idata.swap(plane);
    base += size_t(b) * size_t(sw * sh);
  }
}

// decodes tile `ti` into `out`, (H, W, 3) RGB; with PPM its packet
// headers are read from cs.ppm at *ppm_pos
void decode_tile(const Codestream& cs, int ti, size_t* ppm_pos,
                 const Pil& pil, uint8_t* out) {
  const TileData& td = cs.tiles[size_t(ti)];
  int p = ti % cs.ntx, q = ti / cs.ntx;
  int64_t tx0 = std::max(cs.TX0 + p * cs.TW, cs.X0);
  int64_t ty0 = std::max(cs.TY0 + q * cs.TH, cs.Y0);
  int64_t tx1 = std::min(cs.TX0 + (p + 1) * cs.TW, cs.X);
  int64_t ty1 = std::min(cs.TY0 + (q + 1) * cs.TH, cs.Y);
  const Cod& cod = td.has_cod ? td.cod : cs.cod;
  int nc = cs.nc;
  std::vector<TileComp> tcs(static_cast<size_t>(nc));
  int64_t nprec = 0;
  for (int c = 0; c < nc; ++c) {
    TileComp& tc = tcs[size_t(c)];
    size_t cu = size_t(c);
    tc.dx = cs.comp[cu].dx;
    tc.dy = cs.comp[cu].dy;
    tc.x0 = ceildiv(tx0, tc.dx);  // Annex B.3
    tc.y0 = ceildiv(ty0, tc.dy);
    tc.x1 = ceildiv(tx1, tc.dx);
    tc.y1 = ceildiv(ty1, tc.dy);
    tc.sgnd = cs.comp[cu].sgnd;
    tc.prec = cs.comp[cu].prec;
    tc.spc = td.coc_set[cu] ? td.coc[cu]
             : td.has_cod   ? td.cod.spc
             : cs.coc_set[cu] ? cs.coc[cu]
                              : cs.cod.spc;
    tc.q = td.qcc_set[cu] ? td.qcc[cu]
           : td.has_qcd   ? td.qcd
           : cs.qcc_set[cu] ? cs.qcc[cu]
                            : cs.qcd;
    tc.roishift = td.rgn_set[cu] ? td.roishift[cu] : cs.roishift[cu];
    build_comp(tc, nprec);
  }
  std::vector<Poc> poc = cs.poc;
  poc.insert(poc.end(), td.poc.begin(), td.poc.end());
  // packet headers: PPM's, else this tile's PPT segments in Zppt order,
  // else in the packets
  std::vector<uint8_t> ppt;
  size_t ppt_pos = 0;
  if (td.ppt.any)
    for (size_t z = 0; z < 256; ++z)
      if (td.ppt.set[z])
        ppt.insert(ppt.end(), td.ppt.seg[z].begin(), td.ppt.seg[z].end());
  const std::vector<uint8_t>* headers = cs.ppm_seg.any ? &cs.ppm
                                       : td.ppt.any    ? &ppt
                                                       : nullptr;
  decode_packets(tcs, cod, poc, td.bytes, headers,
                 cs.ppm_seg.any ? ppm_pos : &ppt_pos, tx0, ty0);
  T1 t1;
  for (auto& tc : tcs) {
    decode_blocks(tc, t1);
    if (tc.spc.qmfbid == 1)
      idwt(tc, tc.idata, idwt53_line);
    else
      idwt(tc, tc.fdata, idwt97_line);
  }
  if (cod.mct && nc >= 3) {
    int qm = tcs[0].spc.qmfbid;
    if (tcs[1].spc.qmfbid != qm || tcs[2].spc.qmfbid != qm)
      fail("multiple component transform over components with different "
           "wavelets is not supported");
    for (int c = 1; c < 3; ++c)
      if (tcs[size_t(c)].x0 != tcs[0].x0 || tcs[size_t(c)].x1 != tcs[0].x1 ||
          tcs[size_t(c)].y0 != tcs[0].y0 || tcs[size_t(c)].y1 != tcs[0].y1)
        fail("multiple component transform over components of different "
             "sizes (component subsampling)");
    size_t np = size_t(tcs[0].width() * tcs[0].height());
    if (qm == 1) {
      int32_t *c0 = tcs[0].idata.data(), *c1 = tcs[1].idata.data(),
              *c2 = tcs[2].idata.data();
      for (size_t i = 0; i < np; ++i) {
        int32_t y = c0[i], u = c1[i], v = c2[i];
        int32_t g = y - ((u + v) >> 2);
        c0[i] = v + g;
        c1[i] = g;
        c2[i] = u + g;
      }
    } else {
      float *c0 = tcs[0].fdata.data(), *c1 = tcs[1].fdata.data(),
            *c2 = tcs[2].fdata.data();
      for (size_t i = 0; i < np; ++i) {
        float y = c0[i], u = c1[i], v = c2[i];
        float vr = v * 1.402f;
        float r = y + vr;
        float ug = u * 0.34413f, vg = v * 0.71414f;
        float g = y - ug;
        g = g - vg;
        float ub = u * 1.772f;
        float b = y + ub;
        c0[i] = r;
        c1[i] = g;
        c2[i] = b;
      }
    }
  }
  // DC level shift, rounding and clamping to the component's range
  // (opj_tcd_dc_level_shift_decode: a reversible sample and its shift
  // add in 32 bits, an irreversible one in 64)
  for (TileComp& tc : tcs) {
    int32_t lo = tc.sgnd ? -(int32_t(1) << (tc.prec - 1)) : 0;
    int32_t hi = tc.sgnd ? (int32_t(1) << (tc.prec - 1)) - 1
                         : int32_t((uint32_t(1) << tc.prec) - 1);
    int32_t shift = tc.sgnd ? 0 : int32_t(1) << (tc.prec - 1);
    if (tc.spc.qmfbid == 1) {
      for (int32_t& v : tc.idata) {
        int32_t s = int32_t(uint32_t(v) + uint32_t(shift));
        v = std::max(lo, std::min(hi, s));
      }
    } else {
      size_t np = size_t(tc.width() * tc.height());
      tc.idata.resize(np);
      for (size_t i = 0; i < np; ++i) {
        float f = tc.fdata[i];
        int64_t v;
        if (f > float(INT_MAX)) v = hi;
        else if (!(f >= float(INT_MIN))) v = lo;
        else v = int64_t(lrintf(f)) + shift;
        tc.idata[i] = int32_t(std::max<int64_t>(lo, std::min<int64_t>(hi, v)));
      }
    }
  }
  // PIL's unpacking of the samples, then convert("RGB")
  int64_t W = cs.width();
  int64_t ox = tx0 - cs.X0, oy = ty0 - cs.Y0;
  int64_t tw = tx1 - tx0, th = ty1 - ty0;
  for (const TileComp& tc : tcs)
    if (tc.dx != 1 || tc.dy != 1) {
      pil_layout(tcs, tw, th);
      break;
    }
  int bits = pil.out == Out::Grey16 ? 16 : 8;
  int nu = pil.out == Out::Cmyk ? 4 : pil.out == Out::Rgb ||
                                          pil.out == Out::Ycc ? 3 : 1;
  std::vector<Unpack> un;
  for (int c = 0; c < nu; ++c)
    un.emplace_back(tcs[size_t(c)].prec, tcs[size_t(c)].sgnd, bits);
  const int32_t* v0 = tcs[0].idata.data();
  const int32_t* v1 = nu > 1 ? tcs[1].idata.data() : nullptr;
  const int32_t* v2 = nu > 1 ? tcs[2].idata.data() : nullptr;
  const int32_t* v3 = nu > 3 ? tcs[3].idata.data() : nullptr;
  const YccTables& yt = ycc();
  size_t npal = pil.pal.size() / size_t(pil.pal_entry);
  for (int64_t y = 0; y < th; ++y) {
    uint8_t* dst = out + ((oy + y) * W + ox) * 3;
    size_t i = size_t(y * tw);
    for (int64_t x = 0; x < tw; ++x, ++i, dst += 3) {
      switch (pil.out) {
        case Out::Grey:
          dst[0] = dst[1] = dst[2] = uint8_t(un[0](v0[i]));
          break;
        case Out::Grey16:  // I;16, clipped to 8 bits
          dst[0] = dst[1] = dst[2] =
              uint8_t(std::min<uint32_t>(un[0](v0[i]) & 0xFFFF, 255));
          break;
        case Out::Rgb:
          dst[0] = uint8_t(un[0](v0[i]));
          dst[1] = uint8_t(un[1](v1[i]));
          dst[2] = uint8_t(un[2](v2[i]));
          break;
        case Out::Ycc: {  // ImagingConvertYCbCr2RGB
          int l = uint8_t(un[0](v0[i]));
          int cb = uint8_t(un[1](v1[i])), cr = uint8_t(un[2](v2[i]));
          dst[0] = clip8(l + (yt.r_cr[cr] >> 6));
          dst[1] = clip8(l + ((yt.g_cb[cb] + yt.g_cr[cr]) >> 6));
          dst[2] = clip8(l + (yt.b_cb[cb] >> 6));
          break;
        }
        case Out::Cmyk: {  // cmyk2rgb, rounded as MULDIV255
          int nk = 255 - uint8_t(un[3](v3[i]));
          const int32_t* vs[3] = {v0, v1, v2};
          for (int k = 0; k < 3; ++k) {
            int t = int(uint8_t(un[size_t(k)](vs[k][i]))) * nk + 128;
            dst[k] = clip8(nk - (((t >> 8) + t) >> 8));
          }
          break;
        }
        case Out::Palette: {  // entries past the palette are black
          size_t e = uint8_t(un[0](v0[i]));
          if (e < npal) {
            const uint8_t* c = &pil.pal[e * size_t(pil.pal_entry)];
            dst[0] = c[0];
            dst[1] = c[1];
            dst[2] = c[2];
          } else {
            dst[0] = dst[1] = dst[2] = 0;
          }
          break;
        }
      }
    }
  }
}

// the codestream, raw or boxed as JP2, and how PIL would unpack it
void open_image(const uint8_t* data, size_t n, bool header_only, Codestream& cs,
          Pil& pil) {
  if (n >= 12 && memcmp(data, "\0\0\0\x0cjP  \r\n\x87\n", 12) == 0) {
    Jp2 j;
    j.parse(data, n);
    cs.parse(data + j.cs_start, n - j.cs_start, header_only);
    if (j.ihdr_w != cs.width() || j.ihdr_h != cs.height() ||
        j.width != cs.width() || j.height != cs.height())
      fail("JP2: ihdr gives " + std::to_string(j.width) + " x " +
           std::to_string(j.height) + ", the codestream's SIZ " +
           std::to_string(cs.width()) + " x " + std::to_string(cs.height()));
    pil.mode = j.mode;
    pil.space = j.space;
    pil.pal = j.pal;
    pil.pal_entry = j.pal_entry;
  } else {
    cs.parse(data, n, header_only);
    static const Mode by_nc[] = {Mode::L, Mode::LA, Mode::RGB, Mode::RGBA};
    pil.mode = cs.nc == 1 && cs.comp[0].prec > 8 ? Mode::I16
                                                 : by_nc[cs.nc - 1];
  }
  pil.out = unpacker(pil.mode, pil.space, cs.comp);
}

void set_err(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) snprintf(err, size_t(errlen), "%s", msg);
}

}  // namespace

extern "C" {

int j2k_info(const uint8_t* data, long n, int* dims, char* err,
             int errlen) {
  try {
    if (n < 0) fail("negative length");
    Codestream cs;
    Pil pil;
    open_image(data, size_t(n), true, cs, pil);
    dims[0] = cs.height();
    dims[1] = cs.width();
    dims[2] = cs.nc;
    return 0;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 1;
  }
}

int j2k_decode(const uint8_t* data, long n, uint8_t* out, long cap,
               char* err, int errlen) {
  try {
    if (n < 0) fail("negative length");
    Codestream cs;
    Pil pil;
    open_image(data, size_t(n), false, cs, pil);
    if (int64_t(cs.height()) * cs.width() * 3 > cap)
      fail("output buffer too small");
    size_t ppm_pos = 0;
    for (int t : cs.order) decode_tile(cs, t, &ppm_pos, pil, out);
    return 0;
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 1;
  }
}

}  // extern "C"
