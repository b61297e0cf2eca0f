// Host decoding of JPEG 2000 (ITU-T T.800) files as OpenJPEG 2.5 decodes
// them under OpenCV 5.0's Jpeg2KOpjDecoder (cv2.imread), colour (BGR) or
// grayscale, byte for byte:
//   - the JP2 file (signature, ftyp, jp2h with ihdr / colr / pclr / cmap /
//     cdef, then jp2c) and the raw codestream (FF4F FF51), found by content;
//   - the codestream: SIZ, COD / COC, QCD / QCC, RGN, POC, PPM / PPT (packet
//     headers moved out of the packets), TLM / PLM / PLT / COM / CRG
//     (checked as OpenJPEG checks them, then skipped), unknown main-header
//     markers scanned past two bytes at a time, tile-parts of the tiles in
//     any order (each tile's in order), SOP / EPH;
//   - tiles with their offsets, sub-sampled components, precincts, quality
//     layers, the five progression orders (with POC, each packet read once),
//     the tag-tree packet headers, code-block segments for every code-block
//     style (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM);
//   - EBCOT: the MQ decoder (each segment followed by OpenJPEG's synthetic
//     FF FF marker), the raw (bypass) decoder, the significance,
//     refinement and cleanup passes over per-sample neighbourhood flags,
//     ROI max-shift, the reconstruction at the middle of the last decoded
//     bit-plane;
//   - the 5/3 wavelet in integers, the 9/7 in float as OpenJPEG lifts it
//     (its constants, 2/K for the high band, (l + r) * c then the add), RCT
//     and ICT (float, OpenJPEG's coefficients), the DC level shift with
//     lrintf (half to even) and the clamp to the component's range;
//   - then OpenCV: 1-4 unsigned components of 8 or more bits (their
//     precision as the codestream gives it, before a palette), with no
//     sub-sampling and no image offset; every sample shifted right by
//     (largest precision - 8); sRGB (and an unknown or unspecified colour
//     space) is R, G, B from components 0-2, grey from 3 or more components
//     through cvtColor's fixed point, grey from 1 or 2 component 0;
//     greyscale copies component 0; sYCC goes through cvtColor(YUV2BGR).
// Unreadable (imread gives None) where OpenJPEG or OpenCV's use of it fails:
// a damaged box or marker segment, a tile-part or code-block segment
// longer than the data (OpenJPEG's strict mode), a missing EPH, a stream
// that ends where OpenJPEG reads on, signed components, precision under 8,
// sub-sampled or offset components, 1 or 2 components of sRGB read in
// colour, EYCC and CMYK colour spaces.  A file of HT (high-throughput)
// code-blocks raises (-1): the port does not decode them.  One past
// OpenCV's limits on a side (2^20) or on the pixels (2^30) fails with -1,
// as imread raises for it.
//
// Built with g++ by fots_torch/kernels/build.py into build/fots_torch/ at
// first use and loaded with ctypes.  Every entry point returns 0, 1 with a
// message in `err` where imread gives None, or -1 with a message for any
// other failure.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

struct Unreadable : std::runtime_error {
  explicit Unreadable(const std::string& m) : std::runtime_error(m) {}
};

constexpr int64_t kMaxSide = 1 << 20;
constexpr int64_t kMaxPixels = int64_t(1) << 30;

inline int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t ceildivpow2(int64_t a, int b) { return (a + (int64_t(1) << b) - 1) >> b; }
inline int64_t floordivpow2(int64_t a, int b) { return a >> b; }
inline int floorlog2(uint32_t a) {
  int l = 0;
  while (a > 1) {
    a >>= 1;
    l++;
  }
  return l;
}

// ------------------------------------------------------------------ headers

struct Comp {
  int prec = 0, sgnd = 0, dx = 1, dy = 1;
};

struct Step {
  int expn = 0, mant = 0;
};

constexpr int kMaxRes = 33, kMaxBands = 3 * kMaxRes - 2;

struct Tccp {
  int csty = 0, numres = 0, cblkw = 0, cblkh = 0, cblksty = 0, qmfbid = 0;
  int prcw[kMaxRes], prch[kMaxRes];
  int qntsty = 0, numgbits = 0;
  Step steps[kMaxBands];
  int roishift = 0;
};

struct Poc {
  int resno0, compno0, layno1, resno1, compno1, prg;
};

struct Tcp {
  int csty = 0, prg = 0, numlayers = 0, mct = 0;
  std::vector<Tccp> tccps;
  std::vector<Poc> pocs;
  std::vector<char> coc, qcc;      // per component: set by a COC / QCC of this header
  std::vector<uint8_t> data;       // the tile's packets, its tile-parts in order
  std::vector<std::pair<int, std::vector<uint8_t>>> ppt;  // (Zppt, Ippt)
  int parts = -1, nparts = 0;      // the last TPsot read (-1: none), TNsot (0: unknown)
  bool dc_shift = true;            // an MCO marker zeroes every component's DC level shift
  bool seen = false, has_data = false;
};

struct Image {
  int64_t ihdr_w = 0, ihdr_h = 0;  // a JP2 file's ihdr, which SIZ must match
  int64_t x0 = 0, y0 = 0, x1 = 0, y1 = 0, tx0 = 0, ty0 = 0, tdx = 0, tdy = 0;
  int tw = 0, th = 0;
  std::vector<Comp> comps;
  Tcp deflt;
  std::vector<Tcp> tcps;
  std::vector<std::pair<int, std::vector<uint8_t>>> ppm;  // (Zppm, data)
  bool has_ppm = false;
};

struct Stream {
  const uint8_t* d;
  int64_t n, pos = 0;
  int64_t left() const { return n - pos; }
};

uint32_t be(const uint8_t* p, int k) {
  uint32_t v = 0;
  for (int i = 0; i < k; i++) v = v << 8 | p[i];
  return v;
}

void read_siz(Image& im, const uint8_t* p, int64_t len) {
  if (len < 36 || (len - 36) % 3 != 0) throw Unreadable("error with the SIZ marker's size");
  im.x1 = be(p + 2, 4);
  im.y1 = be(p + 6, 4);
  im.x0 = be(p + 10, 4);
  im.y0 = be(p + 14, 4);
  im.tdx = be(p + 18, 4);
  im.tdy = be(p + 22, 4);
  im.tx0 = be(p + 26, 4);
  im.ty0 = be(p + 30, 4);
  const int nc = int(be(p + 34, 2));
  if (nc == 0 || nc > 16384) throw Unreadable("invalid number of components in SIZ");
  if (int64_t(nc) != (len - 36) / 3) throw Unreadable("SIZ's component count and size differ");
  if (im.x0 >= im.x1 || im.y0 >= im.y1) throw Unreadable("invalid image size in SIZ");
  if (im.ihdr_w > 0 && im.ihdr_h > 0 && (im.ihdr_w != im.x1 - im.x0 || im.ihdr_h != im.y1 - im.y0))
    throw Unreadable("error with SIZ marker: IHDR and SIZ sizes differ");
  if (im.tdx == 0 || im.tdy == 0) throw Unreadable("invalid tile size in SIZ");
  if (im.tx0 > im.x0 || im.ty0 > im.y0 || im.tx0 + im.tdx <= im.x0 || im.ty0 + im.tdy <= im.y0)
    throw Unreadable("invalid tile offset in SIZ");
  im.comps.resize(size_t(nc));
  for (int i = 0; i < nc; i++) {
    const uint8_t* c = p + 36 + 3 * i;
    Comp& k = im.comps[size_t(i)];
    k.prec = (c[0] & 0x7f) + 1;
    k.sgnd = c[0] >> 7;
    k.dx = c[1];
    k.dy = c[2];
    if (k.dx < 1 || k.dy < 1) throw Unreadable("invalid component sampling in SIZ");
    if (k.prec > 31) throw Unreadable("component precision past 31 bits");
  }
  const int64_t tw = ceildiv(im.x1 - im.tx0, im.tdx), th = ceildiv(im.y1 - im.ty0, im.tdy);
  if (tw <= 0 || th <= 0 || tw > 65535 / th) throw Unreadable("invalid number of tiles");
  im.tw = int(tw);
  im.th = int(th);
}

// SPcod / SPcoc into one component's parameters; returns the bytes read
int64_t read_spcod(Tccp& t, int csty, const uint8_t* p, int64_t len) {
  if (len < 5) throw Unreadable("error reading SPCod SPCoc element");
  t.csty = csty;
  t.numres = p[0] + 1;
  if (t.numres > kMaxRes) throw Unreadable("invalid number of resolutions");
  t.cblkw = p[1] + 2;
  t.cblkh = p[2] + 2;
  if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12)
    throw Unreadable("invalid code-block size");
  t.cblksty = p[3];
  if (t.cblksty & 0x80) throw Unreadable("unsupported mixed HT code-block style");
  t.qmfbid = p[4];
  if (t.qmfbid > 1) throw Unreadable("invalid wavelet transformation");
  int64_t at = 5;
  if (csty & 1) {
    if (len < 5 + t.numres) throw Unreadable("error reading SPCod SPCoc element");
    for (int i = 0; i < t.numres; i++) {
      const int v = p[at++];
      if (i != 0 && ((v & 15) == 0 || (v >> 4) == 0)) throw Unreadable("invalid precinct size");
      t.prcw[i] = v & 15;
      t.prch[i] = v >> 4;
    }
  } else {
    for (int i = 0; i < t.numres; i++) t.prcw[i] = t.prch[i] = 15;
  }
  return at;
}

int64_t read_sqcd(Tccp& t, const uint8_t* p, int64_t len) {
  if (len < 1) throw Unreadable("error reading SQcd or SQcc element");
  t.qntsty = p[0] & 31;
  t.numgbits = p[0] >> 5;
  int64_t at = 1;
  len -= 1;
  const int64_t bands = t.qntsty == 1 ? 1 : t.qntsty == 0 ? len : len / 2;
  if (t.qntsty == 1 || t.qntsty == 2) {
    if (len < 2 * bands) throw Unreadable("error reading SQcd or SQcc element");
  }
  for (int64_t b = 0; b < bands; b++) {
    if (t.qntsty == 0) {
      if (b < kMaxBands) t.steps[b] = Step{p[at] >> 3, 0};
      at += 1;
    } else {
      const int v = int(be(p + at, 2));
      if (b < kMaxBands) t.steps[b] = Step{v >> 11, v & 0x7ff};
      at += 2;
    }
  }
  if (t.qntsty == 1) {  // scalar derived: the other bands from the first
    for (int b = 1; b < kMaxBands; b++) {
      const int e = t.steps[0].expn - (b - 1) / 3;
      t.steps[b] = Step{e > 0 ? e : 0, t.steps[0].mant};
    }
  }
  return at;
}

int comp_index(const Image& im, const uint8_t*& p, int64_t& len) {
  const int two = im.comps.size() > 256;
  if (len < 1 + two) throw Unreadable("marker segment too short");
  const int c = int(be(p, 1 + two));
  p += 1 + two;
  len -= 1 + two;
  if (c >= int(im.comps.size())) throw Unreadable("component index past the components");
  return c;
}

void copy_coding(Tccp& dst, const Tccp& src) {
  dst.csty = src.csty;
  dst.numres = src.numres;
  dst.cblkw = src.cblkw;
  dst.cblkh = src.cblkh;
  dst.cblksty = src.cblksty;
  dst.qmfbid = src.qmfbid;
  std::memcpy(dst.prcw, src.prcw, sizeof dst.prcw);
  std::memcpy(dst.prch, src.prch, sizeof dst.prch);
}

void copy_quant(Tccp& dst, const Tccp& src) {
  dst.qntsty = src.qntsty;
  dst.numgbits = src.numgbits;
  std::memcpy(dst.steps, src.steps, sizeof dst.steps);
}

void read_cod(const Image& im, Tcp& tcp, const uint8_t* p, int64_t len) {
  if (len < 5) throw Unreadable("error reading the COD marker");
  tcp.csty = p[0];
  if (tcp.csty & ~7) throw Unreadable("unknown Scod value in COD marker");
  tcp.prg = p[1];
  if (tcp.prg > 4) throw Unreadable("unknown progression order in COD marker");
  tcp.numlayers = int(be(p + 2, 2));
  if (tcp.numlayers < 1) throw Unreadable("invalid number of layers in COD marker");
  tcp.mct = p[4];
  if (tcp.mct > 1) throw Unreadable("invalid multiple component transformation");
  Tccp first = tcp.tccps[0];
  const int64_t used = read_spcod(first, tcp.csty & 1, p + 5, len - 5);
  if (5 + used != len) throw Unreadable("error reading the COD marker");
  for (size_t c = 0; c < im.comps.size(); c++)
    if (!tcp.coc[c]) copy_coding(tcp.tccps[c], first);
}

void read_coc(const Image& im, Tcp& tcp, const uint8_t* p, int64_t len) {
  const int c = comp_index(im, p, len);
  if (len < 1) throw Unreadable("error reading the COC marker");
  const int64_t used = read_spcod(tcp.tccps[size_t(c)], p[0] & 1, p + 1, len - 1);
  if (1 + used != len) throw Unreadable("error reading the COC marker");
  tcp.coc[size_t(c)] = 1;
}

void read_qcd(const Image& im, Tcp& tcp, const uint8_t* p, int64_t len) {
  Tccp first = tcp.tccps[0];
  if (read_sqcd(first, p, len) != len) throw Unreadable("error reading the QCD marker");
  for (size_t c = 0; c < im.comps.size(); c++)
    if (!tcp.qcc[c]) copy_quant(tcp.tccps[c], first);
}

void read_qcc(const Image& im, Tcp& tcp, const uint8_t* p, int64_t len) {
  const int c = comp_index(im, p, len);
  if (read_sqcd(tcp.tccps[size_t(c)], p, len) != len) throw Unreadable("error reading the QCC marker");
  tcp.qcc[size_t(c)] = 1;
}

void read_rgn(const Image& im, Tcp& tcp, const uint8_t* p, int64_t len) {
  const int two = im.comps.size() > 256;
  if (len != 3 + two) throw Unreadable("error reading the RGN marker");
  const int c = comp_index(im, p, len);
  tcp.tccps[size_t(c)].roishift = p[1];  // whatever Srgn says
}

void read_poc(const Image& im, Tcp& tcp, const uint8_t* p, int64_t len) {
  const int two = im.comps.size() > 256;
  const int chunk = 5 + 2 * (1 + two);
  if (len < chunk || len % chunk) throw Unreadable("error reading the POC marker");
  tcp.pocs.clear();
  for (int64_t at = 0; at < len; at += chunk) {
    const uint8_t* q = p + at;
    Poc c;
    c.resno0 = q[0];
    c.compno0 = int(be(q + 1, 1 + two));
    c.layno1 = int(be(q + 2 + two, 2));
    c.resno1 = q[4 + two];
    if (c.resno1 > kMaxRes) c.resno1 = kMaxRes;
    c.compno1 = int(be(q + 5 + two, 1 + two));
    c.compno1 = std::min(c.compno1, int(im.comps.size()));
    c.prg = q[6 + 2 * two];
    tcp.pocs.push_back(c);
  }
}

// ------------------------------------------------------------------ bit reader

struct Bio {
  const uint8_t *start, *bp, *end;
  uint32_t buf = 0;
  int ct = 0;
  Bio(const uint8_t* p, int64_t n) : start(p), bp(p), end(p + n) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    ct--;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; i--) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
  int64_t numbytes() const { return bp - start; }
};

struct TagTree {
  struct Node {
    int parent, value, low;
  };
  std::vector<Node> nodes;
  void init(int w, int h) {
    nodes.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<int> ws{w}, hs{h};
    while (ws.back() > 1 || hs.back() > 1) {
      ws.push_back((ws.back() + 1) / 2);
      hs.push_back((hs.back() + 1) / 2);
    }
    std::vector<int> base(ws.size());
    int total = 0;
    for (size_t l = 0; l < ws.size(); l++) {
      base[l] = total;
      total += ws[l] * hs[l];
    }
    nodes.assign(size_t(total), Node{-1, 999, 0});
    for (size_t l = 0; l + 1 < ws.size(); l++)
      for (int y = 0; y < hs[l]; y++)
        for (int x = 0; x < ws[l]; x++)
          nodes[size_t(base[l] + y * ws[l] + x)].parent = base[l + 1] + (y / 2) * ws[l + 1] + x / 2;
  }
  int decode(Bio& bio, int leaf, int threshold) {
    int stk[64], sp = 0;
    int node = leaf;
    while (nodes[size_t(node)].parent >= 0) {
      stk[sp++] = node;
      node = nodes[size_t(node)].parent;
    }
    int low = 0;
    for (;;) {
      Node& n = nodes[size_t(node)];
      if (low > n.low) n.low = low;
      else low = n.low;
      while (low < threshold && low < n.value) {
        if (bio.bit()) n.value = low;
        else ++low;
      }
      n.low = low;
      if (sp == 0) break;
      node = stk[--sp];
    }
    return nodes[size_t(node)].value < threshold;
  }
};

// ------------------------------------------------------------------ tile structure

struct Seg {
  int len = 0, numpasses = 0, maxpasses = 0, newlen = 0, numnewpasses = 0;
};

struct Cblk {
  int64_t x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0, numnewpasses = 0, numsegs = 0;
  std::vector<Seg> segs;
  std::vector<std::pair<const uint8_t*, int>> chunks;
};

struct Prec {
  int64_t x0, y0, x1, y1;
  int cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int64_t x0, y0, x1, y1;
  int bandno = 0, numbps = 0;
  float stepsize = 0;
  std::vector<Prec> precs;
  bool empty() const { return x1 <= x0 || y1 <= y0; }
};

struct Res {
  int64_t x0, y0, x1, y1;
  int pdx, pdy, pw, ph, numbands;
  Band bands[3];
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  int numres;
  std::vector<Res> res;
  std::vector<int32_t> idata;  // reversible: integers; irreversible: floats
  std::vector<float> fdata;
};

void init_tilecomp(TileComp& tc, const Tccp& tccp, const Comp& comp, int64_t tx0, int64_t ty0,
                   int64_t tx1, int64_t ty1) {
  tc.x0 = ceildiv(tx0, comp.dx);
  tc.y0 = ceildiv(ty0, comp.dy);
  tc.x1 = ceildiv(tx1, comp.dx);
  tc.y1 = ceildiv(ty1, comp.dy);
  tc.numres = tccp.numres;
  tc.res.assign(size_t(tccp.numres), Res());
  for (int r = 0; r < tccp.numres; r++) {
    Res& res = tc.res[size_t(r)];
    const int level = tccp.numres - 1 - r;
    res.x0 = ceildivpow2(tc.x0, level);
    res.y0 = ceildivpow2(tc.y0, level);
    res.x1 = ceildivpow2(tc.x1, level);
    res.y1 = ceildivpow2(tc.y1, level);
    res.pdx = tccp.prcw[r];
    res.pdy = tccp.prch[r];
    const int64_t tlx = floordivpow2(res.x0, res.pdx) << res.pdx;
    const int64_t tly = floordivpow2(res.y0, res.pdy) << res.pdy;
    const int64_t brx = ceildivpow2(res.x1, res.pdx) << res.pdx;
    const int64_t bry = ceildivpow2(res.y1, res.pdy) << res.pdy;
    res.pw = res.x0 == res.x1 ? 0 : int((brx - tlx) >> res.pdx);
    res.ph = res.y0 == res.y1 ? 0 : int((bry - tly) >> res.pdy);
    if (int64_t(res.pw) * res.ph > (int64_t(1) << 28)) throw Unreadable("too many precincts");
    int64_t tlcbgx, tlcbgy;
    int cbgw, cbgh;
    if (r == 0) {
      tlcbgx = tlx;
      tlcbgy = tly;
      cbgw = res.pdx;
      cbgh = res.pdy;
    } else {
      tlcbgx = ceildivpow2(tlx, 1);
      tlcbgy = ceildivpow2(tly, 1);
      cbgw = res.pdx - 1;
      cbgh = res.pdy - 1;
    }
    const int cblkw = std::min(tccp.cblkw, cbgw), cblkh = std::min(tccp.cblkh, cbgh);
    res.numbands = r == 0 ? 1 : 3;
    for (int b = 0; b < res.numbands; b++) {
      Band& band = res.bands[b];
      band.bandno = r == 0 ? 0 : b + 1;
      if (r == 0) {
        band.x0 = res.x0;
        band.y0 = res.y0;
        band.x1 = res.x1;
        band.y1 = res.y1;
      } else {
        const int nb = tccp.numres - r;
        const int64_t xob = band.bandno & 1, yob = band.bandno >> 1;
        band.x0 = ceildivpow2(tc.x0 - (xob << (nb - 1)), nb);
        band.y0 = ceildivpow2(tc.y0 - (yob << (nb - 1)), nb);
        band.x1 = ceildivpow2(tc.x1 - (xob << (nb - 1)), nb);
        band.y1 = ceildivpow2(tc.y1 - (yob << (nb - 1)), nb);
      }
      const Step& st = tccp.steps[r == 0 ? 0 : 3 * (r - 1) + b + 1];
      const int gain = tccp.qmfbid == 0 ? 0 : (band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1);
      const int numbps = comp.prec + gain;
      band.stepsize = float((1.0 + st.mant / 2048.0) * std::pow(2.0, numbps - st.expn));
      band.numbps = st.expn + tccp.numgbits - 1;
      band.precs.assign(size_t(res.pw) * size_t(res.ph), Prec());
      for (int pno = 0; pno < res.pw * res.ph; pno++) {
        Prec& pr = band.precs[size_t(pno)];
        const int64_t sx = tlcbgx + int64_t(pno % res.pw) * (int64_t(1) << cbgw);
        const int64_t sy = tlcbgy + int64_t(pno / res.pw) * (int64_t(1) << cbgh);
        pr.x0 = std::max(sx, band.x0);
        pr.y0 = std::max(sy, band.y0);
        pr.x1 = std::min(sx + (int64_t(1) << cbgw), band.x1);
        pr.y1 = std::min(sy + (int64_t(1) << cbgh), band.y1);
        const int64_t cbx = floordivpow2(pr.x0, cblkw) << cblkw;
        const int64_t cby = floordivpow2(pr.y0, cblkh) << cblkh;
        const int64_t cex = ceildivpow2(pr.x1, cblkw) << cblkw;
        const int64_t cey = ceildivpow2(pr.y1, cblkh) << cblkh;
        pr.cw = cex > cbx ? int((cex - cbx) >> cblkw) : 0;
        pr.ch = cey > cby ? int((cey - cby) >> cblkh) : 0;
        if (band.empty()) pr.cw = pr.ch = 0;
        pr.cblks.assign(size_t(pr.cw) * size_t(pr.ch), Cblk());
        for (int k = 0; k < pr.cw * pr.ch; k++) {
          Cblk& cb = pr.cblks[size_t(k)];
          const int64_t bx = cbx + int64_t(k % pr.cw) * (int64_t(1) << cblkw);
          const int64_t by = cby + int64_t(k / pr.cw) * (int64_t(1) << cblkh);
          cb.x0 = std::max(bx, pr.x0);
          cb.y0 = std::max(by, pr.y0);
          cb.x1 = std::min(bx + (int64_t(1) << cblkw), pr.x1);
          cb.y1 = std::min(by + (int64_t(1) << cblkh), pr.y1);
        }
        pr.incl.init(pr.cw, pr.ch);
        pr.imsb.init(pr.cw, pr.ch);
      }
    }
  }
}

// ------------------------------------------------------------------ packet iterator

struct PacketId {
  int layno, resno, compno, precno;
};

// every packet of a tile in the order the progression (or the POC list)
// gives, each at most once
std::vector<PacketId> packet_order(const Image& im, const Tcp& tcp, const std::vector<TileComp>& tcs,
                                   int64_t tx0, int64_t ty0, int64_t tx1, int64_t ty1) {
  const int nc = int(im.comps.size());
  int maxres = 0, maxprec = 0;
  for (int c = 0; c < nc; c++) {
    maxres = std::max(maxres, tcs[size_t(c)].numres);
    for (const Res& r : tcs[size_t(c)].res) maxprec = std::max(maxprec, r.pw * r.ph);
  }
  const int64_t step_c = maxprec, step_r = int64_t(nc) * step_c, step_l = maxres * step_r;
  const int64_t npackets = int64_t(tcp.numlayers) * step_l;
  // OpenJPEG's include array: two bytes a packet, calloc'd; a count no
  // allocation holds fails the tile
  if (npackets > (int64_t(1) << 31)) throw Unreadable("too many packets in a tile");
  std::vector<char> dense;
  std::unordered_set<int64_t> sparse;
  const bool use_dense = npackets <= (int64_t(1) << 26);
  if (use_dense) dense.assign(size_t(std::max<int64_t>(1, npackets)), 0);
  std::vector<PacketId> out;
  std::vector<Poc> pocs = tcp.pocs;
  if (pocs.empty()) pocs.push_back(Poc{0, 0, tcp.numlayers, maxres, nc, tcp.prg});
  auto emit = [&](int l, int r, int c, int p) {
    const int64_t idx = l * step_l + r * step_r + c * step_c + p;
    if (idx >= npackets) throw Unreadable("packet index past the tile's packets");
    const bool fresh = use_dense ? !dense[size_t(idx)] : sparse.insert(idx).second;
    if (fresh) {
      if (use_dense) dense[size_t(idx)] = 1;
      out.push_back(PacketId{l, r, c, p});
    }
  };
  for (const Poc& poc : pocs) {
    const int layno1 = std::min(poc.layno1, tcp.numlayers);
    const int resno0 = poc.resno0, resno1 = poc.resno1;
    const int compno0 = poc.compno0, compno1 = std::min(poc.compno1, nc);
    auto precincts = [&](int r, int c, auto&& f) {
      const TileComp& tc = tcs[size_t(c)];
      if (r >= tc.numres) return;
      const Res& res = tc.res[size_t(r)];
      for (int p = 0; p < res.pw * res.ph; p++) f(p);
    };
    // the position-driven orders: the precinct at (x, y) of each resolution
    auto position = [&](int c, int r, int64_t x, int64_t y) -> int {
      const TileComp& tc = tcs[size_t(c)];
      if (r >= tc.numres) return -1;
      const Res& res = tc.res[size_t(r)];
      const Comp& comp = im.comps[size_t(c)];
      const int levelno = tc.numres - 1 - r;
      const int64_t trx0 = ceildiv(tx0, int64_t(comp.dx) << levelno);
      const int64_t try0 = ceildiv(ty0, int64_t(comp.dy) << levelno);
      const int64_t trx1 = ceildiv(tx1, int64_t(comp.dx) << levelno);
      const int64_t try1 = ceildiv(ty1, int64_t(comp.dy) << levelno);
      const int rpx = res.pdx + levelno, rpy = res.pdy + levelno;
      if (rpx >= 62 || rpy >= 62) return -1;
      if (!(y % (int64_t(comp.dy) << rpy) == 0 ||
            (y == ty0 && ((try0 << levelno) % (int64_t(1) << rpy)))))
        return -1;
      if (!(x % (int64_t(comp.dx) << rpx) == 0 ||
            (x == tx0 && ((trx0 << levelno) % (int64_t(1) << rpx)))))
        return -1;
      if (res.pw == 0 || res.ph == 0) return -1;
      if (trx0 == trx1 || try0 == try1) return -1;
      const int64_t prci = floordivpow2(ceildiv(x, int64_t(comp.dx) << levelno), res.pdx) -
                           floordivpow2(trx0, res.pdx);
      const int64_t prcj = floordivpow2(ceildiv(y, int64_t(comp.dy) << levelno), res.pdy) -
                           floordivpow2(try0, res.pdy);
      return int(prci + prcj * res.pw);
    };
    auto steps = [&](int c0, int c1, int64_t& dx, int64_t& dy) {
      dx = dy = 0;
      for (int c = c0; c < c1; c++) {
        const TileComp& tc = tcs[size_t(c)];
        for (int r = 0; r < tc.numres; r++) {
          const Res& res = tc.res[size_t(r)];
          const int sx = res.pdx + tc.numres - 1 - r, sy = res.pdy + tc.numres - 1 - r;
          if (sx < 31) {
            const int64_t v = int64_t(im.comps[size_t(c)].dx) << sx;
            if (v <= 0xffffffffLL) dx = dx ? std::min(dx, v) : v;
          }
          if (sy < 31) {
            const int64_t v = int64_t(im.comps[size_t(c)].dy) << sy;
            if (v <= 0xffffffffLL) dy = dy ? std::min(dy, v) : v;
          }
        }
      }
    };
    switch (poc.prg) {
      case 0:  // LRCP
        for (int l = 0; l < layno1; l++)
          for (int r = resno0; r < resno1; r++)
            for (int c = compno0; c < compno1; c++) precincts(r, c, [&](int p) { emit(l, r, c, p); });
        break;
      case 1:  // RLCP
        for (int r = resno0; r < resno1; r++)
          for (int l = 0; l < layno1; l++)
            for (int c = compno0; c < compno1; c++) precincts(r, c, [&](int p) { emit(l, r, c, p); });
        break;
      case 2: {  // RPCL
        int64_t dx, dy;
        steps(0, nc, dx, dy);
        if (dx == 0 || dy == 0) break;
        for (int r = resno0; r < resno1; r++)
          for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
            for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
              for (int c = compno0; c < compno1; c++) {
                const int p = position(c, r, x, y);
                if (p < 0) continue;
                for (int l = 0; l < layno1; l++) emit(l, r, c, p);
              }
        break;
      }
      case 3: {  // PCRL
        int64_t dx, dy;
        steps(0, nc, dx, dy);
        if (dx == 0 || dy == 0) break;
        for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
          for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
            for (int c = compno0; c < compno1; c++) {
              const int rmax = std::min(resno1, tcs[size_t(c)].numres);
              for (int r = resno0; r < rmax; r++) {
                const int p = position(c, r, x, y);
                if (p < 0) continue;
                for (int l = 0; l < layno1; l++) emit(l, r, c, p);
              }
            }
        break;
      }
      case 4: {  // CPRL
        for (int c = compno0; c < compno1; c++) {
          int64_t dx, dy;
          steps(c, c + 1, dx, dy);
          if (dx == 0 || dy == 0) continue;
          const int rmax = std::min(resno1, tcs[size_t(c)].numres);
          for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
            for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
              for (int r = resno0; r < rmax; r++) {
                const int p = position(c, r, x, y);
                if (p < 0) continue;
                for (int l = 0; l < layno1; l++) emit(l, r, c, p);
              }
        }
        break;
      }
      default:
        throw Unreadable("unknown progression order");
    }
  }
  return out;
}

// ------------------------------------------------------------------ tier 2

int numpasses(Bio& bio) {
  if (!bio.bit()) return 1;
  if (!bio.bit()) return 2;
  int n = int(bio.read(2));
  if (n != 3) return 3 + n;
  n = int(bio.read(5));
  if (n != 31) return 6 + n;
  return 37 + int(bio.read(7));
}

void init_seg(Cblk& cb, size_t index, int cblksty, bool first) {
  if (cb.segs.size() <= index) cb.segs.resize(index + 1);
  Seg& s = cb.segs[index];
  s = Seg();
  if (cblksty & 4) {
    s.maxpasses = 1;
  } else if (cblksty & 1) {
    if (first) s.maxpasses = 10;
    else {
      const int prev = cb.segs[index - 1].maxpasses;
      s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
    }
  } else {
    s.maxpasses = 109;
  }
}

struct HeaderSource {
  const uint8_t* p;
  int64_t len;
};

// one packet: its header (from the data, or from PPM / PPT) and its body
void read_packet(const Tcp& tcp, std::vector<TileComp>& tcs, const PacketId& id, const uint8_t*& data,
                 int64_t& left, HeaderSource* packed) {
  const int cblksty = tcp.tccps[size_t(id.compno)].cblksty;
  if (tcp.csty & 2) {  // SOP: optional, skipped where present
    if (left >= 6 && data[0] == 0xff && data[1] == 0x91) {
      data += 6;
      left -= 6;
    }
  }
  const uint8_t* hstart = packed ? packed->p : data;
  const int64_t hlen = packed ? packed->len : left;
  Bio bio(hstart, hlen);
  Res& res = tcs[size_t(id.compno)].res[size_t(id.resno)];
  auto finish_header = [&]() {
    bio.inalign();
    const uint8_t* h = hstart + bio.numbytes();
    if (tcp.csty & 4) {  // EPH: required
      if (hlen - (h - hstart) < 2) throw Unreadable("not enough space for expected EPH marker");
      if (h[0] != 0xff || h[1] != 0x92) throw Unreadable("expected EPH marker");
      h += 2;
    }
    const int64_t used = h - hstart;
    if (packed) {
      packed->p += used;
      packed->len -= used;
    } else {
      data += used;
      left -= used;
    }
  };
  if (!bio.bit()) {
    finish_header();
    return;
  }
  for (int b = 0; b < res.numbands; b++) {
    Band& band = res.bands[b];
    if (band.empty()) continue;
    if (size_t(id.precno) >= band.precs.size()) continue;
    Prec& pr = band.precs[size_t(id.precno)];
    for (int k = 0; k < pr.cw * pr.ch; k++) {
      Cblk& cb = pr.cblks[size_t(k)];
      int included;
      if (!cb.numsegs) included = pr.incl.decode(bio, k, id.layno + 1);
      else included = int(bio.bit());
      if (!included) {
        cb.numnewpasses = 0;
        continue;
      }
      if (!cb.numsegs) {
        int i = 0;
        while (!pr.imsb.decode(bio, k, i)) ++i;
        cb.numbps = band.numbps + 1 - i;
        cb.numlenbits = 3;
      }
      cb.numnewpasses = numpasses(bio);
      int n = 0;
      while (bio.bit()) n++;
      cb.numlenbits += n;
      size_t segno;
      if (!cb.numsegs) {
        segno = 0;
        init_seg(cb, 0, cblksty, true);
      } else {
        segno = size_t(cb.numsegs - 1);
        if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
          ++segno;
          init_seg(cb, segno, cblksty, false);
        }
      }
      int left_passes = cb.numnewpasses;
      do {
        Seg& s = cb.segs[segno];
        if (cblksty & 0x40) s.numnewpasses = segno == 0 ? 1 : left_passes;  // HT
        else s.numnewpasses = std::min(s.maxpasses - s.numpasses, left_passes);
        const int bits = cb.numlenbits + floorlog2(uint32_t(s.numnewpasses));
        if (bits > 32) throw Unreadable("code-block segment length of more than 32 bits");
        s.newlen = int(bio.read(bits));
        if (s.newlen < 0) throw Unreadable("code-block segment too long");
        left_passes -= s.numnewpasses;
        if (left_passes > 0) {
          ++segno;
          init_seg(cb, segno, cblksty, false);
        }
      } while (left_passes > 0);
    }
  }
  finish_header();
  // the body
  for (int b = 0; b < res.numbands; b++) {
    Band& band = res.bands[b];
    if (band.empty()) continue;
    if (size_t(id.precno) >= band.precs.size()) continue;
    Prec& pr = band.precs[size_t(id.precno)];
    for (Cblk& cb : pr.cblks) {
      if (!cb.numnewpasses) continue;
      size_t segno;
      if (!cb.numsegs) {
        segno = 0;
        cb.numsegs = 1;
      } else {
        segno = size_t(cb.numsegs - 1);
        if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
          ++segno;
          ++cb.numsegs;
        }
      }
      do {
        Seg& s = cb.segs[segno];
        if (s.newlen > left)
          throw Unreadable("a code-block segment runs past the tile's data");
        cb.chunks.emplace_back(data, s.newlen);
        data += s.newlen;
        left -= s.newlen;
        s.len += s.newlen;
        s.numpasses += s.numnewpasses;
        cb.numnewpasses -= s.numnewpasses;
        if (cb.numnewpasses > 0) {
          ++segno;
          ++cb.numsegs;
        }
      } while (cb.numnewpasses > 0);
    }
  }
}

// ------------------------------------------------------------------ tier 1

// MQ decoder (T.800 Annex C), as OpenJPEG runs it: a segment is followed
// by two 0xFF bytes, so reading past it feeds 1 bits
struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};
const MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0ac1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1c01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1c01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0ac1, 31, 28, 0}, {0x09c1, 32, 29, 0},
    {0x08a1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02a1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NCTX = 19 };

struct Mq {
  const uint8_t* bp;
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t st[NCTX], mps[NCTX];
  void reset() {
    for (int i = 0; i < NCTX; i++) st[i] = mps[i] = 0;
    st[CTX_UNI] = 46;
    st[CTX_AGG] = 3;
    st[CTX_ZC] = 4;
  }
  void bytein() {
    const uint32_t next = bp[1];
    if (bp[0] == 0xff) {
      if (next > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        bp++;
        c += next << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += next << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* p, int len) {  // p[len], p[len + 1] are 0xFF
    bp = p;
    c = len == 0 ? 0xffu << 16 : uint32_t(p[0]) << 16;
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
      ct--;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    const MqState& s = kMq[st[cx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {  // LPS exchange
      if (a < s.qe) {
        d = mps[cx];
        st[cx] = s.nmps;
      } else {
        d = 1 - mps[cx];
        if (s.sw) mps[cx] = uint8_t(1 - mps[cx]);
        st[cx] = s.nlps;
      }
      a = s.qe;
      renorm();
    } else {
      c -= uint32_t(s.qe) << 16;
      if ((a & 0x8000) == 0) {  // MPS exchange
        if (a < s.qe) {
          d = 1 - mps[cx];
          if (s.sw) mps[cx] = uint8_t(1 - mps[cx]);
          st[cx] = s.nlps;
        } else {
          d = mps[cx];
          st[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  // raw (bypass) segments
  void raw_init(const uint8_t* p) {
    bp = p;
    c = 0;
    ct = 0;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xff) {
        if (*bp > 0x8f) {
          c = 0xff;
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
    ct--;
    return int((c >> ct) & 1);
  }
};

// a sample's flags: its 8 neighbours' significance, the signs of its 4
// direct neighbours (set with their significance), and its own state
enum : uint16_t {
  F_N = 1, F_S = 2, F_W = 4, F_E = 8, F_NW = 16, F_NE = 32, F_SW = 64, F_SE = 128,
  F_SGN_N = 256, F_SGN_S = 512, F_SGN_W = 1024, F_SGN_E = 2048,
  F_SIG = 4096, F_PI = 8192, F_MU = 16384, F_NEG = 32768,
};

// the zero-coding context of each neighbourhood (T.800 Table D.1) by
// orientation (LL / LH, HL, HH share the LL table but for HL's swap), and
// the sign-coding context and xor bit of each (T.800 Table D.3)
struct T1Tables {
  uint8_t zc[4][256];
  uint8_t sc[256], sc_xor[256];
  T1Tables() {
    for (int orient = 0; orient < 4; orient++)
      for (int f = 0; f < 256; f++) {
        int hs = !!(f & F_W) + !!(f & F_E), vs = !!(f & F_N) + !!(f & F_S);
        const int ds = !!(f & F_NW) + !!(f & F_NE) + !!(f & F_SW) + !!(f & F_SE);
        int cx;
        if (orient == 1) std::swap(hs, vs);
        if (orient == 3) {
          const int hv = hs + vs;
          if (ds >= 3) cx = 8;
          else if (ds == 2) cx = hv >= 1 ? 7 : 6;
          else if (ds == 1) cx = hv >= 2 ? 5 : hv == 1 ? 4 : 3;
          else cx = hv >= 2 ? 2 : hv == 1 ? 1 : 0;
        } else if (hs == 2) {
          cx = 8;
        } else if (hs == 1) {
          cx = vs >= 1 ? 7 : ds >= 1 ? 6 : 5;
        } else if (vs == 2) {
          cx = 4;
        } else if (vs == 1) {
          cx = 3;
        } else {
          cx = ds >= 2 ? 2 : ds == 1 ? 1 : 0;
        }
        zc[orient][f] = uint8_t(cx);
      }
    // index: the significance of N, S, W, E (bits 0-3) and their signs (4-7)
    for (int f = 0; f < 256; f++) {
      auto contrib = [&](int sig_bit, int sgn_bit) {
        return (f & sig_bit) ? ((f & sgn_bit) ? -1 : 1) : 0;
      };
      int hc = contrib(4, 64) + contrib(8, 128), vc = contrib(1, 16) + contrib(2, 32);
      hc = std::max(-1, std::min(1, hc));
      vc = std::max(-1, std::min(1, vc));
      int xorbit = 0;
      if (hc < 0 || (hc == 0 && vc < 0)) {
        xorbit = 1;
        hc = -hc;
        vc = -vc;
      }
      sc[f] = uint8_t(hc == 0 ? CTX_SC + (vc != 0) : CTX_SC + 3 + vc);
      sc_xor[f] = uint8_t(xorbit);
    }
  }
};
const T1Tables kT1;

struct T1 {
  int w, h, stride;
  std::vector<uint16_t> flags;  // padded (h + 2) x (w + 2)
  std::vector<int32_t> data;    // w x h
  Mq mq;
  bool vsc = false;
  int orient = 0;

  void init(int w_, int h_) {
    w = w_;
    h = h_;
    stride = w + 2;
    flags.assign(size_t(stride) * size_t(h + 2), 0);
    data.assign(size_t(w) * size_t(h), 0);
  }
  int at(int x, int y) const { return (y + 1) * stride + x + 1; }
  int zc_ctx(uint16_t f) const { return kT1.zc[orient][f & 0xff]; }
  static int sc_index(uint16_t f) {
    return (f & 0xf) | ((f >> 4) & 0xf0);  // N S W E significance, then their signs
  }
  // (x, y) turns significant: its neighbours learn it, but with VSC the
  // row above a stripe's first row does not (it ignores what lies below)
  void set_sig(int x, int y, int negative, int32_t value) {
    const int i = at(x, y);
    uint16_t* f = flags.data();
    f[i] |= uint16_t(F_SIG | (negative ? F_NEG : 0));
    f[i - 1] |= uint16_t(F_E | (negative ? F_SGN_E : 0));
    f[i + 1] |= uint16_t(F_W | (negative ? F_SGN_W : 0));
    if (!(vsc && y % 4 == 0)) {
      f[i - stride] |= uint16_t(F_S | (negative ? F_SGN_S : 0));
      f[i - stride - 1] |= F_SE;
      f[i - stride + 1] |= F_SW;
    }
    f[i + stride] |= uint16_t(F_N | (negative ? F_SGN_N : 0));
    f[i + stride - 1] |= F_NE;
    f[i + stride + 1] |= F_NW;
    data[size_t(y) * size_t(w) + size_t(x)] = negative ? -value : value;
  }
  int sign(uint16_t f, bool raw) {
    if (raw) return mq.raw();
    const int k = sc_index(f);
    return mq.decode(kT1.sc[k]) ^ kT1.sc_xor[k];
  }

  void sigpass(int bpno, bool raw) {
    const int32_t one = int32_t(1) << bpno, half = one >> 1, oph = one | half;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; x++)
        for (int y = k; y < std::min(k + 4, h); y++) {
          const int i = at(x, y);
          const uint16_t f = flags[size_t(i)];
          if ((f & (F_SIG | F_PI)) || !(f & 0xff)) continue;
          const int v = raw ? mq.raw() : mq.decode(zc_ctx(f));
          if (v) set_sig(x, y, sign(f, raw), oph);
          flags[size_t(i)] |= F_PI;
        }
  }
  void refpass(int bpno, bool raw) {
    const int32_t poshalf = (int32_t(1) << bpno) >> 1;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; x++)
        for (int y = k; y < std::min(k + 4, h); y++) {
          const int i = at(x, y);
          const uint16_t f = flags[size_t(i)];
          if ((f & (F_SIG | F_PI)) != F_SIG) continue;
          int v;
          if (raw) v = mq.raw();
          else v = mq.decode((f & F_MU) ? CTX_MAG + 2 : (f & 0xff) ? CTX_MAG + 1 : CTX_MAG);
          int32_t& d = data[size_t(y) * size_t(w) + size_t(x)];
          d += (v ^ (d < 0)) ? poshalf : -poshalf;
          flags[size_t(i)] |= F_MU;
        }
  }
  void clnpass(int bpno, bool segsym) {
    const int32_t one = int32_t(1) << bpno, half = one >> 1, oph = one | half;
    auto step = [&](int x, int y, bool known) {
      const uint16_t f = flags[size_t(at(x, y))];
      if (!known) {
        if (f & (F_SIG | F_PI)) return;
        if (!mq.decode(zc_ctx(f))) return;
      }
      set_sig(x, y, sign(f, false), oph);
    };
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; x++) {
        int y0 = k;
        if (k + 3 < h) {
          bool run = true;
          for (int y = k; y < k + 4 && run; y++)
            if (flags[size_t(at(x, y))] & (F_SIG | F_PI | 0xff)) run = false;
          if (run) {
            if (!mq.decode(CTX_AGG)) continue;
            int r = mq.decode(CTX_UNI);
            r = (r << 1) | mq.decode(CTX_UNI);
            step(x, k + r, true);
            y0 = k + r + 1;
          }
        }
        for (int y = y0; y < std::min(k + 4, h); y++) step(x, y, false);
      }
    for (uint16_t& f : flags) f &= uint16_t(~F_PI);
    if (segsym) {
      for (int i = 0; i < 4; i++) mq.decode(CTX_UNI);
    }
  }
};

// decode one code-block into `out` (its w * h stored values, doubled as
// OpenJPEG stores them); false where OpenJPEG fails the block
bool decode_cblk(T1& t1, const Cblk& cb, int orient, int roishift, int cblksty) {
  const int w = int(cb.x1 - cb.x0), h = int(cb.y1 - cb.y0);
  t1.init(w, h);
  t1.vsc = cblksty & 8;
  t1.orient = orient;
  int bpno_plus_one = roishift + cb.numbps;
  if (bpno_plus_one >= 31) return false;  // every code-block, included or not
  if (cb.chunks.empty()) return true;
  // the segments' bytes in one buffer, two spare bytes after each segment
  size_t total = 0;
  for (const auto& ch : cb.chunks) total += size_t(ch.second);
  std::vector<uint8_t> buf(total + 2, 0);
  size_t at = 0;
  for (const auto& ch : cb.chunks) {
    std::memcpy(buf.data() + at, ch.first, size_t(ch.second));
    at += size_t(ch.second);
  }
  int passtype = 2;
  t1.mq.reset();
  size_t index = 0;
  for (int segno = 0; segno < cb.numsegs; segno++) {
    const Seg& seg = cb.segs[size_t(segno)];
    const bool raw = bpno_plus_one <= cb.numbps - 4 && passtype < 2 && (cblksty & 1);
    // OpenJPEG writes 0xFF 0xFF past the segment for the decoder and puts
    // the bytes back afterwards
    uint8_t saved[2] = {buf[index + size_t(seg.len)], buf[index + size_t(seg.len) + 1]};
    buf[index + size_t(seg.len)] = buf[index + size_t(seg.len) + 1] = 0xff;
    if (raw) t1.mq.raw_init(buf.data() + index);
    else t1.mq.init(buf.data() + index, seg.len);
    for (int p = 0; p < seg.numpasses && bpno_plus_one >= 1; p++) {
      if (passtype == 0) t1.sigpass(bpno_plus_one, raw);
      else if (passtype == 1) t1.refpass(bpno_plus_one, raw);
      else t1.clnpass(bpno_plus_one, cblksty & 32);
      if ((cblksty & 2) && !raw) t1.mq.reset();
      if (++passtype == 3) {
        passtype = 0;
        bpno_plus_one--;
      }
    }
    buf[index + size_t(seg.len)] = saved[0];
    buf[index + size_t(seg.len) + 1] = saved[1];
    index += size_t(seg.len);
  }
  return true;
}

// ------------------------------------------------------------------ wavelets

// one 5/3 line of n samples whose first lies at an even (cas 0) or odd
// (cas 1) coordinate: `x` holds the interleaved low and high samples
void idwt53(int32_t* x, int n, int cas) {
  if (n == 1) {
    if (cas) x[0] /= 2;
    return;
  }
  auto at = [&](int i) {  // symmetric extension
    while (i < 0 || i >= n) {
      if (i < 0) i = -i;
      if (i >= n) i = 2 * (n - 1) - i;
    }
    return x[i];
  };
  for (int i = cas; i < n; i += 2)  // even coordinates (low)
    x[i] = int32_t(uint32_t(x[i]) - uint32_t((int64_t(at(i - 1)) + at(i + 1) + 2) >> 2));
  for (int i = 1 - cas; i < n; i += 2)  // odd coordinates (high)
    x[i] = int32_t(uint32_t(x[i]) + uint32_t((int64_t(at(i - 1)) + at(i + 1)) >> 1));
}

const float kAlpha = -1.586134342f, kBeta = -0.052980118f, kGamma = 0.882911075f,
            kDelta = 0.443506852f, kK = 1.230174105f, kTwoInvK = 1.625732422f;

void idwt97(float* x, int n, int cas) {
  const int sn = cas ? n / 2 : (n + 1) / 2, dn = n - sn;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
  } else {
    if (!(sn > 0 || dn > 1)) return;
  }
  for (int i = cas; i < n; i += 2) x[i] *= kK;
  for (int i = 1 - cas; i < n; i += 2) x[i] *= kTwoInvK;
  auto lift = [&](int first, float c) {
    for (int i = first; i < n; i += 2) {
      const float l = x[i - 1 >= 0 ? i - 1 : i + 1];
      const float r = x[i + 1 < n ? i + 1 : i - 1];
      x[i] = x[i] + (l + r) * c;
    }
  };
  lift(cas, -kDelta);
  lift(1 - cas, -kGamma);
  lift(cas, -kBeta);
  lift(1 - cas, -kAlpha);
}

template <typename T, typename F>
void idwt2d(std::vector<T>& data, const TileComp& tc, F line) {
  const int64_t w = tc.x1 - tc.x0;
  std::vector<T> tmp;
  for (int r = 1; r < tc.numres; r++) {
    const Res& lo = tc.res[size_t(r - 1)];
    const Res& res = tc.res[size_t(r)];
    const int rw = int(res.x1 - res.x0), rh = int(res.y1 - res.y0);
    const int sw = int(lo.x1 - lo.x0), shh = int(lo.y1 - lo.y0);
    const int casx = int(res.x0 & 1), casy = int(res.y0 & 1);
    tmp.assign(size_t(std::max(rw, rh)), T());
    for (int y = 0; y < rh; y++) {
      T* row = data.data() + size_t(y) * size_t(w);
      for (int i = 0; i < sw; i++) tmp[size_t(casx + 2 * i)] = row[i];
      for (int i = 0; i < rw - sw; i++) tmp[size_t(1 - casx + 2 * i)] = row[sw + i];
      line(tmp.data(), rw, casx);
      std::copy(tmp.begin(), tmp.begin() + rw, row);
    }
    for (int x = 0; x < rw; x++) {
      T* col = data.data() + x;
      for (int i = 0; i < shh; i++) tmp[size_t(casy + 2 * i)] = col[size_t(i) * size_t(w)];
      for (int i = 0; i < rh - shh; i++) tmp[size_t(1 - casy + 2 * i)] = col[size_t(shh + i) * size_t(w)];
      line(tmp.data(), rh, casy);
      for (int i = 0; i < rh; i++) col[size_t(i) * size_t(w)] = tmp[size_t(i)];
    }
  }
}

// ------------------------------------------------------------------ tiles

struct Decoded {
  std::vector<std::vector<int32_t>> comps;  // per component, w * h
  std::vector<int64_t> cw, ch;
};

void decode_tile(const Image& im, Tcp& tcp, int tileno, Decoded& out,
                 std::vector<uint8_t>* ppm_stream, int64_t* ppm_at) {
  const int p = tileno % im.tw, q = tileno / im.tw;
  const int64_t tx0 = std::max(im.tx0 + p * im.tdx, im.x0);
  const int64_t ty0 = std::max(im.ty0 + q * im.tdy, im.y0);
  const int64_t tx1 = std::min(im.tx0 + (p + 1) * im.tdx, im.x1);
  const int64_t ty1 = std::min(im.ty0 + (q + 1) * im.tdy, im.y1);
  const int nc = int(im.comps.size());
  std::vector<TileComp> tcs(static_cast<size_t>(nc));
  for (int c = 0; c < nc; c++)
    init_tilecomp(tcs[size_t(c)], tcp.tccps[size_t(c)], im.comps[size_t(c)], tx0, ty0, tx1, ty1);
  // packet headers moved out of the packets
  std::vector<uint8_t> ppt;
  HeaderSource packed{nullptr, 0}, *hs = nullptr;
  if (im.has_ppm) {
    packed = HeaderSource{ppm_stream->data() + *ppm_at, int64_t(ppm_stream->size()) - *ppm_at};
    hs = &packed;
  } else if (!tcp.ppt.empty()) {
    auto parts = tcp.ppt;
    std::stable_sort(parts.begin(), parts.end(),
                     [](const auto& a, const auto& b) { return a.first < b.first; });
    for (auto& part : parts) ppt.insert(ppt.end(), part.second.begin(), part.second.end());
    packed = HeaderSource{ppt.data(), int64_t(ppt.size())};
    hs = &packed;
  }
  const std::vector<PacketId> order = packet_order(im, tcp, tcs, tx0, ty0, tx1, ty1);
  const uint8_t* data = tcp.data.data();
  int64_t left = int64_t(tcp.data.size());
  for (const PacketId& id : order) {
    read_packet(tcp, tcs, id, data, left, hs);
  }
  if (im.has_ppm) *ppm_at = int64_t(ppm_stream->size()) - packed.len;
  // tier 1 and the wavelets, component by component
  T1 t1;
  std::vector<std::vector<int32_t>> comp_i(static_cast<size_t>(nc));
  std::vector<std::vector<float>> comp_f(static_cast<size_t>(nc));
  for (int c = 0; c < nc; c++) {
    TileComp& tc = tcs[size_t(c)];
    const Tccp& tccp = tcp.tccps[size_t(c)];
    if (tccp.cblksty & 0x40) throw std::runtime_error("JPEG 2000 of HT (high-throughput) code-blocks");
    const int64_t w = tc.x1 - tc.x0, h = tc.y1 - tc.y0;
    const bool rev = tccp.qmfbid == 1;
    if (rev) comp_i[size_t(c)].assign(size_t(w * h), 0);
    else comp_f[size_t(c)].assign(size_t(w * h), 0.0f);
    for (int r = 0; r < tc.numres; r++) {
      const Res& res = tc.res[size_t(r)];
      for (int b = 0; b < res.numbands; b++) {
        const Band& band = res.bands[b];
        if (band.empty()) continue;
        for (const Prec& pr : band.precs)
          for (const Cblk& cb : pr.cblks) {
            const int cw = int(cb.x1 - cb.x0), chh = int(cb.y1 - cb.y0);
            if (!decode_cblk(t1, cb, band.bandno, tccp.roishift, tccp.cblksty))
              throw Unreadable("a code-block of too many bit-planes");
            if (cw <= 0 || chh <= 0) continue;
            std::vector<int32_t>& v = t1.data;
            if (tccp.roishift) {
              if (tccp.roishift >= 31) {
                for (auto& d : v) d = 0;
              } else {
                const int32_t thresh = int32_t(1) << tccp.roishift;
                for (auto& d : v) {
                  int32_t mag = d < 0 ? -d : d;
                  if (mag >= thresh) {
                    mag >>= tccp.roishift;
                    d = d < 0 ? -mag : mag;
                  }
                }
              }
            }
            int64_t x = cb.x0 - band.x0, y = cb.y0 - band.y0;
            if (band.bandno & 1) x += tc.res[size_t(r - 1)].x1 - tc.res[size_t(r - 1)].x0;
            if (band.bandno & 2) y += tc.res[size_t(r - 1)].y1 - tc.res[size_t(r - 1)].y0;
            const float step = 0.5f * band.stepsize;
            for (int j = 0; j < chh; j++)
              for (int i = 0; i < cw; i++) {
                const int32_t d = v[size_t(j) * size_t(cw) + size_t(i)];
                const size_t o = size_t((y + j) * w + x + i);
                if (rev) comp_i[size_t(c)][o] = d / 2;
                else comp_f[size_t(c)][o] = float(d) * step;
              }
          }
      }
    }
    if (rev) idwt2d(comp_i[size_t(c)], tc, idwt53);
    else idwt2d(comp_f[size_t(c)], tc, idwt97);
  }
  // the component transform, over the first three components
  if (tcp.mct == 1 && nc >= 3) {
    const size_t n0 = comp_i[0].size() + comp_f[0].size();
    for (int c = 1; c < 3; c++)
      if (comp_i[size_t(c)].size() + comp_f[size_t(c)].size() != n0)
        throw Unreadable("tiles don't all have the same dimension: the MCT step fails");
    if (tcp.tccps[0].qmfbid == 1) {
      auto &c0 = comp_i[0], &c1 = comp_i[1], &c2 = comp_i[2];
      if (c1.empty() || c2.empty()) throw Unreadable("MCT of mixed transforms");
      for (size_t i = 0; i < c0.size(); i++) {
        const int32_t y = c0[i], u = c1[i], v = c2[i];
        const int32_t g = y - ((u + v) >> 2);
        c0[i] = v + g;
        c1[i] = g;
        c2[i] = u + g;
      }
    } else {
      auto &c0 = comp_f[0], &c1 = comp_f[1], &c2 = comp_f[2];
      if (c1.empty() || c2.empty()) throw Unreadable("MCT of mixed transforms");
      for (size_t i = 0; i < c0.size(); i++) {
        const float y = c0[i], u = c1[i], v = c2[i];
        const float r = y + (v * 1.402f);
        float g = y - (u * 0.34413f);
        g = g - (v * 0.71414f);
        const float b = y + (u * 1.772f);
        c0[i] = r;
        c1[i] = g;
        c2[i] = b;
      }
    }
  }
  // DC level shift and clamp, then into the image
  for (int c = 0; c < nc; c++) {
    const Comp& comp = im.comps[size_t(c)];
    const TileComp& tc = tcs[size_t(c)];
    const int64_t w = tc.x1 - tc.x0, h = tc.y1 - tc.y0;
    const int32_t lo = comp.sgnd ? -(1 << (comp.prec - 1)) : 0;
    const int32_t hi = comp.sgnd ? (1 << (comp.prec - 1)) - 1 : int32_t((1u << comp.prec) - 1);
    const int32_t shift = comp.sgnd || !tcp.dc_shift ? 0 : 1 << (comp.prec - 1);
    const int64_t cx0 = ceildiv(im.x0, comp.dx), cy0 = ceildiv(im.y0, comp.dy);
    std::vector<int32_t>& dst = out.comps[size_t(c)];
    const int64_t dw = out.cw[size_t(c)];
    const bool rev = tcp.tccps[size_t(c)].qmfbid == 1;
    for (int64_t y = 0; y < h; y++)
      for (int64_t x = 0; x < w; x++) {
        const size_t i = size_t(y * w + x);
        int64_t v;
        if (rev) {
          v = int64_t(comp_i[size_t(c)][i]) + shift;
        } else {
          const float f = comp_f[size_t(c)][i];
          if (f > float(INT32_MAX)) {
            v = hi;
          } else if (f < float(INT32_MIN)) {
            v = lo;
          } else {
            v = int64_t(std::lrintf(f)) + shift;
          }
        }
        v = std::max<int64_t>(lo, std::min<int64_t>(hi, v));
        dst[size_t((tc.y0 - cy0 + y) * dw + (tc.x0 - cx0 + x))] = int32_t(v);
      }
  }
}

// ------------------------------------------------------------------ codestream

Tcp fresh_tcp(int nc) {
  Tcp t;
  t.tccps.assign(size_t(nc), Tccp());
  t.coc.assign(size_t(nc), 0);
  t.qcc.assign(size_t(nc), 0);
  return t;
}

// where OpenJPEG's marker table allows a marker: 1 main header, 2 tile-part
// header, 4 SIZ's place right after SOC; 0 a known marker allowed nowhere
// (SOP); -1 an unknown one (which it scans past in the main header)
int marker_states(uint32_t m) {
  switch (m) {
    case 0xff90: return 1;                  // SOT
    case 0xff52: case 0xff53: case 0xff5e:  // COD, COC, RGN
    case 0xff5c: case 0xff5d: case 0xff5f:  // QCD, QCC, POC
    case 0xff64: case 0xff74: case 0xff75: case 0xff77:  // COM, MCT, MCC, MCO
      return 3;
    case 0xff51: return 4;                  // SIZ
    case 0xff55: case 0xff57: case 0xff60: case 0xff63:  // TLM, PLM, PPM, CRG
    case 0xff78: case 0xff50: case 0xff59:  // CBD, CAP, CPF
      return 1;
    case 0xff58: case 0xff61: return 2;     // PLT, PPT
    case 0xff91: return 0;                  // SOP
    default: return -1;
  }
}

void read_tlm(int64_t n) {  // an invalid TLM only warns (it only helps seeking)
  if (n < 2) throw Unreadable("error reading the TLM marker");
}

void read_plt(const uint8_t* p, int64_t n) {
  if (n < 1) throw Unreadable("error reading the PLT marker");
  uint32_t len = 0;
  for (int64_t i = 1; i < n; i++) {
    len |= p[i] & 0x7f;
    if (p[i] & 0x80) len <<= 7;
    else len = 0;
  }
  if (len != 0) throw Unreadable("error reading the PLT marker");
}

// Part 2's multi-component transform markers (MCT, MCC, MCO, CBD) as far as
// the port follows OpenJPEG: the segments it rejects fail, the ones it
// ignores (another record of a multi-record MCT or MCC, several MCO
// stages) pass, and the rest raise (the port does not apply them)
void read_part2(const Image& im, Tcp& tcp, uint32_t m, const uint8_t* p, int64_t n) {
  auto refuse = [] { throw std::runtime_error("JPEG 2000 Part 2 multi-component transforms"); };
  switch (m) {
    case 0xff74:  // MCT
      if (n < 2) throw Unreadable("error reading the MCT marker");
      if (be(p, 2) != 0) return;
      if (n <= 6) throw Unreadable("error reading the MCT marker");
      if (be(p + 4, 2) != 0) return;
      return;  // a decorrelation array no COD can select (mct > 1 fails)
    case 0xff75:  // MCC
      if (n < 2) throw Unreadable("error reading the MCC marker");
      if (be(p, 2) != 0) return;
      if (n < 7) throw Unreadable("error reading the MCC marker");
      if (be(p + 3, 2) != 0) return;        // Ymcc: another record
      if (be(p + 5, 2) > 1) return;         // Qmcc: several collections
      if (be(p + 5, 2) == 0) {
        if (n != 7) throw Unreadable("error reading the MCC marker");
        return;
      }
      if (n < 10) throw Unreadable("error reading the MCC marker");  // a collection's head
      refuse();
      return;
    case 0xff77:  // MCO
      if (n < 1) throw Unreadable("error reading the MCO marker");
      if (p[0] > 1) return;
      if (n != p[0] + 1) throw Unreadable("error reading the MCO marker");
      if (p[0] == 1) refuse();  // a stage, which the port does not apply
      tcp.dc_shift = false;
      return;
    default:  // CBD
      if (n != int64_t(im.comps.size()) + 2 || be(p, 2) != im.comps.size())
        throw Unreadable("error reading the CBD marker");
      refuse();
  }
}

// the main header, through to the first SOT (left at the SOT marker), as
// opj_j2k_read_header_procedure reads it
void read_main_header(Image& im, Stream& s) {
  if (s.left() < 2 || be(s.d, 2) != 0xff4f) throw Unreadable("expected a SOC marker");
  s.pos = 2;
  auto read2 = [&]() -> uint32_t {
    if (s.left() < 2) throw Unreadable("stream too short");
    const uint32_t v = be(s.d + s.pos, 2);
    s.pos += 2;
    return v;
  };
  bool siz = false, cod = false, qcd = false;
  int state = 4;  // SIZ must come first
  uint32_t m = read2();
  while (m != 0xff90) {
    if (m < 0xff00) throw Unreadable("a marker ID was expected");
    int st = marker_states(m);
    if (st == -1) {  // opj_j2k_read_unk: scan two bytes at a time for a known marker
      for (;;) {
        const uint32_t u = read2();
        if (u < 0xff00) continue;
        const int us = marker_states(u);
        if (us == -1) continue;
        if (!(us & state)) throw Unreadable("marker is not compliant with its position");
        m = u;
        st = us;
        break;
      }
      if (m == 0xff90) break;
    }
    if (!(st & state)) throw Unreadable("marker is not compliant with its position");
    const int64_t len = read2();
    if (len < 2) throw Unreadable("invalid marker size");
    const int64_t n = len - 2;
    if (n > s.left()) throw Unreadable("stream too short");
    const uint8_t* p = s.d + s.pos;
    s.pos += n;
    switch (m) {
      case 0xff51:
        read_siz(im, p, n);
        im.deflt = fresh_tcp(int(im.comps.size()));
        siz = true;
        state = 1;
        break;
      case 0xff52:
        read_cod(im, im.deflt, p, n);
        cod = true;
        break;
      case 0xff53: read_coc(im, im.deflt, p, n); break;
      case 0xff5c:
        read_qcd(im, im.deflt, p, n);
        qcd = true;
        break;
      case 0xff5d: read_qcc(im, im.deflt, p, n); break;
      case 0xff5e: read_rgn(im, im.deflt, p, n); break;
      case 0xff5f: read_poc(im, im.deflt, p, n); break;
      case 0xff55: read_tlm(n); break;
      case 0xff57:
        if (n < 1) throw Unreadable("error reading the PLM marker");
        break;
      case 0xff63:
        if (n != int64_t(im.comps.size()) * 4) throw Unreadable("error reading the CRG marker");
        break;
      case 0xff60:  // PPM
        if (n < 1) throw Unreadable("error reading the PPM marker");
        im.ppm.emplace_back(p[0], std::vector<uint8_t>(p + 1, p + n));
        im.has_ppm = true;
        break;
      case 0xff50: case 0xff59:
        throw std::runtime_error("JPEG 2000 of HT (high-throughput) code-blocks");
      case 0xff74: case 0xff75: case 0xff77: case 0xff78:
        read_part2(im, im.deflt, m, p, n);
        break;
      default: break;  // COM
    }
    m = read2();
  }
  if (!siz) throw Unreadable("required SIZ marker not found in main header");
  if (!cod) throw Unreadable("required COD marker not found in main header");
  if (!qcd) throw Unreadable("required QCD marker not found in main header");
  s.pos -= 2;  // at the SOT marker
}

// the tile-parts as OpenJPEG 2.5 reads them (opj_j2k_read_tile_header,
// opj_j2k_read_sot / _sod, the end of opj_j2k_decode_tile): the tiles in the
// order it decodes them, each as soon as its last tile-part (TPsot + 1 ==
// TNsot) is read, the others at EOC; it stops once every tile is decoded
std::vector<int> read_tiles(Image& im, Stream& s) {
  const int ntiles = im.tw * im.th;
  im.tcps.assign(size_t(ntiles), Tcp());
  std::vector<int> order;
  std::vector<char> decoded(size_t(ntiles), 0);
  bool eoc = false, neoc = false;
  int current = 0;
  auto read2 = [&]() -> uint32_t {
    if (s.left() < 2) throw Unreadable("stream too short");
    const uint32_t v = be(s.d + s.pos, 2);
    s.pos += 2;
    return v;
  };
  s.pos += 2;  // the first SOT's marker, read with the main header
  uint32_t marker = 0xff90;
  while (int(order.size()) < ntiles) {
    bool can_decode = false;
    if (eoc) marker = 0xffd9;
    int64_t sot_length = 0;
    bool last_part = false;
    while (!can_decode && marker != 0xffd9) {
      bool sot_seen = false;
      while (marker != 0xff93) {  // to SOD
        if (s.left() == 0) {
          neoc = true;
          break;
        }
        const int64_t size = read2();
        if (size < 2) throw Unreadable("inconsistent marker size");
        if (marker != 0xff90 && sot_length != 0) {
          if (sot_length < size + 2) throw Unreadable("Sot length is less than marker size + marker ID");
          sot_length -= size + 2;
        }
        const int64_t n = size - 2;
        if (marker < 0xff00) throw Unreadable("a marker ID was expected");
        const int st = marker_states(marker);
        if (sot_seen ? marker == 0xff90 || (st != -1 && !(st & 2)) : marker != 0xff90)
          throw Unreadable("marker is not compliant with its position");
        if (n > s.left()) throw Unreadable("stream too short");
        const uint8_t* p = s.d + s.pos;
        s.pos += n;
        if (marker == 0xff90) {  // SOT
          sot_seen = true;
          if (n != 8) throw Unreadable("error reading the SOT marker");
          current = int(be(p, 2));
          const int64_t psot = be(p + 2, 4);
          const int tpsot = p[6], tnsot = p[7];
          if (current >= ntiles) throw Unreadable("invalid tile number");
          Tcp& tcp = im.tcps[size_t(current)];
          if (tcp.parts + 1 != tpsot) throw Unreadable("invalid tile part index");
          if (psot != 0 && psot < 14 && psot != 12) throw Unreadable("invalid Psot");
          if (tnsot) {
            if (tcp.nparts && tpsot >= tcp.nparts) throw Unreadable("TPsot past the tile's TNsot");
            if (tpsot >= tnsot) throw Unreadable("TPsot past TNsot");
            tcp.nparts = tnsot;
          }
          if (tcp.nparts && tcp.nparts == tpsot + 1) can_decode = true;
          tcp.parts = tpsot;
          last_part = psot == 0;
          sot_length = psot ? psot - 12 : 0;
          if (!tcp.seen) {
            const int keep_parts = tcp.parts, keep_n = tcp.nparts;
            tcp = im.deflt;
            tcp.parts = keep_parts;
            tcp.nparts = keep_n;
            std::fill(tcp.coc.begin(), tcp.coc.end(), 0);
            std::fill(tcp.qcc.begin(), tcp.qcc.end(), 0);
            tcp.seen = true;
          }
        } else {
          Tcp& tcp = im.tcps[size_t(current)];
          if (marker == 0xff52) {
            std::fill(tcp.coc.begin(), tcp.coc.end(), 0);
            read_cod(im, tcp, p, n);
          } else if (marker == 0xff53) {
            read_coc(im, tcp, p, n);
          } else if (marker == 0xff5c) {
            std::fill(tcp.qcc.begin(), tcp.qcc.end(), 0);
            read_qcd(im, tcp, p, n);
          } else if (marker == 0xff5d) {
            read_qcc(im, tcp, p, n);
          } else if (marker == 0xff5e) {
            read_rgn(im, tcp, p, n);
          } else if (marker == 0xff5f) {
            read_poc(im, tcp, p, n);
          } else if (marker == 0xff61) {  // PPT
            if (n < 1) throw Unreadable("error reading the PPT marker");
            tcp.ppt.emplace_back(p[0], std::vector<uint8_t>(p + 1, p + n));
          } else if (marker == 0xff58) {
            read_plt(p, n);
          } else if (st == -1) {
            throw Unreadable("unknown marker in a tile-part header");
          } else if (marker != 0xff64) {
            read_part2(im, tcp, marker, p, n);
          }
        }
        marker = read2();
      }
      if (s.left() == 0 && neoc) break;
      // SOD: the tile-part's data
      Tcp& tcp = im.tcps[size_t(current)];
      int64_t len;
      if (last_part) len = s.left() - 2;
      else len = sot_length >= 2 ? sot_length - 2 : sot_length;
      if (len != 0 && (len < 0 || len > s.left()))
        throw Unreadable("tile part length size inconsistent with stream length");
      tcp.data.insert(tcp.data.end(), s.d + s.pos, s.d + s.pos + len);
      tcp.has_data = tcp.has_data || len > 0;
      s.pos += len;
      if (!can_decode) {
        if (s.left() < 2) {
          // a last tile with TPsot == 0 and TNsot == 0 and no EOC (SPOT6 files)
          if (current + 1 == ntiles) {
            int t = 0;
            for (; t < ntiles; t++)
              if (im.tcps[size_t(t)].parts == 0 && im.tcps[size_t(t)].nparts == 0) break;
            if (t < ntiles) {
              current = t;
              marker = 0xffd9;
              eoc = true;
              break;
            }
          }
          throw Unreadable("stream too short");
        }
        marker = read2();
      }
    }
    if (marker == 0xffd9 && !eoc) {
      current = 0;
      eoc = true;
    }
    if (!can_decode) {
      while (current < ntiles && (!im.tcps[size_t(current)].has_data || decoded[size_t(current)]))
        current++;
      if (current == ntiles) {
        // a single tile is decoded whatever the header reading found
        if (ntiles == 1) throw Unreadable("failed to decode tile 1/1 (no data)");
        break;
      }
    }
    if (!im.tcps[size_t(current)].has_data) throw Unreadable("a tile without data");
    order.push_back(current);
    decoded[size_t(current)] = 1;
    // after a tile is decoded: the next marker must be SOT or EOC
    if (!eoc && !neoc) {
      const uint32_t m = read2();
      if (m == 0xffd9) {
        current = 0;
        eoc = true;
      } else if (m != 0xff90) {
        if (s.left() == 0) neoc = true;
        else throw Unreadable("stream too short");
      }
      marker = m;
    }
    if (neoc && !eoc) break;
  }
  return order;
}

struct Decoder {
  Image im;
  Stream s{nullptr, 0};

  void header(const uint8_t* d, int64_t n) {
    s = Stream{d, n, 0};
    read_main_header(im, s);
  }

  Decoded decode() {
    const std::vector<int> tiles = read_tiles(im, s);
    Decoded out;
    const int nc = int(im.comps.size());
    out.comps.resize(size_t(nc));
    out.cw.resize(size_t(nc));
    out.ch.resize(size_t(nc));
    for (int c = 0; c < nc; c++) {
      const Comp& k = im.comps[size_t(c)];
      out.cw[size_t(c)] = ceildiv(im.x1, k.dx) - ceildiv(im.x0, k.dx);
      out.ch[size_t(c)] = ceildiv(im.y1, k.dy) - ceildiv(im.y0, k.dy);
      if (out.cw[size_t(c)] * out.ch[size_t(c)] > kMaxPixels * 4)
        throw std::runtime_error("JPEG 2000 component too large");
      out.comps[size_t(c)].assign(size_t(out.cw[size_t(c)] * out.ch[size_t(c)]), 0);
    }
    std::vector<uint8_t> ppm_stream;
    if (im.has_ppm) {  // the Ippm of every PPM in Zppm order: Nppm, then that many bytes, per tile-part
      auto parts = im.ppm;
      std::stable_sort(parts.begin(), parts.end(),
                       [](const auto& a, const auto& b) { return a.first < b.first; });
      std::vector<uint8_t> all;
      for (auto& p : parts) all.insert(all.end(), p.second.begin(), p.second.end());
      size_t at = 0;
      while (at + 4 <= all.size()) {
        const size_t nppm = be(all.data() + at, 4);
        at += 4;
        const size_t take = std::min(nppm, all.size() - at);
        ppm_stream.insert(ppm_stream.end(), all.begin() + long(at), all.begin() + long(at + take));
        at += take;
      }
    }
    int64_t ppm_at = 0;
    for (int t : tiles) decode_tile(im, im.tcps[size_t(t)], t, out, &ppm_stream, &ppm_at);
    return out;
  }
};

// ------------------------------------------------------------------ JP2 boxes

enum ColorSpace { CS_UNSPECIFIED, CS_UNKNOWN, CS_SRGB, CS_GRAY, CS_SYCC, CS_EYCC, CS_CMYK };

struct Jp2 {
  bool jp2 = false;
  int64_t ihdr_w = 0, ihdr_h = 0;
  int64_t cs_at = 0;  // the codestream's offset
  ColorSpace cs = CS_UNSPECIFIED;
  // palette
  bool has_pclr = false, has_cmap = false, has_cdef = false;
  int nr_entries = 0, nr_channels = 0;
  std::vector<int> ch_size, ch_sign;
  std::vector<int32_t> entries;
  struct CmapEntry {
    int cmp, mtyp, pcol;
  };
  std::vector<CmapEntry> cmap;
  struct CdefEntry {
    int cn, typ, asoc;
  };
  std::vector<CdefEntry> cdef;
};

void read_jp2h(Jp2& j, const uint8_t* p, int64_t n) {
  bool ihdr = false, colr = false;
  int64_t at = 0;
  while (at < n) {
    if (n - at < 8) throw Unreadable("cannot handle a box of less than 8 bytes");
    int64_t len = be(p + at, 4);
    const uint32_t type = be(p + at + 4, 4);
    int64_t hdr = 8;
    if (len == 1) {
      if (n - at < 16) throw Unreadable("cannot handle a box of less than 16 bytes");
      if (be(p + at + 8, 4) != 0) throw Unreadable("cannot handle box sizes higher than 2^32");
      len = be(p + at + 12, 4);
      hdr = 16;
    } else if (len == 0) {
      throw Unreadable("cannot handle a box of undefined size");
    }
    if (len < hdr) throw Unreadable("box length is inconsistent");
    if (len > n - at) throw Unreadable("box length is inconsistent");
    const uint8_t* b = p + at + hdr;
    const int64_t bn = len - hdr;
    if (type == 0x69686472) {  // ihdr
      if (!ihdr) {
        if (bn != 14) throw Unreadable("bad image header box (bad size)");
        const uint32_t nc = be(b + 8, 2);
        if (nc - 1u >= 16384u) throw Unreadable("invalid number of components in ihdr");
        j.ihdr_h = be(b, 4);
        j.ihdr_w = be(b + 4, 4);
        ihdr = true;
      }
    } else if (type == 0x636f6c72) {  // colr
      if (bn < 3) throw Unreadable("bad COLR header box (bad size)");
      if (!colr) {
        const int meth = b[0];
        if (meth == 1) {
          if (bn < 7) throw Unreadable("bad COLR header box (bad size)");
          const uint32_t e = be(b + 3, 4);
          j.cs = e == 16 ? CS_SRGB : e == 17 ? CS_GRAY : e == 18 ? CS_SYCC : e == 24 ? CS_EYCC
                 : e == 12 ? CS_CMYK : CS_UNKNOWN;
          colr = true;
        } else if (meth == 2) {
          j.cs = CS_UNKNOWN;
          colr = true;
        }
      }
    } else if (type == 0x70636c72) {  // pclr
      if (j.has_pclr) throw Unreadable("a second pclr box");
      if (bn < 3) throw Unreadable("bad pclr box");
      j.nr_entries = int(be(b, 2));
      if (j.nr_entries == 0 || j.nr_entries > 1024) throw Unreadable("invalid PCLR box entries");
      j.nr_channels = b[2];
      if (j.nr_channels == 0) throw Unreadable("invalid PCLR box: 0 palette columns");
      if (bn < 3 + j.nr_channels) throw Unreadable("bad pclr box");
      for (int i = 0; i < j.nr_channels; i++) {
        j.ch_size.push_back((b[3 + i] & 0x7f) + 1);
        j.ch_sign.push_back(b[3 + i] >> 7);
      }
      int64_t q = 3 + j.nr_channels;
      j.entries.resize(size_t(j.nr_entries) * size_t(j.nr_channels));
      for (int e = 0; e < j.nr_entries; e++)
        for (int i = 0; i < j.nr_channels; i++) {
          const int k = (j.ch_size[size_t(i)] + 7) >> 3;
          if (bn < q + k) throw Unreadable("pclr box too short");
          uint32_t v = 0;
          for (int t = 0; t < k && t < 4; t++) v = v << 8 | b[q + t];
          j.entries[size_t(e) * size_t(j.nr_channels) + size_t(i)] = int32_t(v);
          q += k;
        }
      j.has_pclr = true;
    } else if (type == 0x636d6170) {  // cmap
      if (!j.has_pclr) throw Unreadable("need to read a PCLR box before the CMAP box");
      if (j.has_cmap) throw Unreadable("only one CMAP box is allowed");
      if (bn < 4 * j.nr_channels) throw Unreadable("insufficient data for CMAP box");
      for (int i = 0; i < j.nr_channels; i++)
        j.cmap.push_back(Jp2::CmapEntry{int(be(b + 4 * i, 2)), b[4 * i + 2], b[4 * i + 3]});
      j.has_cmap = true;
    } else if (type == 0x63646566) {  // cdef
      if (j.has_cdef) throw Unreadable("a second cdef box");
      if (bn < 2) throw Unreadable("insufficient data for CDEF box");
      const int k = int(be(b, 2));
      if (k == 0) throw Unreadable("no channel description in the CDEF box");
      if (bn < 2 + 6 * k) throw Unreadable("insufficient data for CDEF box");
      for (int i = 0; i < k; i++)
        j.cdef.push_back(Jp2::CdefEntry{int(be(b + 2 + 6 * i, 2)), int(be(b + 4 + 6 * i, 2)),
                                        int(be(b + 6 + 6 * i, 2))});
      j.has_cdef = true;
    }
    at += len;
  }
  if (!ihdr) throw Unreadable("no ihdr box in the jp2h box");
}

// the boxes through jp2c, as OpenJPEG's opj_jp2_read_header_procedure
void read_boxes(Jp2& j, const uint8_t* d, int64_t n) {
  int64_t at = 0;
  bool sig = false, ftyp = false, jp2h = false;
  for (;;) {
    if (n - at < 8) break;
    int64_t len = be(d + at, 4);
    const uint32_t type = be(d + at + 4, 4);
    int64_t hdr = 8;
    if (len == 1) {
      if (n - at < 16) break;
      if (be(d + at + 8, 4) != 0) throw Unreadable("cannot handle box sizes higher than 2^32");
      len = be(d + at + 12, 4);
      hdr = 16;
    } else if (len == 0) {
      len = n - at;
    }
    if (type == 0x6a703263) {  // jp2c
      if (!jp2h) throw Unreadable("bad placed jpeg codestream");
      j.cs_at = at + hdr;
      return;
    }
    if (len < hdr) throw Unreadable("invalid box size");
    const int64_t bn = len - hdr;
    const uint8_t* b = d + at + hdr;
    const bool known = type == 0x6a502020 || type == 0x66747970 || type == 0x6a703268;
    const bool img = type == 0x69686472 || type == 0x636f6c72 || type == 0x62706363 ||
                     type == 0x70636c72 || type == 0x636d6170 || type == 0x63646566;
    if (known || img) {
      if (!known && !jp2h) {  // a misplaced jp2h sub-box before jp2h is skipped
        if (bn > n - at - hdr) throw Unreadable("problem with skipping a JPEG 2000 box");
        at += len;
        continue;
      }
      if (bn > n - at - hdr) throw Unreadable("invalid box size");
      if (type == 0x6a502020) {
        if (sig || ftyp || jp2h) throw Unreadable("the signature box must be the first box");
        if (bn != 4 || be(b, 4) != 0x0d0a870a) throw Unreadable("bad JPEG 2000 signature box");
        sig = true;
      } else if (type == 0x66747970) {
        if (!sig || ftyp || jp2h) throw Unreadable("the ftyp box must be the second box");
        if (bn < 8 || (bn - 8) % 4) throw Unreadable("error with the ftyp box's size");
        ftyp = true;
      } else if (type == 0x6a703268) {
        if (!ftyp) throw Unreadable("the jp2h box comes before the ftyp box");
        read_jp2h(j, b, bn);
        jp2h = true;
      } else {  // a misplaced sub-box after jp2h: read as if inside it
        std::vector<uint8_t> box(d + at, d + at + len);
        read_jp2h(j, box.data(), int64_t(box.size()));
      }
    } else {
      if (!sig) throw Unreadable("the first box must be the JPEG 2000 signature box");
      if (!ftyp) throw Unreadable("the second box must be the file type box");
      if (bn > n - at - hdr) throw Unreadable("problem with skipping a JPEG 2000 box");
    }
    at += len;
  }
  throw Unreadable("no codestream box");
}

// ------------------------------------------------------------------ OpenCV

struct Job {
  Jp2 j;
  Decoder dec;
  int width = 0, height = 0, max_prec = 0, ncomps = 0;
};

void header(Job& job, const uint8_t* d, int64_t n) {
  static const uint8_t kSig[12] = {0, 0, 0, 12, 'j', 'P', ' ', ' ', 13, 10, 0x87, 10};
  const uint8_t* cs = d;
  int64_t cn = n;
  if (n >= 12 && std::memcmp(d, kSig, 12) == 0) {
    job.j.jp2 = true;
    read_boxes(job.j, d, n);
    cs = d + job.j.cs_at;
    cn = n - job.j.cs_at;
    job.dec.im.ihdr_w = job.j.ihdr_w;
    job.dec.im.ihdr_h = job.j.ihdr_h;
  }
  job.dec.header(cs, cn);
  const Image& im = job.dec.im;
  job.width = int(im.x1 - im.x0);
  job.height = int(im.y1 - im.y0);
  job.ncomps = int(im.comps.size());
  if (job.ncomps > 4) throw Unreadable("unsupported number of components");
  for (const Comp& c : im.comps) {
    if (c.sgnd) throw Unreadable("signed JPEG 2000 component");
    job.max_prec = std::max(job.max_prec, c.prec);
  }
  if (job.max_prec < 8) throw Unreadable("JPEG 2000 precision under 8 is not supported");
}

void check_size(const Job& job) {
  if (job.width <= 0 || job.height <= 0 || job.width > kMaxSide || job.height > kMaxSide ||
      int64_t(job.width) * job.height > kMaxPixels)
    throw std::runtime_error("JPEG 2000 image larger than OpenCV's limits");
}

// cvtColor(BGR2GRAY) of 8-bit samples (15-bit fixed point)
inline uint8_t grey(int b, int g, int r) { return uint8_t((b * 3735 + g * 19235 + r * 9798 + 16384) >> 15); }

// cvtColor(YUV2BGR) of 8-bit samples
inline uint8_t sat(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }
void yuv_to_bgr(int y, int u, int v, uint8_t* out) {
  const int shift = 14, half = 1 << (shift - 1);
  const int cb = u - 128, cr = v - 128;
  out[0] = sat(y + ((cb * 33292 + half) >> shift));
  out[1] = sat(y + ((cb * -6472 + cr * -9519 + half) >> shift));
  out[2] = sat(y + ((cr * 18678 + half) >> shift));
}

void decode(Job& job, bool gray, uint8_t* out) {
  Decoded dd = job.dec.decode();
  Jp2& j = job.j;
  struct OutComp {
    std::vector<int32_t>* data;
    int64_t w, h;
    int prec, sgnd, dx, dy, alpha;
  };
  std::vector<OutComp> comps;
  const Image& im = job.dec.im;
  for (size_t c = 0; c < im.comps.size(); c++)
    comps.push_back(OutComp{&dd.comps[c], dd.cw[c], dd.ch[c], im.comps[c].prec, im.comps[c].sgnd,
                            im.comps[c].dx, im.comps[c].dy, 0});
  std::vector<std::vector<int32_t>> palette_data;
  if (j.jp2) {  // opj_jp2_check_color, then the palette and the channel definitions
    if (j.has_cdef) {
      int nr = int(comps.size());
      if (j.has_pclr && j.has_cmap) nr = j.nr_channels;
      for (const auto& e : j.cdef) {
        if (e.cn >= nr) throw Unreadable("invalid component index in cdef");
        if (e.asoc == 65535) continue;
        if (e.asoc > 0 && e.asoc - 1 >= nr) throw Unreadable("invalid component index in cdef");
      }
      for (int k = nr; k > 0; k--) {
        bool found = false;
        for (const auto& e : j.cdef) found |= e.cn == k - 1;
        if (!found) throw Unreadable("incomplete channel definitions");
      }
    }
    if (j.has_pclr && j.has_cmap) {
      const int nr = j.nr_channels;
      bool sane = true;
      for (const auto& e : j.cmap)
        if (e.cmp >= int(comps.size())) sane = false;
      std::vector<char> used(size_t(nr), 0);
      for (int i = 0; i < nr; i++) {
        const auto& e = j.cmap[size_t(i)];
        if (e.mtyp != 0 && e.mtyp != 1) sane = false;
        else if (e.pcol >= nr) sane = false;
        else if (used[size_t(e.pcol)] && e.mtyp == 1) sane = false;
        else if (e.mtyp == 0 && e.pcol != 0) sane = false;
        else if (e.mtyp == 1 && e.pcol != i) sane = false;
        else used[size_t(e.pcol)] = 1;
      }
      for (int i = 0; i < nr; i++)
        if (!used[size_t(i)] && j.cmap[size_t(i)].mtyp != 0) sane = false;
      if (sane && comps.size() == 1) {
        bool ok = true;
        for (int i = 0; i < nr; i++) ok &= used[size_t(i)] != 0;
        if (!ok)
          for (int i = 0; i < nr; i++) j.cmap[size_t(i)] = Jp2::CmapEntry{j.cmap[size_t(i)].cmp, 1, i};
      }
      if (!sane) throw Unreadable("invalid component mapping in cmap");
      // opj_jp2_apply_pclr
      std::vector<OutComp> nc;
      palette_data.resize(size_t(nr));
      const int top = j.nr_entries - 1;
      for (int i = 0; i < nr; i++) {
        const auto& e = j.cmap[size_t(i)];
        OutComp o = comps[size_t(e.cmp)];
        o.prec = j.ch_size[size_t(i)];
        o.sgnd = j.ch_sign[size_t(i)];
        const std::vector<int32_t>& src = *comps[size_t(e.cmp)].data;
        std::vector<int32_t>& dst = palette_data[size_t(i)];
        dst.resize(src.size());
        for (size_t k = 0; k < src.size(); k++) {
          if (e.mtyp == 0) {
            dst[k] = src[k];
          } else {
            int32_t idx = src[k];
            idx = idx < 0 ? 0 : idx > top ? top : idx;
            dst[k] = j.entries[size_t(idx) * size_t(nr) + size_t(e.pcol)];
          }
        }
        o.data = &dst;
        nc.push_back(o);
      }
      comps = nc;
    }
    if (j.has_cdef) {  // opj_jp2_apply_cdef
      auto info = j.cdef;
      for (size_t i = 0; i < info.size(); i++) {
        const int cn = info[i].cn, asoc = info[i].asoc;
        if (cn >= int(comps.size())) continue;
        if (asoc == 0 || asoc == 65535) {
          comps[size_t(cn)].alpha = info[i].typ;
          continue;
        }
        const int acn = asoc - 1;
        if (acn >= int(comps.size())) continue;
        if (cn != acn && info[i].typ == 0) {
          std::swap(comps[size_t(cn)], comps[size_t(acn)]);
          for (size_t k = i + 1; k < info.size(); k++) {
            if (info[k].cn == cn) info[k].cn = acn;
            else if (info[k].cn == acn) info[k].cn = cn;
          }
        }
        comps[size_t(cn)].alpha = info[i].typ;
      }
    }
  }
  // OpenCV's readData
  const int out_ch = gray ? 1 : 3;
  const int shift = job.max_prec > 8 ? job.max_prec - 8 : 0;
  const ColorSpace cs = j.cs;
  if (cs == CS_EYCC || cs == CS_CMYK) throw Unreadable("unsupported colour space conversion");
  for (const OutComp& c : comps) {
    if (c.dx != 1 || c.dy != 1 || c.w != job.width || c.h != job.height)
      throw Unreadable("OpenJPEG2000: tiles are not supported (sub-sampled component)");
    if (im.x0 != 0 || im.y0 != 0) throw Unreadable("OpenJPEG2000: tiles are not supported (offset)");
  }
  const size_t npix = size_t(job.width) * size_t(job.height);
  const int inch = int(comps.size());
  auto px = [&](int c, size_t i) { return int(uint8_t((*comps[size_t(c)].data)[i] >> shift)); };
  if (cs == CS_GRAY) {
    for (size_t i = 0; i < npix; i++) {
      const uint8_t v = uint8_t(px(0, i));
      for (int k = 0; k < out_ch; k++) out[i * size_t(out_ch) + size_t(k)] = v;
    }
    return;
  }
  if (cs == CS_SYCC) {
    if (gray) {
      for (size_t i = 0; i < npix; i++) out[i] = uint8_t(px(0, i));
      return;
    }
    if (inch < 3) throw Unreadable("unsupported conversion for sYCC");
    for (size_t i = 0; i < npix; i++) yuv_to_bgr(px(0, i), px(1, i), px(2, i), out + 3 * i);
    return;
  }
  // sRGB, unknown or unspecified
  if (gray) {
    if (inch <= 2) {
      for (size_t i = 0; i < npix; i++) out[i] = uint8_t(px(0, i));
    } else {
      for (size_t i = 0; i < npix; i++) out[i] = grey(px(2, i), px(1, i), px(0, i));
    }
    return;
  }
  if (inch < 3) throw Unreadable("unsupported conversion from 1 or 2 components to BGR");
  for (size_t i = 0; i < npix; i++) {
    out[3 * i] = uint8_t(px(2, i));
    out[3 * i + 1] = uint8_t(px(1, i));
    out[3 * i + 2] = uint8_t(px(0, i));
  }
}

int fail(char* err, int errlen, const std::exception& e, int code) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", e.what());
  return code;
}

template <typename F>
int guarded(char* err, int errlen, F&& f) {
  try {
    f();
    return 0;
  } catch (const Unreadable& e) {
    return fail(err, errlen, e, 1);
  } catch (const std::exception& e) {
    return fail(err, errlen, e, -1);
  }
}

}  // namespace

extern "C" {

// info: height, width
int fots_jp2_header(const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    Job job;
    header(job, data, n);
    check_size(job);
    info[0] = job.height;
    info[1] = job.width;
  });
}

// out: height * width * 3 bytes (BGR) or height * width (gray)
int fots_jp2_decode(const uint8_t* data, int64_t n, int gray, uint8_t* out, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    Job job;
    header(job, data, n);
    check_size(job);
    decode(job, gray != 0, out);
  });
}

}  // extern "C"
