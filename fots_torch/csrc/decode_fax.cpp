// Host decoding of the CCITT codings of TIFF strips and tiles (ITU-T T.4 and
// T.6) as libtiff 4.7's tif_fax3.c decodes them under cv2.imread's
// TIFFReadRGBAStrip / Tile: the caller (fots_torch/imageio.py) reads the
// directory and turns the 1-bit rows into pixels.
//   - Modified Huffman RLE (compression 2): 1-D rows without EOLs, each row
//     starting on a byte boundary; RLE-word (32771): rows on 16-bit
//     boundaries of the data's address (where the strip lies in the file);
//   - Group 3 (3): each row found by its EOL (fill bits before it skipped),
//     1-D rows, or with T4Options bit 0 a tag bit after each EOL choosing a
//     1-D or a 2-D row;
//   - Group 4 (4): 2-D rows against the row above (all white before the
//     first), decoding ending at an EOL (EOFB) with the row where it stood;
//   - libtiff's tables (mkg3states.c): a 7-bit mode table (V0, VR1-3,
//     VL1-3, pass, horizontal, the 7-zero start of an EOL, the 0000001
//     extension), 12-bit white and 13-bit black run tables whose 11 zero
//     bits are an EOL, every other pattern "unexpected";
//   - a row is a list of runs, white then black, filled into the row's bits
//     (1 black) as _TIFFFax3fillruns fills them: each run cut to what is left
//     of the row, so what comes out of damaged data is what libtiff writes.
//     A row whose runs do not add up to the width is repaired as
//     CLEANUP_RUNS repairs it (trailing runs dropped while the sum is past
//     the width, then the rest of the row white);
//   - a bad code ends the row (the rest white; 1-D and Group 3 go on at the
//     next EOL, Group 4 and RLE with the bits that follow), data that ends
//     inside a row ends the strip with that row filled; a row past the room
//     of libtiff's run arrays ends the strip unfilled.  Rows never reached
//     stay as the caller zeroed them.
// Bits are read as libtiff reads them: a byte at a time into a 32-bit
// accumulator, least significant bit first through a bit reversal (fill
// order 1; the caller reverses fill order 2 first), padded with zero bits
// where the data ends while bits are still held.
//
// Built with g++ by fots_torch/kernels/build.py into build/fots_torch/ at
// first use and loaded with ctypes.

#include <cstdint>
#include <cstring>
#include <utility>

namespace {

enum State { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW,
             S_MakeUpB, S_MakeUp, S_EOL };

struct TabEnt {
  uint8_t state = S_Null, width = 0;
  int32_t param = 0;
};

struct Code {
  const char* bits;  // as T.4 writes it, first bit first
  int32_t param;
};

const Code kWhiteTerm[] = {
    {"00110101", 0},  {"000111", 1},    {"0111", 2},      {"1000", 3},      {"1011", 4},
    {"1100", 5},      {"1110", 6},      {"1111", 7},      {"10011", 8},     {"10100", 9},
    {"00111", 10},    {"01000", 11},    {"001000", 12},   {"000011", 13},   {"110100", 14},
    {"110101", 15},   {"101010", 16},   {"101011", 17},   {"0100111", 18},  {"0001100", 19},
    {"0001000", 20},  {"0010111", 21},  {"0000011", 22},  {"0000100", 23},  {"0101000", 24},
    {"0101011", 25},  {"0010011", 26},  {"0100100", 27},  {"0011000", 28},  {"00000010", 29},
    {"00000011", 30}, {"00011010", 31}, {"00011011", 32}, {"00010010", 33}, {"00010011", 34},
    {"00010100", 35}, {"00010101", 36}, {"00010110", 37}, {"00010111", 38}, {"00101000", 39},
    {"00101001", 40}, {"00101010", 41}, {"00101011", 42}, {"00101100", 43}, {"00101101", 44},
    {"00000100", 45}, {"00000101", 46}, {"00001010", 47}, {"00001011", 48}, {"01010010", 49},
    {"01010011", 50}, {"01010100", 51}, {"01010101", 52}, {"00100100", 53}, {"00100101", 54},
    {"01011000", 55}, {"01011001", 56}, {"01011010", 57}, {"01011011", 58}, {"01001010", 59},
    {"01001011", 60}, {"00110010", 61}, {"00110011", 62}, {"00110100", 63}};
const Code kWhiteMakeUp[] = {
    {"11011", 64},       {"10010", 128},      {"010111", 192},     {"0110111", 256},
    {"00110110", 320},   {"00110111", 384},   {"01100100", 448},   {"01100101", 512},
    {"01101000", 576},   {"01100111", 640},   {"011001100", 704},  {"011001101", 768},
    {"011010010", 832},  {"011010011", 896},  {"011010100", 960},  {"011010101", 1024},
    {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280},
    {"011011010", 1344}, {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536},
    {"010011010", 1600}, {"011000", 1664},    {"010011011", 1728}};
const Code kBlackTerm[] = {
    {"0000110111", 0},   {"010", 1},          {"11", 2},           {"10", 3},
    {"011", 4},          {"0011", 5},         {"0010", 6},         {"00011", 7},
    {"000101", 8},       {"000100", 9},       {"0000100", 10},     {"0000101", 11},
    {"0000111", 12},     {"00000100", 13},    {"00000111", 14},    {"000011000", 15},
    {"0000010111", 16},  {"0000011000", 17},  {"0000001000", 18},  {"00001100111", 19},
    {"00001101000", 20}, {"00001101100", 21}, {"00000110111", 22}, {"00000101000", 23},
    {"00000010111", 24}, {"00000011000", 25}, {"000011001010", 26}, {"000011001011", 27},
    {"000011001100", 28}, {"000011001101", 29}, {"000001101000", 30}, {"000001101001", 31},
    {"000001101010", 32}, {"000001101011", 33}, {"000011010010", 34}, {"000011010011", 35},
    {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38}, {"000011010111", 39},
    {"000001101100", 40}, {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43},
    {"000001010100", 44}, {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47},
    {"000001100100", 48}, {"000001100101", 49}, {"000001010010", 50}, {"000001010011", 51},
    {"000000100100", 52}, {"000000110111", 53}, {"000000111000", 54}, {"000000100111", 55},
    {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58}, {"000000101011", 59},
    {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62}, {"000001100111", 63}};
const Code kBlackMakeUp[] = {
    {"0000001111", 64},     {"000011001000", 128},  {"000011001001", 192},
    {"000001011011", 256},  {"000000110011", 320},  {"000000110100", 384},
    {"000000110101", 448},  {"0000001101100", 512}, {"0000001101101", 576},
    {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768},
    {"0000001001101", 832}, {"0000001110010", 896}, {"0000001110011", 960},
    {"0000001110100", 1024}, {"0000001110101", 1088}, {"0000001110110", 1152},
    {"0000001110111", 1216}, {"0000001010010", 1280}, {"0000001010011", 1344},
    {"0000001010100", 1408}, {"0000001010101", 1472}, {"0000001011010", 1536},
    {"0000001011011", 1600}, {"0000001100100", 1664}, {"0000001100101", 1728}};
const Code kMakeUp[] = {  // both colours
    {"00000001000", 1792},  {"00000001100", 1856},  {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};
const Code kModes[] = {  // the 2-D mode codes: state in the param's place
    {"0001", S_Pass}, {"001", S_Horiz}, {"1", S_V0},       {"011", S_VR},   {"000011", S_VR},
    {"0000011", S_VR}, {"010", S_VL},   {"000010", S_VL},  {"0000010", S_VL}, {"0000001", S_Ext},
    {"0000000", S_EOL}};

struct Tables {
  TabEnt main[128], white[4096], black[8192];
  uint8_t rev[256];

  // mkg3states.c:FillTable: every index whose low bits are the code,
  // first bit lowest
  static void fill(TabEnt* t, int size, const char* bits, int state, int32_t param) {
    const int width = int(std::strlen(bits));
    int code = 0;
    for (int i = 0; i < width; i++) code |= (bits[i] - '0') << i;
    for (int i = code; i < (1 << size); i += 1 << width) t[i] = TabEnt{uint8_t(state), uint8_t(width), param};
  }

  Tables() {
    for (int i = 0; i < 256; i++) {
      int r = 0;
      for (int b = 0; b < 8; b++) r |= ((i >> b) & 1) << (7 - b);
      rev[i] = uint8_t(r);
    }
    int vr = 0, vl = 0;
    for (const Code& c : kModes) {
      const int param = c.param == S_VR ? ++vr : c.param == S_VL ? ++vl : 0;
      fill(main, 7, c.bits, c.param, param);
    }
    for (const Code& c : kWhiteMakeUp) fill(white, 12, c.bits, S_MakeUpW, c.param);
    for (const Code& c : kMakeUp) fill(white, 12, c.bits, S_MakeUp, c.param);
    for (const Code& c : kWhiteTerm) fill(white, 12, c.bits, S_TermW, c.param);
    fill(white, 12, "00000000000", S_EOL, 0);
    for (const Code& c : kBlackMakeUp) fill(black, 13, c.bits, S_MakeUpB, c.param);
    for (const Code& c : kMakeUp) fill(black, 13, c.bits, S_MakeUp, c.param);
    for (const Code& c : kBlackTerm) fill(black, 13, c.bits, S_TermB, c.param);
    fill(black, 13, "00000000000", S_EOL, 0);
  }
};
const Tables kTab;

enum Mode { kRLE = 2, kG3 = 3, kG4 = 4, kRLEW = 32771 };

// _TIFFFax3fillruns: runs[0, n) alternately white and black, each cut to
// what is left of the row (in place: a 2-D row's runs are the next row's
// reference), into the row's bits
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int colour = 0; colour < 2; colour++) {
      uint32_t run = runs[colour];
      if (x + run > lastx || run > lastx) run = runs[colour] = lastx - x;
      for (uint32_t k = 0; k < run; k++, x++) {
        if (colour) buf[x >> 3] |= uint8_t(0x80 >> (x & 7));
        else buf[x >> 3] &= uint8_t(~(0x80 >> (x & 7)));
      }
    }
  }
}

// One strip or tile: `rows` rows of `rowbytes` into `buf` (zeroed by the
// caller).  Returns 1 where libtiff's decoder succeeds, 0 where it fails.
// `odd_address`: the data starts at an odd address (RLE-word's alignment).
// `runs`: libtiff's run arrays (2 * nruns + 1 entries, nruns the width + 1
// rounded up to 32), zeroed once for a file and kept from strip to strip as
// libtiff keeps them: a pass code past the reference row's last change reads
// what an earlier row left there.
int fax_decode(const uint8_t* data, int64_t n, int mode, bool two_d, int lastx_, int64_t rowbytes,
               int64_t rows, bool odd_address, int* noeol, uint32_t* runs, uint8_t* buf) {
  const uint8_t* cp = data;
  const uint8_t* const ep = data + n;
  uint32_t BitAcc = 0;
  int BitsAvail = 0;
  const int lastx = lastx_;
  const bool refline = mode == kG4 || (mode == kG3 && two_d);
  const int64_t nruns = ((int64_t(lastx) + 1 + 31) / 32) * 32;
  uint32_t* curruns = runs;
  uint32_t* refruns = refline ? runs + nruns : nullptr;
  if (refruns) {
    refruns[0] = uint32_t(lastx);
    refruns[1] = 0;
  }
  int EOLcnt = 0;
  int64_t occ = rows * rowbytes;
  uint32_t *pa, *thisrun, *pb;
  int a0, RunLength, b1;
  const TabEnt* TabEnt_;

  // tif_fax3.h's macros, as lambdas that report the end of the data
  auto need8 = [&](int k) -> bool {
    if (BitsAvail < k) {
      if (cp >= ep) {
        if (BitsAvail == 0) return false;
        BitsAvail = k;
      } else {
        BitAcc |= uint32_t(kTab.rev[*cp++]) << BitsAvail;
        BitsAvail += 8;
      }
    }
    return true;
  };
  auto need16 = [&](int k) -> bool {
    if (BitsAvail < k) {
      if (cp >= ep) {
        if (BitsAvail == 0) return false;
        BitsAvail = k;
      } else {
        BitAcc |= uint32_t(kTab.rev[*cp++]) << BitsAvail;
        if ((BitsAvail += 8) < k) {
          if (cp >= ep) {
            BitsAvail = k;
          } else {
            BitAcc |= uint32_t(kTab.rev[*cp++]) << BitsAvail;
            BitsAvail += 8;
          }
        }
      }
    }
    return true;
  };
  auto get = [&](int k) { return BitAcc & ((1u << k) - 1); };
  auto clr = [&](int k) {
    BitsAvail -= k;
    BitAcc >>= k;
  };
  // SETVALUE: false where the runs overflow (the decoder returns -1)
  auto setvalue = [&](int x) -> bool {
    if (pa >= thisrun + nruns) return false;
    *pa++ = uint32_t(RunLength + x);
    a0 += x;
    RunLength = 0;
    return true;
  };
  auto cleanup = [&]() -> bool {  // CLEANUP_RUNS
    if (RunLength && !setvalue(0)) return false;
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 -= int(*--pa);
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if (((pa - thisrun) & 1) && !setvalue(0)) return false;
        if (!setvalue(lastx - a0)) return false;
      } else if (a0 > lastx) {
        if (!setvalue(lastx) || !setvalue(0)) return false;
      }
    }
    return true;
  };
  // results of the row expanders
  enum Row { kDone, kEof, kFail };
  // EXPAND1D: kEof after CLEANUP_RUNS where the data ends
  auto expand1d = [&]() -> Row {
    for (;;) {
      for (;;) {  // white
        if (!need16(12)) goto eof1d;
        TabEnt_ = &kTab.white[get(12)];
        clr(TabEnt_->width);
        switch (TabEnt_->state) {
          case S_EOL: EOLcnt = 1; goto done1d;
          case S_TermW: if (!setvalue(TabEnt_->param)) return kFail; goto doneWhite1d;
          case S_MakeUpW:
          case S_MakeUp: a0 += TabEnt_->param; RunLength += TabEnt_->param; break;
          default: goto done1d;  // unexpected
        }
      }
    doneWhite1d:
      if (a0 >= lastx) goto done1d;
      for (;;) {  // black
        if (!need16(13)) goto eof1d;
        TabEnt_ = &kTab.black[get(13)];
        clr(TabEnt_->width);
        switch (TabEnt_->state) {
          case S_EOL: EOLcnt = 1; goto done1d;
          case S_TermB: if (!setvalue(TabEnt_->param)) return kFail; goto doneBlack1d;
          case S_MakeUpB:
          case S_MakeUp: a0 += TabEnt_->param; RunLength += TabEnt_->param; break;
          default: goto done1d;  // unexpected
        }
      }
    doneBlack1d:
      if (a0 >= lastx) goto done1d;
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
    }
  eof1d:
    return cleanup() ? kEof : kFail;
  done1d:
    return cleanup() ? kDone : kFail;
  };
  auto check_b1 = [&]() -> bool {
    if (pa != thisrun)
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= refruns + nruns) return false;
        b1 += int(pb[0] + pb[1]);
        pb += 2;
      }
    return true;
  };
  // EXPAND2D
  auto expand2d = [&]() -> Row {
    while (a0 < lastx) {
      if (pa >= thisrun + nruns) return kFail;
      if (!need8(7)) goto eof2d;
      TabEnt_ = &kTab.main[get(7)];
      clr(TabEnt_->width);
      switch (TabEnt_->state) {
        case S_Pass:
          if (!check_b1() || pb >= refruns + nruns) return kFail;
          b1 += int(*pb++);
          RunLength += b1 - a0;
          a0 = b1;
          if (pb >= refruns + nruns) return kFail;
          b1 += int(*pb++);
          break;
        case S_Horiz:
          if ((pa - thisrun) & 1) {
            for (;;) {  // black first
              if (!need16(13)) goto eof2d;
              TabEnt_ = &kTab.black[get(13)];
              clr(TabEnt_->width);
              if (TabEnt_->state == S_TermB) {
                if (!setvalue(TabEnt_->param)) return kFail;
                break;
              }
              if (TabEnt_->state != S_MakeUpB && TabEnt_->state != S_MakeUp) goto eol2d;
              a0 += TabEnt_->param;
              RunLength += TabEnt_->param;
            }
            for (;;) {  // then white
              if (!need16(12)) goto eof2d;
              TabEnt_ = &kTab.white[get(12)];
              clr(TabEnt_->width);
              if (TabEnt_->state == S_TermW) {
                if (!setvalue(TabEnt_->param)) return kFail;
                break;
              }
              if (TabEnt_->state != S_MakeUpW && TabEnt_->state != S_MakeUp) goto eol2d;
              a0 += TabEnt_->param;
              RunLength += TabEnt_->param;
            }
          } else {
            for (;;) {  // white first
              if (!need16(12)) goto eof2d;
              TabEnt_ = &kTab.white[get(12)];
              clr(TabEnt_->width);
              if (TabEnt_->state == S_TermW) {
                if (!setvalue(TabEnt_->param)) return kFail;
                break;
              }
              if (TabEnt_->state != S_MakeUpW && TabEnt_->state != S_MakeUp) goto eol2d;
              a0 += TabEnt_->param;
              RunLength += TabEnt_->param;
            }
            for (;;) {  // then black
              if (!need16(13)) goto eof2d;
              TabEnt_ = &kTab.black[get(13)];
              clr(TabEnt_->width);
              if (TabEnt_->state == S_TermB) {
                if (!setvalue(TabEnt_->param)) return kFail;
                break;
              }
              if (TabEnt_->state != S_MakeUpB && TabEnt_->state != S_MakeUp) goto eol2d;
              a0 += TabEnt_->param;
              RunLength += TabEnt_->param;
            }
          }
          if (!check_b1()) return kFail;
          break;
        case S_V0:
          if (!check_b1() || !setvalue(b1 - a0) || pb >= refruns + nruns) return kFail;
          b1 += int(*pb++);
          break;
        case S_VR:
          if (!check_b1() || !setvalue(b1 - a0 + TabEnt_->param) || pb >= refruns + nruns)
            return kFail;
          b1 += int(*pb++);
          break;
        case S_VL:
          if (!check_b1()) return kFail;
          if (b1 < a0 + TabEnt_->param) goto eol2d;  // unexpected
          if (!setvalue(b1 - a0 - TabEnt_->param)) return kFail;
          b1 -= int(*--pb);
          break;
        case S_Ext:
          *pa++ = uint32_t(lastx - a0);
          goto eol2d;
        case S_EOL:
          *pa++ = uint32_t(lastx - a0);
          if (!need8(4)) goto eof2d;
          clr(4);
          EOLcnt = 1;
          goto eol2d;
        default:
          goto eol2d;
      }
    }
    if (RunLength) {
      if (RunLength + a0 < lastx) {  // expect a final V0
        if (!need8(1)) goto eof2d;
        if (!get(1)) goto eol2d;
        clr(1);
      }
      if (!setvalue(0)) return kFail;
    }
  eol2d:
    return cleanup() ? kDone : kFail;
  eof2d:
    return cleanup() ? kEof : kFail;
  };
  // SYNC_EOL: kEol past the EOL (or nothing to do without EOLs), kEnd where
  // the data ends before 11 zero bits, kNoEol where it ends after them
  // before the EOL's 1 bit: libtiff then decodes the strip again from its
  // start as rows without EOLs (FAXMODE_NOEOL, kept for later strips),
  // writing on from the row it stood at
  enum Sync { kEol, kEnd, kNoEol };
  auto sync_eol = [&]() -> Sync {
    if (*noeol) return kEol;
    if (EOLcnt == 0) {
      for (;;) {
        if (!need16(11)) return kEnd;
        if (get(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      if (!need8(8)) {
        *noeol = 1;
        cp = data;
        BitAcc = 0;
        BitsAvail = 0;
        EOLcnt = 0;
        return kNoEol;
      }
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    EOLcnt = 0;
    return kEol;
  };

  if (mode == kRLE || mode == kRLEW) {  // Fax3DecodeRLE
    thisrun = curruns;
    while (occ > 0) {
      a0 = 0;
      RunLength = 0;
      pa = thisrun;
      const Row r = expand1d();
      if (r == kFail) return 0;
      fill_runs(buf, thisrun, pa, uint32_t(lastx));
      if (r == kEof) return 0;
      if (mode == kRLE) {
        clr(BitsAvail - (BitsAvail & ~7));
      } else {
        clr(BitsAvail - (BitsAvail & ~15));
        if (BitsAvail == 0 && ((cp - data) & 1) != (odd_address ? 1 : 0)) cp++;
      }
      buf += rowbytes;
      occ -= rowbytes;
    }
    return 1;
  }
  if (mode == kG3 && !two_d) {  // Fax3Decode1D
    thisrun = curruns;
    while (occ > 0) {
      a0 = 0;
      RunLength = 0;
      pa = thisrun;
      const Sync sy = sync_eol();
      if (sy == kNoEol) continue;
      if (sy == kEnd) {
        if (!cleanup()) return 0;
        fill_runs(buf, thisrun, pa, uint32_t(lastx));
        return 0;
      }
      const Row r = expand1d();
      if (r == kFail) return 0;
      fill_runs(buf, thisrun, pa, uint32_t(lastx));
      if (r == kEof) return 0;
      buf += rowbytes;
      occ -= rowbytes;
    }
    return 1;
  }
  if (mode == kG3) {  // Fax3Decode2D
    while (occ > 0) {
      a0 = 0;
      RunLength = 0;
      pa = thisrun = curruns;
      const Sync sy = sync_eol();
      if (sy == kNoEol) continue;
      if (sy == kEnd || !need8(1)) {
        if (!cleanup()) return 0;
        fill_runs(buf, thisrun, pa, uint32_t(lastx));
        return 0;
      }
      const bool is1d = get(1) != 0;
      clr(1);
      pb = refruns;
      b1 = int(*pb++);
      const Row r = is1d ? expand1d() : expand2d();
      if (r == kFail) return 0;
      fill_runs(buf, thisrun, pa, uint32_t(lastx));
      if (r == kEof) return 0;
      if (pa < thisrun + nruns && !setvalue(0)) return 0;
      std::swap(curruns, refruns);
      buf += rowbytes;
      occ -= rowbytes;
    }
    return 1;
  }
  // Fax4Decode
  int64_t line = 0;
  while (occ > 0) {
    a0 = 0;
    RunLength = 0;
    pa = thisrun = curruns;
    pb = refruns;
    b1 = int(*pb++);
    const Row r = expand2d();
    if (r == kFail) return 0;
    if (r == kEof || EOLcnt) {  // EOFG4: the row where the data or the code ended
      if (need16(13)) clr(13);
      if ((lastx + 7) >> 3 > occ) return 0;
      fill_runs(buf, thisrun, pa, uint32_t(lastx));
      return line > 0 ? 1 : 0;  // "don't error on badly-terminated strips"
    }
    if ((lastx + 7) >> 3 > occ) return 0;
    fill_runs(buf, thisrun, pa, uint32_t(lastx));
    if (!setvalue(0)) return 0;
    std::swap(curruns, refruns);
    buf += rowbytes;
    occ -= rowbytes;
    line++;
  }
  return 1;
}

}  // namespace

extern "C" {

// compression 2, 3, 4 or 32771; two_d: Group 3's T4Options bit 0
// noeol: Group 3's FAXMODE_NOEOL, in and out (it stays set for the later
// strips of a file once a strip sets it); runs: see fax_decode
int fots_tiff_fax(const uint8_t* src, int64_t n, int compression, int two_d, int width,
                  int64_t rowbytes, int64_t rows, int odd_address, int* noeol, uint32_t* runs,
                  uint8_t* out) {
  return fax_decode(src, n, compression, two_d != 0, width, rowbytes, rows, odd_address != 0,
                    noeol, runs, out);
}

}  // extern "C"
