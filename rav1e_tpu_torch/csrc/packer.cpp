// Tile packer: AV1 tile syntax and CDF adaptation on the host, emitting
// the od_ec symbol IR that the card's range coder codes.
//
// A copy of the JAX package's native/packer.cpp with one design change:
// the Encoder keeps no interval state (low, rng) and writes no bytes.
// Each symbol, bool and literal becomes one or more IR rows
// (fl, fh, cu, cv), exactly as entropy/ec_cuda.py's RecordingEncoder
// records them, and entropy/ec_cuda.py::pack_ir (csrc/ec_pack.cu on the
// card, pack_ir_plain + finish on the CPU) turns the rows into the
// tile's bytes. CDF adaptation stays here, in the reference's order.
// Every other line keeps the reference's semantics; the tile equals the
// port's Python TileWriter's, row for row (tests/test_torch_packer.py).
//
// Built with g++ -O2 -shared -fPIC -std=c++17 by entropy/native.py.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int PROB_TOP = 1 << 15;
constexpr int EC_PROB_SHIFT = 6;
constexpr int EC_MIN_PROB = 4;

struct Cdf {
  uint16_t v[17];  // values + terminator 0; counter separate
  uint16_t count;
  uint8_t n;  // number of symbols
};

// The IR recorder: int32 rows (fl, fh, cu, cv), four words a row.
struct Encoder {
  std::vector<int32_t> ir;

  Encoder() { ir.reserve(1 << 16); }

  inline void row(uint32_t fl, uint32_t fh, uint32_t cu, uint32_t cv) {
    ir.push_back((int32_t)fl);
    ir.push_back((int32_t)fh);
    ir.push_back((int32_t)cu);
    ir.push_back((int32_t)cv);
  }

  void symbol_raw(int s, const uint16_t* icdf, int n) {
    int N = n - 1;
    uint32_t fl = (s == 0) ? PROB_TOP : icdf[s - 1];
    uint32_t fh = icdf[s];
    row(fl, fh, fl < PROB_TOP ? EC_MIN_PROB * (N - (s - 1)) : 0,
        EC_MIN_PROB * (N - s));
  }

  void symbol(int s, Cdf& c) {
    symbol_raw(s, c.v, c.n);
    // spec CDF adaptation
    int n = c.n;
    uint16_t count = c.count;
    int rate = 3 + (count > 15) + (count > 31) +
               ((n == 2 || n == 3) ? 1 : 2);
    for (int i = 0; i < n - 1; i++) {
      if (i < s)
        c.v[i] += (PROB_TOP - c.v[i]) >> rate;
      else
        c.v[i] -= c.v[i] >> rate;
    }
    c.count = count + (count < 32);
  }

  void boolean(int val, uint32_t f) {
    if (val)
      row(f, 0, EC_MIN_PROB, 0);
    else
      row(PROB_TOP, f, 0, EC_MIN_PROB);
  }

  void literal(uint32_t value, int n) {
    for (int i = n - 1; i >= 0; i--) boolean((value >> i) & 1, 1 << 14);
  }

  void golomb(uint32_t value) {
    uint32_t x = value + 1;
    int length = 32 - __builtin_clz(x);
    for (int i = 0; i < length - 1; i++) boolean(0, 1 << 14);
    for (int b = length - 1; b >= 0; b--) boolean((x >> b) & 1, 1 << 14);
  }

  long rows() const { return (long)(ir.size() / 4); }

  // Copy the IR into out (cap rows). Returns the row count, or minus it
  // when cap is too small (nothing is written then).
  long take(int32_t* out, long cap) const {
    long n = rows();
    if (n > cap) return -n;
    if (n) memcpy(out, ir.data(), (size_t)n * 4 * sizeof(int32_t));
    return n;
  }
};

// ---- coefficient coding ---------------------------------------------------

constexpr int NUM_BASE_LEVELS = 2;
constexpr int COEFF_BASE_RANGE = 12;

enum TxClass { C2D = 0, CHORIZ = 1, CVERT = 2 };

const int LO_SQ[5][5] = {{0, 1, 6, 6, 21},
                         {1, 6, 6, 21, 21},
                         {6, 6, 21, 21, 21},
                         {6, 21, 21, 21, 21},
                         {21, 21, 21, 21, 21}};
// oracle-verified: 11-offset table for h == 2*w, 16-offset for w == 2*h
const int LO_TALL[5][5] = {{0, 11, 11, 11, 11},
                           {11, 11, 11, 11, 11},
                           {6, 6, 21, 21, 21},
                           {6, 21, 21, 21, 21},
                           {21, 21, 21, 21, 21}};
const int LO_WIDE[5][5] = {{0, 16, 6, 6, 21},
                           {16, 16, 6, 21, 21},
                           {16, 16, 21, 21, 21},
                           {16, 16, 21, 21, 21},
                           {16, 16, 21, 21, 21}};

struct Packer {
  Encoder ec;
  std::vector<std::vector<Cdf>> fams;
  Cdf& fams_at(int fam, int rec) { return fams[fam][rec]; }
  void symbol_fam(int fam, int rec, int sym) {
    ec.symbol(sym, fams[fam][rec]);
  }
};

static inline int imin(int a, int b) { return a < b ? a : b; }
static inline int imax(int a, int b) { return a > b ? a : b; }

void scan_pos(int w, int h, int tclass, std::vector<int>& out) {
  out.clear();
  out.reserve(w * h);
  if (tclass == C2D) {
    // square: zigzag; rect: fixed direction (tall top-down, wide
    // bottom-up), verified against libdav1d/libaom scan tables
    for (int d = 0; d < w + h - 1; d++) {
      int lo = d - w + 1;
      if (lo < 0) lo = 0;
      int hi = imin(d, h - 1);
      bool rev = (w == h && d % 2 == 0) || (w > h);
      if (rev) {
        for (int r = hi; r >= lo; r--) out.push_back(r * w + (d - r));
      } else {
        for (int r = lo; r <= hi; r++) out.push_back(r * w + (d - r));
      }
    }
  } else if (tclass == CVERT) {
    for (int c = 0; c < w; c++)
      for (int r = 0; r < h; r++) out.push_back(r * w + c);
  } else {
    for (int r = 0; r < h; r++)
      for (int c = 0; c < w; c++) out.push_back(r * w + c);
  }
}

int base_ctx(const int32_t* lv, int w, int h, int r, int c, int tclass,
             const int (*off)[5]) {
  int mag = 0;
  auto add = [&](int rr, int cc, int cap) {
    if (rr < h && cc < w) {
      int v = lv[rr * w + cc];
      if (v < 0) v = -v;
      mag += v < cap ? v : cap;
    }
  };
  if (tclass == C2D) {
    if (r == 0 && c == 0) return 0;
    add(r, c + 1, 3);
    add(r + 1, c, 3);
    add(r + 1, c + 1, 3);
    add(r, c + 2, 3);
    add(r + 2, c, 3);
  } else if (tclass == CVERT) {
    add(r, c + 1, 3);
    add(r + 1, c, 3);
    add(r + 2, c, 3);
    add(r + 3, c, 3);
    add(r + 4, c, 3);
  } else {
    add(r, c + 1, 3);
    add(r + 1, c, 3);
    add(r, c + 2, 3);
    add(r, c + 3, 3);
    add(r, c + 4, 3);
  }
  mag = imin((mag + 1) >> 1, 4);
  if (tclass == C2D) return mag + off[imin(r, 4)][imin(c, 4)];
  int pos = (tclass == CVERT) ? r : c;
  int off1d = pos == 0 ? 0 : (pos == 1 ? 7 : 14);
  return mag + off1d;
}

int br_ctx_f(const int32_t* lv, int w, int h, int r, int c, int tclass) {
  int mag = 0;
  auto add = [&](int rr, int cc) {
    if (rr < h && cc < w) {
      int v = lv[rr * w + cc];
      if (v < 0) v = -v;
      mag += v < 15 ? v : 15;
    }
  };
  add(r, c + 1);
  add(r + 1, c);
  if (tclass == C2D)
    add(r + 1, c + 1);
  else if (tclass == CVERT)
    add(r + 2, c);
  else
    add(r, c + 2);
  mag = imin((mag + 1) >> 1, 6);
  if (tclass == C2D) {
    if (r == 0 && c == 0) return mag;
    if (r < 2 && c < 2) return mag + 7;
    return mag + 14;
  }
  int pos = (tclass == CVERT) ? r : c;
  return pos == 0 ? mag : mag + 14;
}

}  // namespace

extern "C" {

void* packer_new() { return new Packer(); }
void packer_free(void* h) { delete (Packer*)h; }

// register a CDF family: data = int32 [n_records][nsym] (values incl
// trailing 0 terminator). Returns family id.
int packer_add_family(void* h, const int32_t* data, int n_records,
                      int nsym) {
  Packer* p = (Packer*)h;
  std::vector<Cdf> recs(n_records);
  for (int i = 0; i < n_records; i++) {
    Cdf& c = recs[i];
    c.n = (uint8_t)nsym;
    c.count = 0;
    for (int k = 0; k < nsym; k++) c.v[k] = (uint16_t)data[i * nsym + k];
  }
  p->fams.push_back(std::move(recs));
  return (int)p->fams.size() - 1;
}

void packer_symbol(void* h, int fam, int rec, int sym) {
  Packer* p = (Packer*)h;
  p->ec.symbol(sym, p->fams_at(fam, rec));
}

void packer_symbol_noadapt_raw(void* h, int sym, const int32_t* icdf,
                               int nsym) {
  Packer* p = (Packer*)h;
  uint16_t v[17];
  for (int i = 0; i < nsym; i++) v[i] = (uint16_t)icdf[i];
  p->ec.symbol_raw(sym, v, nsym);
}

void packer_bool(void* h, int val, int f) {
  ((Packer*)h)->ec.boolean(val, (uint32_t)f);
}

void packer_literal(void* h, int val, int n) {
  ((Packer*)h)->ec.literal((uint32_t)val, n);
}

// Coefficients for one TU. levels: int32 [h][w] row-major (full tx
// dims; only min(32) area is scanned). fam ids must be registered in
// the canonical order (see python side). Returns cul context byte.
static int coeffs_impl(Packer* p, int ptype, int txw, int txh, int tctx,
                       int br_tctx, int tclass, int eob_fam, int eob_rec,
                       int hi_fam, int hi_rec_base, int skip_fam,
                       int skip_rec, int beob_fam, int beob_rec_base,
                       int base_fam, int base_rec_base, int br_fam,
                       int br_rec_base, int dc_fam, int dc_rec,
                       int txtype_fam, int txtype_rec, int txtype_sym,
                       const int32_t* levels) {
  Encoder& ec = p->ec;
  int sw = imin(txw, 32), sh = imin(txh, 32);
  std::vector<int> scan;
  scan_pos(sw, sh, tclass, scan);
  std::vector<int32_t> lv(sw * sh);
  for (int r = 0; r < sh; r++)
    for (int c = 0; c < sw; c++) {
      int32_t v = levels[r * txw + c];
      lv[r * sw + c] = v < 0 ? -v : v;
    }
  int eob = 0;
  for (int ci = sw * sh - 1; ci >= 0; ci--) {
    if (lv[scan[ci]] != 0) {
      eob = ci + 1;
      break;
    }
  }
  p->symbol_fam(skip_fam, skip_rec, eob == 0 ? 1 : 0);
  if (eob == 0) return 0;
  if (txtype_fam >= 0) p->symbol_fam(txtype_fam, txtype_rec, txtype_sym);
  // eob_pt
  int pt;
  if (eob == 1)
    pt = 0;
  else {
    pt = 32 - __builtin_clz((unsigned)(eob - 1));
  }
  p->symbol_fam(eob_fam, eob_rec, pt);
  if (pt >= 2) {
    int start = (1 << (pt - 1)) + 1;
    int ofs = eob - start;
    int nbits2 = pt - 1;
    p->symbol_fam(hi_fam, hi_rec_base + pt, (ofs >> (nbits2 - 1)) & 1);
    for (int b = nbits2 - 2; b >= 0; b--) ec.boolean((ofs >> b) & 1, 1 << 14);
  }
  const int(*off)[5] = LO_SQ;
  if (sh == 2 * sw)
    off = LO_TALL;
  else if (sw == 2 * sh)
    off = LO_WIDE;
  int n_pels = sw * sh;
  for (int ci = eob - 1; ci >= 0; ci--) {
    int pos = scan[ci];
    int r = pos / sw, c = pos % sw;
    int level = lv[pos];
    if (ci == eob - 1) {
      int ectx;
      if (ci == 0)
        ectx = 0;
      else if (ci <= (n_pels >> 3))
        ectx = 1;
      else if (ci <= (n_pels >> 2))
        ectx = 2;
      else
        ectx = 3;
      p->symbol_fam(beob_fam, beob_rec_base + ectx, imin(level, 3) - 1);
    } else {
      int bctx = base_ctx(lv.data(), sw, sh, r, c, tclass, off);
      p->symbol_fam(base_fam, base_rec_base + bctx, imin(level, 3));
    }
    if (level > NUM_BASE_LEVELS) {
      int bctx = br_ctx_f(lv.data(), sw, sh, r, c, tclass);
      int base_range = level - 1 - NUM_BASE_LEVELS;
      for (int idx = 0; idx < COEFF_BASE_RANGE; idx += 3) {
        int k = imin(base_range - idx, 3);
        p->symbol_fam(br_fam, br_rec_base + bctx, k);
        if (k < 3) break;
      }
    }
  }
  // signs + golomb, forward
  int cul = 0, dc_cat = 0;
  for (int ci = 0; ci < eob; ci++) {
    int pos = scan[ci];
    int r = pos / sw, c = pos % sw;
    int level = lv[pos];
    if (level == 0) continue;
    int sign = levels[r * txw + c] < 0 ? 1 : 0;
    if (pos == 0) {
      p->symbol_fam(dc_fam, dc_rec, sign);
      dc_cat = sign ? 1 : 2;
    } else {
      ec.boolean(sign, 1 << 14);
    }
    if (level > COEFF_BASE_RANGE + NUM_BASE_LEVELS)
      ec.golomb(level - COEFF_BASE_RANGE - NUM_BASE_LEVELS - 1);
    cul += level;
  }
  if (cul > 63) cul = 63;
  return cul | (dc_cat << 6);
}

int packer_coeffs(void* h, int ptype, int txw, int txh, int tctx,
                  int br_tctx, int tclass, int eob_fam, int eob_rec,
                  int hi_fam, int hi_rec_base, int skip_fam, int skip_rec,
                  int beob_fam, int beob_rec_base, int base_fam,
                  int base_rec_base, int br_fam, int br_rec_base,
                  int dc_fam, int dc_rec, int txtype_fam, int txtype_rec,
                  int txtype_sym, const int32_t* levels) {
  return coeffs_impl((Packer*)h, ptype, txw, txh, tctx, br_tctx, tclass,
                     eob_fam, eob_rec, hi_fam, hi_rec_base, skip_fam,
                     skip_rec, beob_fam, beob_rec_base, base_fam,
                     base_rec_base, br_fam, br_rec_base, dc_fam, dc_rec,
                     txtype_fam, txtype_rec, txtype_sym, levels);
}

// ---------------------------------------------------------------------------
// The inter tile walk's symbol families and MV coding (shared by
// packer_inter_tile2 below).
// ---------------------------------------------------------------------------

struct InterTileFams {
  // family ids in the order the python side registers/passes them
  int part_mid;     // partition_mid [3][4]
  int skip;         // [3]
  int intra_inter;  // [4]
  int single_ref;   // [3][6] flattened
  int newmv, zeromv, refmv, drl;
  int mv_joint;             // [1]
  int mv_sign[2], mv_classes[2], mv_class0[2], mv_class0_fr[2];
  int mv_bits[2], mv_fr[2];
  int inter_ext_tx3;        // [4]
  // coefficient families
  int eob_pt_256, eob_pt_1024, eob_hi_bit, txb_skip;
  int coeff_base_eob, coeff_base, coeff_br, dc_sign;
};

static const int MODE_GLOBAL = 0, MODE_NEW = 1, MODE_NEAREST = 2,
                 MODE_NEAR = 3;

static void write_mv_comp(Packer* p, const InterTileFams& F, int ci,
                          int d) {
  Encoder& ec = p->ec;
  int sign = d < 0 ? 1 : 0;
  int z = (d < 0 ? -d : d) - 1;
  p->symbol_fam(F.mv_sign[ci], 0, sign);
  int cls;
  if (z < 16)
    cls = 0;
  else
    cls = 32 - __builtin_clz((unsigned)z) - 4;
  p->symbol_fam(F.mv_classes[ci], 0, cls);
  if (cls == 0) {
    p->symbol_fam(F.mv_class0[ci], 0, z >> 3);
    p->symbol_fam(F.mv_class0_fr[ci], z >> 3, (z >> 1) & 3);
  } else {
    int o = z - (2 << (cls + 2));
    for (int i = 0; i < cls; i++)
      p->symbol_fam(F.mv_bits[ci], i, (o >> (i + 3)) & 1);
    p->symbol_fam(F.mv_fr[ci], 0, (o >> 1) & 3);
  }
}

// ---- v2: mixed 32/16 partition P-frame tile --------------------------------
// Per-mi context state (the python TileWriter/InterCtx twin): supports
// PARTITION_SPLIT 32-blocks carrying four 16x16 sub-blocks with their
// own MVs, skip flags and TX16/TX8 residuals. Byte-identical to the
// python writer (asserted by tests). Mirrors rav1e
// src/context/block_unit.rs (mv stack) + src/encoder.rs block coding.

struct InterTile2 {
  int mi_rows, mi_cols;
  std::vector<uint8_t> set, mode, skip_mi, bw4g, bh4g, intra;
  std::vector<int32_t> mvr, mvc;
  std::vector<uint8_t> above_part, left_part;
  std::vector<uint8_t> acoef_y, lcoef_y, acoef_u, lcoef_u, acoef_v,
      lcoef_v;
  // per-64x64 CDEF index literal (spec read_cdef): first non-skip
  // block of each SB codes cdef_bits raw bits
  const uint8_t* cdef_idx = nullptr;
  int cdef_bits = 0, nsb_c = 0;
  std::vector<uint8_t> cdef_done;
  int at(int r, int c) const { return r * mi_cols + c; }
};

struct Stack2 {
  int32_t mv[8][2];
  int32_t w[8];
  int n, n_nearest, n_found;
  int new_ctx, ref_ctx;
  int drl_ctx[3];
};

static inline int32_t lower_mv(int32_t v) {
  if (v & 1) v += v < 0 ? 1 : -1;
  return v;
}

static void find_stack2(const InterTile2& t, int r, int c, int bw4,
                        int bh4, Stack2& o) {
  o.n = 0;
  int newmv_count = 0;
  auto push = [&](int32_t m0, int32_t m1, int wgt) {
    for (int i = 0; i < o.n; i++)
      if (o.mv[i][0] == m0 && o.mv[i][1] == m1) {
        o.w[i] += wgt;
        return;
      }
    if (o.n < 8) {
      o.mv[o.n][0] = m0;
      o.mv[o.n][1] = m1;
      o.w[o.n] = wgt;
      o.n++;
    }
  };
  auto add_cand = [&](int rr, int cc, int wgt, bool cnt) -> bool {
    if (rr < 0 || cc < 0 || rr >= t.mi_rows || cc >= t.mi_cols)
      return false;
    int g = t.at(rr, cc);
    if (!t.set[g]) return false;
    push(lower_mv(t.mvr[g]), lower_mv(t.mvc[g]), wgt);
    if (cnt && t.mode[g] == MODE_NEW) newmv_count++;
    return true;
  };
  auto scan_row = [&](int delta, bool close) -> bool {
    int rr = r + delta;
    if (rr < 0) return false;
    int end = imin(bw4, t.mi_cols - c);
    bool found = false;
    int i = 0;
    while (i < end) {
      int cc = c + i;
      int ln = imax(1, imin((int)t.bw4g[t.at(rr, cc)], bw4));
      if (!close) ln = imax(ln, 2);
      if (add_cand(rr, cc, 2 * ln, close)) found = true;
      i += ln;
    }
    return found;
  };
  auto scan_col = [&](int delta, bool close) -> bool {
    int cc = c + delta;
    if (cc < 0) return false;
    int end = imin(bh4, t.mi_rows - r);
    bool found = false;
    int i = 0;
    while (i < end) {
      int rr = r + i;
      int ln = imax(1, imin((int)t.bh4g[t.at(rr, cc)], bh4));
      if (!close) ln = imax(ln, 2);
      if (add_cand(rr, cc, 2 * ln, close)) found = true;
      i += ln;
    }
    return found;
  };
  bool found_row = scan_row(-1, true);
  bool found_col = scan_col(-1, true);
  bool tr = false;
  int sb_r = r % 16, sb_c = c % 16;
  bool has_tr = sb_r == 0 ? true : (sb_c + bw4 < 16);
  if (r > 0 && c + bw4 < t.mi_cols && has_tr)
    tr = add_cand(r - 1, c + bw4, 4, true);
  int nearest_match = (int)(found_row || tr) + (int)found_col;
  o.n_nearest = o.n;
  for (int i = 0; i < o.n; i++) o.w[i] += 640;
  bool tl = false;
  if (r > 0 && c > 0) tl = add_cand(r - 1, c - 1, 4, false);
  bool far_row = false, far_col = false;
  for (int idx = 3; idx <= 5; idx += 2) {
    if (r - idx >= 0) far_row |= scan_row(-idx, false);
    if (c - idx >= 0) far_col |= scan_col(-idx, false);
  }
  int total_match = (int)(found_row || tr || tl || far_row)
                    + (int)(found_col || far_col);
  o.new_ctx = 0;
  o.ref_ctx = 0;
  if (nearest_match == 0) {
    if (total_match >= 1) o.new_ctx = 1;
    o.ref_ctx = total_match == 1 ? 1 : (total_match >= 2 ? 2 : 0);
  } else if (nearest_match == 1) {
    o.new_ctx = newmv_count > 0 ? 2 : 3;
    o.ref_ctx = total_match == 1 ? 3 : 4;
  } else {
    o.new_ctx = newmv_count > 0 ? 4 : 5;
    o.ref_ctx = 5;
  }
  // two-segment stable sort by weight desc
  auto sort_seg = [&](int lo, int hi) {
    for (int i = lo + 1; i < hi; i++) {
      int32_t m0 = o.mv[i][0], m1 = o.mv[i][1], wv = o.w[i];
      int j = i;
      while (j > lo && o.w[j - 1] < wv) {
        o.mv[j][0] = o.mv[j - 1][0];
        o.mv[j][1] = o.mv[j - 1][1];
        o.w[j] = o.w[j - 1];
        j--;
      }
      o.mv[j][0] = m0;
      o.mv[j][1] = m1;
      o.w[j] = wv;
    }
  };
  sort_seg(0, o.n_nearest);
  sort_seg(o.n_nearest, o.n);
  // extra search (spec 7.10.2.12, single-ref): row -1 then col -1
  auto add_extra = [&](int rr, int cc) {
    int g = t.at(rr, cc);
    if (!t.set[g] || o.n >= 2) return;
    int32_t m0 = lower_mv(t.mvr[g]), m1 = lower_mv(t.mvc[g]);
    for (int k = 0; k < o.n; k++)
      if (o.mv[k][0] == m0 && o.mv[k][1] == m1) return;
    o.mv[o.n][0] = m0;
    o.mv[o.n][1] = m1;
    o.w[o.n] = 2;
    o.n++;
  };
  if (o.n < 2) {
    if (r > 0) {
      int i = 0, end = imin(bw4, t.mi_cols - c);
      while (i < end && o.n < 2) {
        int ln = imax(1, imin((int)t.bw4g[t.at(r - 1, c + i)], bw4));
        add_extra(r - 1, c + i);
        i += ln;
      }
    }
    if (c > 0) {
      int i = 0, end = imin(bh4, t.mi_rows - r);
      while (i < end && o.n < 2) {
        int ln = imax(1, imin((int)t.bh4g[t.at(r + i, c - 1)], bh4));
        add_extra(r + i, c - 1);
        i += ln;
      }
    }
  }
  o.n_found = o.n;
  while (o.n < 2) {
    o.mv[o.n][0] = 0;
    o.mv[o.n][1] = 0;
    o.w[o.n] = 0;
    o.n++;
  }
  for (int idx = 0; idx < 3; idx++) {
    int32_t w0 = idx < o.n ? o.w[idx] : 0;
    int32_t w1 = idx + 1 < o.n ? o.w[idx + 1] : 0;
    if (w0 >= 640 && w1 >= 640)
      o.drl_ctx[idx] = 0;
    else if (w0 >= 640)
      o.drl_ctx[idx] = 1;
    else if (w1 < 640)
      o.drl_ctx[idx] = 2;
    else
      o.drl_ctx[idx] = 0;
  }
}

long packer_inter_tile2(void* h, int mi_rows, int mi_cols,
                        const int32_t* fam_ids, const uint8_t* split,
                        const int32_t* mv8, const uint8_t* skip32,
                        const int32_t* mv16, const uint8_t* skip16,
                        const int16_t* lv_y, const int16_t* lv_u,
                        const int16_t* lv_v, const uint8_t* cdef_idx,
                        int cdef_bits, const uint8_t* intra32,
                        const uint8_t* b64, const uint8_t* split16,
                        const int32_t* mvq8, const uint8_t* skip8) {
  Packer* p = (Packer*)h;
  InterTileFams F;
  int eob_pt_64;
  int fam_y_mode, fam_uv_mode_cfl;
  int eob_pt_16 = -1, fam_part8 = -1;
  {
    const int32_t* f = fam_ids;
    F.part_mid = *f++; F.skip = *f++; F.intra_inter = *f++;
    F.single_ref = *f++; F.newmv = *f++; F.zeromv = *f++;
    F.refmv = *f++; F.drl = *f++; F.mv_joint = *f++;
    for (int ci = 0; ci < 2; ci++) {
      F.mv_sign[ci] = *f++; F.mv_classes[ci] = *f++;
      F.mv_class0[ci] = *f++; F.mv_class0_fr[ci] = *f++;
      F.mv_bits[ci] = *f++; F.mv_fr[ci] = *f++;
    }
    F.inter_ext_tx3 = *f++;
    F.eob_pt_256 = *f++; F.eob_pt_1024 = *f++; F.eob_hi_bit = *f++;
    F.txb_skip = *f++; F.coeff_base_eob = *f++; F.coeff_base = *f++;
    F.coeff_br = *f++; F.dc_sign = *f++;
    eob_pt_64 = *f++;
    fam_y_mode = *f++; fam_uv_mode_cfl = *f++;
    if (split16) { eob_pt_16 = *f++; fam_part8 = *f++; }
  }
  int nby = mi_rows / 8, nbx = mi_cols / 8;
  InterTile2 t;
  t.mi_rows = mi_rows;
  t.mi_cols = mi_cols;
  int M = mi_rows * mi_cols;
  t.set.assign(M, 0);
  t.intra.assign(M, 0);
  t.mode.assign(M, 0);
  t.skip_mi.assign(M, 0);
  t.bw4g.assign(M, 0);
  t.bh4g.assign(M, 0);
  t.mvr.assign(M, 0);
  t.mvc.assign(M, 0);
  t.above_part.assign(mi_cols, 0);
  t.left_part.assign(16, 0);
  t.acoef_y.assign(mi_cols, 0);
  t.lcoef_y.assign(mi_rows, 0);
  t.acoef_u.assign((mi_cols + 1) / 2, 0);
  t.lcoef_u.assign((mi_rows + 1) / 2, 0);
  t.acoef_v.assign((mi_cols + 1) / 2, 0);
  t.lcoef_v.assign((mi_rows + 1) / 2, 0);
  t.cdef_idx = cdef_idx;
  t.cdef_bits = cdef_bits;
  t.nsb_c = (mi_cols + 15) / 16;
  t.cdef_done.assign(t.nsb_c * ((mi_rows + 15) / 16), 0);

  auto part_ctx = [&](int r, int c, int bit) {
    int above = (t.above_part[c] >> bit) & 1;
    int left = (t.left_part[r & 15] >> bit) & 1;
    return left * 2 + above;
  };
  auto update_part = [&](int r, int c, int sub_wlog, int bw, int bh) {
    uint8_t aval = (uint8_t)(31 & ~((1 << sub_wlog) - 1));
    for (int i = 0; i < bw && c + i < mi_cols; i++)
      t.above_part[c + i] = aval;
    int lo = r & 15;
    for (int i = 0; i < bh && lo + i < 16; i++) t.left_part[lo + i] = aval;
  };

  // one coded block of bw4 x bh4 mi (bw4 in {4, 8}); sub-level arrays
  // point into the quadrant-packed [32x32]/[16x16] level planes
  // spec intra_inter ctx: neighbor is_intra flags
  auto ii_ctx = [&](int r, int c) {
    bool ha = r > 0, hl = c > 0;
    if (ha && hl) {
      int ai = t.intra[t.at(r - 1, c)], li = t.intra[t.at(r, c - 1)];
      return (ai && li) ? 3 : ((ai || li) ? 1 : 0);
    }
    if (ha || hl) {
      int ni = ha ? t.intra[t.at(r - 1, c)] : t.intra[t.at(r, c - 1)];
      return 2 * ni;
    }
    return 0;
  };

  auto write_block2 = [&](int r, int c, int bw4, int mv0, int mv1,
                          int skipf, const int16_t* ly, int ly_stride,
                          const int16_t* lu, int lu_stride,
                          const int16_t* lvv, int lv_stride,
                          int is_intra) {
    int bh4 = bw4;
    int above_sk = r > 0 ? t.skip_mi[t.at(r - 1, c)] : 0;
    int left_sk = c > 0 ? t.skip_mi[t.at(r, c - 1)] : 0;
    p->symbol_fam(F.skip, above_sk + left_sk, skipf);
    if (t.cdef_bits > 0 && !skipf) {
      int sb = (r / 16) * t.nsb_c + (c / 16);
      if (!t.cdef_done[sb]) {
        t.cdef_done[sb] = 1;
        p->ec.literal((uint32_t)t.cdef_idx[sb], t.cdef_bits);
      }
    }
    int mode = MODE_GLOBAL;
    if (is_intra) {
      // intra block in an inter frame: is_inter = 0, size-group
      // y_mode (DC), uv_mode_cfl (DC), intra residual (ttf = -1)
      p->symbol_fam(F.intra_inter, ii_ctx(r, c), 0);
      p->symbol_fam(fam_y_mode, bw4 == 8 ? 3 : 2, 0);
      p->symbol_fam(fam_uv_mode_cfl, 0, 0);
      goto residual;
    }
    p->symbol_fam(F.intra_inter, ii_ctx(r, c), 1);
    {
    // single-ref tree ctx from INTER neighbors only (spec
    // get_pred_context_single_ref: intra neighbors count nothing)
    int k = 0;
    if (r > 0 && !t.intra[t.at(r - 1, c)]) k++;
    if (c > 0 && !t.intra[t.at(r, c - 1)]) k++;
    int sr = k == 0 ? 1 : 2;
    p->symbol_fam(F.single_ref, sr * 6 + 0, 0);
    p->symbol_fam(F.single_ref, sr * 6 + 2, 0);
    p->symbol_fam(F.single_ref, sr * 6 + 3, 0);
    Stack2 st;
    find_stack2(t, r, c, bw4, bh4, st);
    if (mv0 != 0 || mv1 != 0) {
      mode = MODE_NEW;
      if (mv0 == st.mv[0][0] && mv1 == st.mv[0][1])
        mode = MODE_NEAREST;
      else if (st.n_found >= 2 && mv0 == st.mv[1][0]
               && mv1 == st.mv[1][1])
        mode = MODE_NEAR;
    }
    if (mode == MODE_NEW) {
      p->symbol_fam(F.newmv, st.new_ctx, 0);
      for (int idx = 0; idx < 2; idx++) {
        if (st.n_found > idx + 1) {
          p->symbol_fam(F.drl, st.drl_ctx[idx], 0);
          break;
        }
      }
      int pr = st.mv[0][0], pc = st.mv[0][1];
      int dr = mv0 - pr, dc = mv1 - pc;
      int joint = (dr != 0 ? 2 : 0) | (dc != 0 ? 1 : 0);
      p->symbol_fam(F.mv_joint, 0, joint);
      if (dr != 0) write_mv_comp(p, F, 0, dr);
      if (dc != 0) write_mv_comp(p, F, 1, dc);
    } else {
      p->symbol_fam(F.newmv, st.new_ctx, 1);
      if (mode == MODE_GLOBAL) {
        p->symbol_fam(F.zeromv, 0, 0);
      } else {
        p->symbol_fam(F.zeromv, 0, 1);
        p->symbol_fam(F.refmv, st.ref_ctx, mode == MODE_NEAREST ? 0 : 1);
        if (mode == MODE_NEAR) {
          for (int idx = 1; idx < 3; idx++) {
            if (st.n_found > idx + 1) {
              p->symbol_fam(F.drl, st.drl_ctx[idx], 0);
              break;
            }
          }
        }
      }
    }
    }
  residual:
    if (!skipf) {
      auto tu = [&](int plane, const int16_t* lvp, int stride, int n,
                    int tctx, uint8_t* acoef, uint8_t* lcoef, int u_c,
                    int u_r, int eob_fam, int tt_on, int un_ov) {
        int un = un_ov ? un_ov : n / 4;
        int ptype = plane == 0 ? 0 : 1;
        int skip_ctx;
        if (plane == 0)
          skip_ctx = 0;
        else {
          int a = 0, l = 0;
          for (int i = 0; i < un; i++) {
            if (acoef[u_c + i]) a = 1;
            if (lcoef[u_r + i]) l = 1;
          }
          skip_ctx = 7 + a + l;
        }
        int dcs = 0;
        for (int i = 0; i < un; i++) {
          int ca = acoef[u_c + i] >> 6, cl = lcoef[u_r + i] >> 6;
          dcs += ca == 2 ? 1 : (ca == 1 ? -1 : 0);
          dcs += cl == 2 ? 1 : (cl == 1 ? -1 : 0);
        }
        int dc_ctx = dcs == 0 ? 0 : (dcs < 0 ? 1 : 2);
        int32_t lv[32 * 32];
        for (int rr = 0; rr < n; rr++)
          for (int cc = 0; cc < n; cc++)
            lv[rr * n + cc] = lvp[rr * stride + cc];
        int ttf = (plane == 0 && !is_intra && tt_on)
                      ? F.inter_ext_tx3 : -1;
        int ttrec = n == 32 ? 3 : (n == 16 ? 2 : 1);
        int eob_rec = n == 32 ? ptype : ptype * 2;
        int cul = coeffs_impl(
            p, ptype, n, n, tctx, imin(tctx, 3), C2D, eob_fam, eob_rec,
            F.eob_hi_bit, (tctx * 2 + ptype) * 11, F.txb_skip,
            tctx * 13 + skip_ctx, F.coeff_base_eob,
            (tctx * 2 + ptype) * 4, F.coeff_base,
            (tctx * 2 + ptype) * 41, F.coeff_br,
            (imin(tctx, 3) * 2 + ptype) * 21, F.dc_sign,
            ptype * 3 + dc_ctx, ttf, ttrec, 1, lv);
        for (int i = 0; i < un; i++) {
          acoef[u_c + i] = (uint8_t)cul;
          lcoef[u_r + i] = (uint8_t)cul;
        }
      };
      if (bw4 == 16) {
        // B64: TX_64X64 luma (retained 32x32 low-freq coeffs, txs_ctx
        // 4, no inter tx symbol — spec get_tx_set sqr_up > 32) +
        // TX_32X32 chroma; the coef context spans cover 16/8 units
        tu(0, ly, ly_stride, 32, 4, t.acoef_y.data(), t.lcoef_y.data(),
           c, r, F.eob_pt_1024, 0, 16);
        tu(1, lu, lu_stride, 32, 3, t.acoef_u.data(), t.lcoef_u.data(),
           c / 2, r / 2, F.eob_pt_1024, 0, 8);
        tu(2, lvv, lv_stride, 32, 3, t.acoef_v.data(),
           t.lcoef_v.data(), c / 2, r / 2, F.eob_pt_1024, 0, 8);
      } else if (bw4 == 8) {
        tu(0, ly, ly_stride, 32, 3, t.acoef_y.data(), t.lcoef_y.data(),
           c, r, F.eob_pt_1024, 1, 0);
        tu(1, lu, lu_stride, 16, 2, t.acoef_u.data(), t.lcoef_u.data(),
           c / 2, r / 2, F.eob_pt_256, 1, 0);
        tu(2, lvv, lv_stride, 16, 2, t.acoef_v.data(),
           t.lcoef_v.data(), c / 2, r / 2, F.eob_pt_256, 1, 0);
      } else if (bw4 == 4) {
        tu(0, ly, ly_stride, 16, 2, t.acoef_y.data(), t.lcoef_y.data(),
           c, r, F.eob_pt_256, 1, 0);
        tu(1, lu, lu_stride, 8, 1, t.acoef_u.data(), t.lcoef_u.data(),
           c / 2, r / 2, eob_pt_64, 1, 0);
        tu(2, lvv, lv_stride, 8, 1, t.acoef_v.data(), t.lcoef_v.data(),
           c / 2, r / 2, eob_pt_64, 1, 0);
      } else {
        // 8x8 block: TX_8X8 luma (txs_ctx 1) + TX_4X4 chroma
        // (txs_ctx 0, eob_pt_16) — spec chroma_tx_size(B8X8, 420)
        tu(0, ly, ly_stride, 8, 1, t.acoef_y.data(), t.lcoef_y.data(),
           c, r, eob_pt_64, 1, 0);
        tu(1, lu, lu_stride, 4, 0, t.acoef_u.data(), t.lcoef_u.data(),
           c / 2, r / 2, eob_pt_16, 1, 0);
        tu(2, lvv, lv_stride, 4, 0, t.acoef_v.data(), t.lcoef_v.data(),
           c / 2, r / 2, eob_pt_16, 1, 0);
      }
    } else {
      for (int i = 0; i < bw4; i++) {
        t.acoef_y[c + i] = 0;
        t.lcoef_y[r + i] = 0;
      }
      for (int i = 0; i < bw4 / 2; i++) {
        t.acoef_u[c / 2 + i] = 0;
        t.lcoef_u[r / 2 + i] = 0;
        t.acoef_v[c / 2 + i] = 0;
        t.lcoef_v[r / 2 + i] = 0;
      }
    }
    for (int rr = r; rr < r + bh4; rr++)
      for (int cc = c; cc < c + bw4; cc++) {
        int g = t.at(rr, cc);
        t.set[g] = is_intra ? 0 : 1;   // intra mis: no stack entry
        t.intra[g] = (uint8_t)is_intra;
        t.mode[g] = (uint8_t)mode;
        t.skip_mi[g] = (uint8_t)skipf;
        t.bw4g[g] = (uint8_t)bw4;
        t.bh4g[g] = (uint8_t)bh4;
        t.mvr[g] = is_intra ? 0 : mv0;
        t.mvc[g] = is_intra ? 0 : mv1;
      }
  };

  auto split_bool = [&](int ctx, int size_idx, bool vert_alike, int bit) {
    Cdf& cdf = p->fams[F.part_mid][size_idx * 4 + ctx];
    static const int VSET[6] = {2, 3, 4, 6, 7, 9};
    static const int HSET[6] = {1, 3, 4, 5, 6, 8};
    const int* ks = vert_alike ? VSET : HSET;
    uint32_t psum = 0;
    for (int i = 0; i < 6; i++) {
      int kk = ks[i];
      if (kk >= cdf.n) continue;
      uint32_t prev = (kk == 0) ? PROB_TOP : cdf.v[kk - 1];
      psum += prev - cdf.v[kk];
    }
    uint16_t derived[3] = {(uint16_t)psum, 0, 0};
    p->ec.symbol_raw(bit, derived, 2);
  };

  for (int r = 0; r < mi_rows; r += 16) {
    std::fill(t.left_part.begin(), t.left_part.end(), 0);
    for (int c = 0; c < mi_cols; c += 16) {
      bool rows64 = r + 8 < mi_rows, cols64 = c + 8 < mi_cols;
      int ctx64 = part_ctx(r, c, 3);
      int sbi = (r / 16) * t.nsb_c + (c / 16);
      if (b64 && b64[sbi] && rows64 && cols64) {
        // PARTITION_NONE at 64: one block, TX64 luma from the TL
        // child's slot, TX32 chroma assembled from child quadrants
        p->symbol_fam(F.part_mid, 2 * 4 + ctx64, 0 /* NONE */);
        int g_tl = (r / 8) * nbx + (c / 8);
        int16_t cu[32 * 32], cv[32 * 32];
        for (int q = 0; q < 4; q++) {
          int child = g_tl + (q >> 1) * nbx + (q & 1);
          int dr = (q >> 1) * 16, dc = (q & 1) * 16;
          for (int i = 0; i < 16; i++)
            for (int j = 0; j < 16; j++) {
              cu[(dr + i) * 32 + dc + j] = lv_u[child * 256 + i * 16 + j];
              cv[(dr + i) * 32 + dc + j] = lv_v[child * 256 + i * 16 + j];
            }
        }
        write_block2(r, c, 16, mv8[g_tl * 2], mv8[g_tl * 2 + 1],
                     skip32[g_tl], lv_y + g_tl * 1024, 32,
                     cu, 32, cv, 32, 0);
        update_part(r, c, 4, 16, 16);
        continue;
      }
      if (rows64 && cols64) {
        p->symbol_fam(F.part_mid, 2 * 4 + ctx64, 3 /* SPLIT */);
      } else if (cols64) {
        split_bool(ctx64, 2, true, 1);
      } else if (rows64) {
        split_bool(ctx64, 2, false, 1);
      }
      for (int k = 0; k < 4; k++) {
        int rr = r + (k >> 1) * 8, cc = c + (k & 1) * 8;
        if (rr >= mi_rows || cc >= mi_cols) continue;
        int g = (rr / 8) * nbx + (cc / 8);
        int ctx32 = part_ctx(rr, cc, 2);
        if (split[g]) {
          p->symbol_fam(F.part_mid, 1 * 4 + ctx32, 3 /* SPLIT */);
          for (int q = 0; q < 4; q++) {
            int qr = rr + (q >> 1) * 4, qc = cc + (q & 1) * 4;
            int ctx16 = part_ctx(qr, qc, 1);
            // quadrant offsets into the packed level planes
            int py = (q >> 1) * 16, px = (q & 1) * 16;
            int cy = (q >> 1) * 8, cx = (q & 1) * 8;
            if (split16 && split16[g * 4 + q]) {
              // 16x16 PARTITION_SPLIT -> four 8x8 blocks, each coding
              // its own partition_8 NONE symbol (write_sb_tree twin)
              p->symbol_fam(F.part_mid, 0 * 4 + ctx16, 3 /* SPLIT */);
              for (int s = 0; s < 4; s++) {
                int sr = qr + (s >> 1) * 2, sc = qc + (s & 1) * 2;
                int ctx8 = part_ctx(sr, sc, 0);
                p->symbol_fam(fam_part8, ctx8, 0 /* NONE */);
                int sy = py + (s >> 1) * 8, sx = px + (s & 1) * 8;
                int scy = cy + (s >> 1) * 4, scx = cx + (s & 1) * 4;
                int e = (g * 4 + q) * 4 + s;
                write_block2(sr, sc, 2, mvq8[e * 2], mvq8[e * 2 + 1],
                             skip8[e],
                             lv_y + g * 1024 + sy * 32 + sx, 32,
                             lv_u + g * 256 + scy * 16 + scx, 16,
                             lv_v + g * 256 + scy * 16 + scx, 16, 0);
                update_part(sr, sc, 1, 2, 2);
              }
              continue;
            }
            p->symbol_fam(F.part_mid, 0 * 4 + ctx16, 0 /* NONE */);
            write_block2(qr, qc, 4, mv16[(g * 4 + q) * 2],
                         mv16[(g * 4 + q) * 2 + 1], skip16[g * 4 + q],
                         lv_y + g * 1024 + py * 32 + px, 32,
                         lv_u + g * 256 + cy * 16 + cx, 16,
                         lv_v + g * 256 + cy * 16 + cx, 16, 0);
            update_part(qr, qc, 2, 4, 4);
          }
        } else {
          p->symbol_fam(F.part_mid, 1 * 4 + ctx32, 0 /* NONE */);
          write_block2(rr, cc, 8, mv8[g * 2], mv8[g * 2 + 1],
                       skip32[g], lv_y + g * 1024, 32,
                       lv_u + g * 256, 16, lv_v + g * 256, 16,
                       intra32 ? intra32[g] : 0);
          update_part(rr, cc, 3, 8, 8);
        }
      }
    }
  }
  return p->ec.rows();
}

// ---- one-call KEY-frame (intra) tile writer --------------------------------
// Ports TileWriter.write_tile + write_intra_block for the block class
// the batched TPU keyframe pipeline emits: 32x32 blocks (or 4x16x16
// via PARTITION_SPLIT), kf_y_mode with neighbor contexts, angle-delta
// 0 for directional modes, uv_mode_cfl (+ CfL sign/alpha), luma
// TX32 (DCT, no tx symbol) / TX16 quads (intra tx set 2 symbol),
// chroma TX16/TX8. Byte-identical to the python writer.

struct IntraTileFams {
  int part_mid, skip, kf_y_mode, angle_delta, uv_mode_cfl, cfl_sign,
      cfl_alpha, intra_ext_tx2;
  int eob_pt_1024, eob_pt_256, eob_pt_64, eob_hi_bit, txb_skip,
      coeff_base_eob, coeff_base, coeff_br, dc_sign;
  int part_8, eob_pt_16;
};

long packer_intra_tile(void* h, int mi_rows, int mi_cols,
                       const int32_t* fam_ids, const uint8_t* split,
                       const uint8_t* ymodes, const uint8_t* uvmodes,
                       const int8_t* cfl, const int16_t* lv_y,
                       const int16_t* lv_u, const int16_t* lv_v,
                       const uint8_t* cdef_idx, int cdef_bits,
                       const uint8_t* ytx, const uint8_t* split16,
                       const uint8_t* ym8, const uint8_t* uvm8) {
  Packer* p = (Packer*)h;
  IntraTileFams F;
  {
    const int32_t* f = fam_ids;
    F.part_mid = *f++; F.skip = *f++; F.kf_y_mode = *f++;
    F.angle_delta = *f++; F.uv_mode_cfl = *f++; F.cfl_sign = *f++;
    F.cfl_alpha = *f++; F.intra_ext_tx2 = *f++;
    F.eob_pt_1024 = *f++; F.eob_pt_256 = *f++; F.eob_pt_64 = *f++;
    F.eob_hi_bit = *f++; F.txb_skip = *f++; F.coeff_base_eob = *f++;
    F.coeff_base = *f++; F.coeff_br = *f++; F.dc_sign = *f++;
    F.part_8 = *f++; F.eob_pt_16 = *f++;
  }
  int nbx = mi_cols / 8;
  int M = mi_rows * mi_cols;
  std::vector<uint8_t> skip_mi(M, 0), ymode_mi(M, 0);
  std::vector<uint8_t> above_part(mi_cols, 0), left_part(16, 0);
  std::vector<uint8_t> acoef_y(mi_cols, 0), lcoef_y(mi_rows, 0);
  std::vector<uint8_t> acoef_u((mi_cols + 1) / 2, 0),
      lcoef_u((mi_rows + 1) / 2, 0), acoef_v((mi_cols + 1) / 2, 0),
      lcoef_v((mi_rows + 1) / 2, 0);
  int nsb_c = (mi_cols + 15) / 16;
  std::vector<uint8_t> cdef_done(nsb_c * ((mi_rows + 15) / 16), 0);
  auto at = [&](int r, int c) { return r * mi_cols + c; };
  static const int IMC[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};

  auto part_ctx = [&](int r, int c, int bit) {
    int above = (above_part[c] >> bit) & 1;
    int left = (left_part[r & 15] >> bit) & 1;
    return left * 2 + above;
  };
  auto update_part = [&](int r, int c, int sub_wlog, int bw, int bh) {
    uint8_t aval = (uint8_t)(31 & ~((1 << sub_wlog) - 1));
    for (int i = 0; i < bw && c + i < mi_cols; i++)
      above_part[c + i] = aval;
    int lo = r & 15;
    for (int i = 0; i < bh && lo + i < 16; i++) left_part[lo + i] = aval;
  };
  auto split_bool = [&](int ctx, int size_idx, bool vert_alike,
                        int bit) {
    Cdf& cdf = p->fams[F.part_mid][size_idx * 4 + ctx];
    static const int VSET[6] = {2, 3, 4, 6, 7, 9};
    static const int HSET[6] = {1, 3, 4, 5, 6, 8};
    const int* ks = vert_alike ? VSET : HSET;
    uint32_t psum = 0;
    for (int i = 0; i < 6; i++) {
      int kk = ks[i];
      if (kk >= cdf.n) continue;
      uint32_t prev = (kk == 0) ? PROB_TOP : cdf.v[kk - 1];
      psum += prev - cdf.v[kk];
    }
    uint16_t derived[3] = {(uint16_t)psum, 0, 0};
    p->ec.symbol_raw(bit, derived, 2);
  };

  // one intra block of bw4 x bw4 mi (bw4 in {8, 4}); tt16 = the
  // intra_ext_tx2 symbol for the TX16 luma (1 = DCT, 2..4 = ADST
  // combos; coeff scan/contexts identical across the 2D class)
  auto write_blockI = [&](int r, int c, int bw4, int ym, int uvm,
                          int au, int av, const int16_t* ly, int lys,
                          const int16_t* lu, int lus,
                          const int16_t* lvv2, int lvs, int tt16) {
    int n = bw4 * 4;
    bool nz = false;
    for (int rr = 0; rr < n && !nz; rr++)
      for (int cc = 0; cc < n; cc++)
        if (ly[rr * lys + cc]) { nz = true; break; }
    for (int rr = 0; rr < n / 2 && !nz; rr++)
      for (int cc = 0; cc < n / 2; cc++)
        if (lu[rr * lus + cc] || lvv2[rr * lvs + cc]) {
          nz = true;
          break;
        }
    int skipf = nz ? 0 : 1;
    int above_sk = r > 0 ? skip_mi[at(r - 1, c)] : 0;
    int left_sk = c > 0 ? skip_mi[at(r, c - 1)] : 0;
    p->symbol_fam(F.skip, above_sk + left_sk, skipf);
    if (cdef_bits > 0 && !skipf) {
      int sb = (r / 16) * nsb_c + (c / 16);
      if (!cdef_done[sb]) {
        cdef_done[sb] = 1;
        p->ec.literal((uint32_t)cdef_idx[sb], cdef_bits);
      }
    }
    int am = r > 0 ? ymode_mi[at(r - 1, c)] : 0;
    int lm = c > 0 ? ymode_mi[at(r, c - 1)] : 0;
    p->symbol_fam(F.kf_y_mode, IMC[am] * 5 + IMC[lm], ym);
    if (ym >= 1 && ym <= 8)                 // directional: delta 0
      p->symbol_fam(F.angle_delta, ym - 1, 3);
    p->symbol_fam(F.uv_mode_cfl, ym, uvm);
    if (uvm == 13) {                        // UV_CFL_PRED
      int su = au == 0 ? 0 : (au < 0 ? 1 : 2);
      int sv = av == 0 ? 0 : (av < 0 ? 1 : 2);
      int js = su * 3 + sv - 1;
      p->symbol_fam(F.cfl_sign, 0, js);
      int aau = au < 0 ? -au : au, aav = av < 0 ? -av : av;
      if (su) p->symbol_fam(F.cfl_alpha, js - 2, aau - 1);
      if (sv) p->symbol_fam(F.cfl_alpha, sv * 3 + su - 3, aav - 1);
    }
    if (uvm >= 1 && uvm <= 8)
      p->symbol_fam(F.angle_delta, uvm - 1, 3);
    if (!skipf) {
      auto tu = [&](int plane, const int16_t* lvp, int stride, int tn,
                    int tctx, uint8_t* acoef, uint8_t* lcoef, int u_c,
                    int u_r, int eob_fam, int ttf, int ttrec,
                    int ttsym) {
        int un = tn / 4;
        int ptype = plane == 0 ? 0 : 1;
        int skip_ctx;
        if (plane == 0)
          skip_ctx = 0;
        else {
          int a = 0, l = 0;
          for (int i = 0; i < un; i++) {
            if (acoef[u_c + i]) a = 1;
            if (lcoef[u_r + i]) l = 1;
          }
          skip_ctx = 7 + a + l;
        }
        int dcs = 0;
        for (int i = 0; i < un; i++) {
          int ca = acoef[u_c + i] >> 6, cl = lcoef[u_r + i] >> 6;
          dcs += ca == 2 ? 1 : (ca == 1 ? -1 : 0);
          dcs += cl == 2 ? 1 : (cl == 1 ? -1 : 0);
        }
        int dc_ctx = dcs == 0 ? 0 : (dcs < 0 ? 1 : 2);
        int32_t lv[32 * 32];
        for (int rr = 0; rr < tn; rr++)
          for (int cc = 0; cc < tn; cc++)
            lv[rr * tn + cc] = lvp[rr * stride + cc];
        int eob_rec = tn == 32 ? ptype : ptype * 2;
        int cul = coeffs_impl(
            p, ptype, tn, tn, tctx, imin(tctx, 3), C2D, eob_fam,
            eob_rec, F.eob_hi_bit, (tctx * 2 + ptype) * 11,
            F.txb_skip, tctx * 13 + skip_ctx, F.coeff_base_eob,
            (tctx * 2 + ptype) * 4, F.coeff_base,
            (tctx * 2 + ptype) * 41, F.coeff_br,
            (imin(tctx, 3) * 2 + ptype) * 21, F.dc_sign,
            ptype * 3 + dc_ctx, ttf, ttrec, ttsym, lv);
        for (int i = 0; i < un; i++) {
          acoef[u_c + i] = (uint8_t)cul;
          lcoef[u_r + i] = (uint8_t)cul;
        }
      };
      if (bw4 == 8) {
        // TX_32X32 luma: intra tx set 0, no symbol
        tu(0, ly, lys, 32, 3, acoef_y.data(), lcoef_y.data(), c, r,
           F.eob_pt_1024, -1, 0, 0);
        tu(1, lu, lus, 16, 2, acoef_u.data(), lcoef_u.data(), c / 2,
           r / 2, F.eob_pt_256, -1, 0, 0);
        tu(2, lvv2, lvs, 16, 2, acoef_v.data(), lcoef_v.data(), c / 2,
           r / 2, F.eob_pt_256, -1, 0, 0);
      } else if (bw4 == 4) {
        // TX_16X16 luma intra: set 2 symbol, rec sqr*13+mode
        tu(0, ly, lys, 16, 2, acoef_y.data(), lcoef_y.data(), c, r,
           F.eob_pt_256, F.intra_ext_tx2, 2 * 13 + ym, tt16);
        tu(1, lu, lus, 8, 1, acoef_u.data(), lcoef_u.data(), c / 2,
           r / 2, F.eob_pt_64, -1, 0, 0);
        tu(2, lvv2, lvs, 8, 1, acoef_v.data(), lcoef_v.data(), c / 2,
           r / 2, F.eob_pt_64, -1, 0, 0);
      } else {
        // B8X8: TX_8X8 luma (set 2 symbol, sqr idx 1) + TX_4X4 chroma
        tu(0, ly, lys, 8, 1, acoef_y.data(), lcoef_y.data(), c, r,
           F.eob_pt_64, F.intra_ext_tx2, 1 * 13 + ym, tt16);
        tu(1, lu, lus, 4, 0, acoef_u.data(), lcoef_u.data(), c / 2,
           r / 2, F.eob_pt_16, -1, 0, 0);
        tu(2, lvv2, lvs, 4, 0, acoef_v.data(), lcoef_v.data(), c / 2,
           r / 2, F.eob_pt_16, -1, 0, 0);
      }
    } else {
      for (int i = 0; i < bw4; i++) {
        acoef_y[c + i] = 0;
        lcoef_y[r + i] = 0;
      }
      for (int i = 0; i < bw4 / 2; i++) {
        acoef_u[c / 2 + i] = 0;
        lcoef_u[r / 2 + i] = 0;
        acoef_v[c / 2 + i] = 0;
        lcoef_v[r / 2 + i] = 0;
      }
    }
    for (int rr = r; rr < r + bw4; rr++)
      for (int cc = c; cc < c + bw4; cc++) {
        skip_mi[at(rr, cc)] = (uint8_t)skipf;
        ymode_mi[at(rr, cc)] = (uint8_t)ym;
      }
  };

  for (int r = 0; r < mi_rows; r += 16) {
    std::fill(left_part.begin(), left_part.end(), 0);
    for (int c = 0; c < mi_cols; c += 16) {
      bool rows64 = r + 8 < mi_rows, cols64 = c + 8 < mi_cols;
      int ctx64 = part_ctx(r, c, 3);
      if (rows64 && cols64) {
        p->symbol_fam(F.part_mid, 2 * 4 + ctx64, 3 /* SPLIT */);
      } else if (cols64) {
        split_bool(ctx64, 2, true, 1);
      } else if (rows64) {
        split_bool(ctx64, 2, false, 1);
      }
      for (int k = 0; k < 4; k++) {
        int rr = r + (k >> 1) * 8, cc = c + (k & 1) * 8;
        if (rr >= mi_rows || cc >= mi_cols) continue;
        int g = (rr / 8) * nbx + (cc / 8);
        int ctx32 = part_ctx(rr, cc, 2);
        if (split[g]) {
          p->symbol_fam(F.part_mid, 1 * 4 + ctx32, 3 /* SPLIT */);
          for (int q = 0; q < 4; q++) {
            int qr = rr + (q >> 1) * 4, qc = cc + (q & 1) * 4;
            int ctx16 = part_ctx(qr, qc, 1);
            int py = (q >> 1) * 16, px = (q & 1) * 16;
            int cy = (q >> 1) * 8, cx = (q & 1) * 8;
            if (split16 && split16[g * 4 + q]) {
              // 16 -> 8 SPLIT: four B8X8 children (TX_8X8 + TX_4X4)
              p->symbol_fam(F.part_mid, 0 * 4 + ctx16, 3 /* SPLIT */);
              for (int s = 0; s < 4; s++) {
                int sr = qr + (s >> 1) * 2, sc = qc + (s & 1) * 2;
                int ctx8 = part_ctx(sr, sc, 0);
                p->symbol_fam(F.part_8, ctx8, 0 /* NONE */);
                int sy = py + (s >> 1) * 8, sx = px + (s & 1) * 8;
                int scy = cy + (s >> 1) * 4, scx = cx + (s & 1) * 4;
                write_blockI(sr, sc, 2, ym8[g * 16 + q * 4 + s],
                             uvm8[g * 16 + q * 4 + s], 0, 0,
                             lv_y + g * 1024 + sy * 32 + sx, 32,
                             lv_u + g * 256 + scy * 16 + scx, 16,
                             lv_v + g * 256 + scy * 16 + scx, 16, 1);
                update_part(sr, sc, 1, 2, 2);
              }
              continue;
            }
            p->symbol_fam(F.part_mid, 0 * 4 + ctx16, 0 /* NONE */);
            write_blockI(qr, qc, 4, ymodes[g * 5 + 1 + q],
                         uvmodes[g * 5 + 1 + q], 0, 0,
                         lv_y + g * 1024 + py * 32 + px, 32,
                         lv_u + g * 256 + cy * 16 + cx, 16,
                         lv_v + g * 256 + cy * 16 + cx, 16,
                         ytx[g * 4 + q]);
            update_part(qr, qc, 2, 4, 4);
          }
        } else {
          p->symbol_fam(F.part_mid, 1 * 4 + ctx32, 0 /* NONE */);
          write_blockI(rr, cc, 8, ymodes[g * 5], uvmodes[g * 5],
                       cfl[g * 2], cfl[g * 2 + 1], lv_y + g * 1024,
                       32, lv_u + g * 256, 16, lv_v + g * 256, 16, 1);
          update_part(rr, cc, 3, 8, 8);
        }
      }
    }
  }
  return p->ec.rows();
}

void packer_split_bool(void* h, int fam, int rec, int bit,
                       const int32_t* ks, int nks) {
  Packer* p = (Packer*)h;
  Cdf& c = p->fams[fam][rec];
  uint32_t psum = 0;
  for (int i = 0; i < nks; i++) {
    int k = ks[i];
    if (k >= c.n) continue;
    uint32_t prev = (k == 0) ? PROB_TOP : c.v[k - 1];
    psum += prev - c.v[k];
  }
  uint16_t derived[3] = {(uint16_t)psum, 0, 0};
  p->ec.symbol_raw(bit, derived, 2);
}

// The IR rows recorded so far.
long packer_rows(void* h) { return ((Packer*)h)->ec.rows(); }

// Hand back the tile's IR: int32 [rows][4] into out (cap rows). Returns
// the row count, or minus it when out is too small (nothing written).
long packer_done(void* h, int32_t* out, long cap) {
  return ((Packer*)h)->ec.take(out, cap);
}

}  // extern C
