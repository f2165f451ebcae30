// Root-tree size probe of EPS auto-splitting, in native host code.
//
// The depth-first branch-and-bound of the numpy oracle
// (host/solver/oracle.py: solve, PropTable) node for node: the same
// AC-1 sweeps (Jacobi inside an op group, groups in op order, then the
// element, membership and linear rows; a sweep ends the fixpoint when
// it changes nothing, and the store is bot when some lb > ub after a
// sweep), the same deduction and entailment rules
// (host/solver/deduce_np.py, with its clamps to [NINF, INF] and the
// linear rows' SUM_CLAMP), the objective tightened to best - 1 at each
// popped node, the variable and value orders of host/solver/strategy.py
// with the left child explored first, and the node limit and the wall
// checked before each pop. Stop after the first solution of a
// satisfaction problem, as the oracle's default does.
//
// The tables come from the oracle's own PropTable (tree_probe.py reads
// them), so the rows, their order and the membership tables are the
// oracle's by construction.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libtree_probe.so tree_probe.cpp
// ABI: plain C through ctypes; ProbeIn is mirrored in tree_probe.py.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

typedef int64_t i64;

const i64 INF = (i64(1) << 30) - 1;
const i64 NINF = -INF;
const i64 SUM_CLAMP = i64(1) << 40;
const int MAX_ITERS = 100000;  // PropTable.propagate's max_iters

enum { OP_ADD, OP_MUL, OP_DIV, OP_MIN, OP_MAX, OP_LE, OP_EQ };

}  // namespace

extern "C" {

struct ProbeIn {
  i64 V;
  const i64 *lb0, *ub0;
  // Propagators in PropTable's order (stable sort by op), and the op
  // groups as [lo, hi) row ranges.
  i64 P;
  const i64 *xs, *ys, *zs;
  i64 G;
  const i64 *g_op, *g_lo, *g_hi;
  // Element rows: E rows of T table entries.
  i64 E, T;
  const i64 *e_idx, *e_res, *e_len, *e_tab;
  // Membership rows over a hull window of W values.
  i64 M, W;
  const i64 *m_x, *m_b, *m_base, *m_top, *m_cnt, *m_next_ge, *m_prev_le,
      *m_next_out, *m_prev_out;
  // Linear rows: L rows of K terms (coefficient 0 pads).
  i64 L, K;
  const i64 *l_b, *l_op, *l_rhs, *l_coef, *l_var;
  // Strategies: var order and value order codes, and each one's ids
  // (s_len < 0: every variable in id order).
  i64 S;
  const i64 *s_vo, *s_valo, *s_off, *s_len, *s_ids;
  i64 obj_var;  // -1: satisfaction
  double timeout_s;
  i64 node_limit;
};

struct ProbeOut {
  i64 nodes, exhaustive, fails, solutions, best;  // best: lb(obj) of the last solution
};

}  // extern "C"

namespace {

inline i64 clampv(i64 v) { return v < NINF ? NINF : (v > INF ? INF : v); }
inline i64 clip(i64 v, i64 lo, i64 hi) { return v < lo ? lo : (v > hi ? hi : v); }

// numpy floor_divide, and the ceiling as the oracle writes it.
inline i64 fdiv(i64 a, i64 b) {
  if (b == 1) return a;  // the usual coefficients, without a division
  if (b == -1) return -a;
  i64 q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}
inline i64 cdiv(i64 a, i64 b) { return -fdiv(-a, b); }
// Truncated division (deduce_np.tdiv).
inline i64 tdiv(i64 a, i64 b) { return a / b; }
// int64 product that wraps as numpy's does.
inline i64 wmul(i64 a, i64 b) {
  return static_cast<i64>(static_cast<uint64_t>(a) * static_cast<uint64_t>(b));
}

void inv_mul(i64 la, i64 ua, i64 lb, i64 ub, i64* lo, i64* hi) {
  if (lb <= 0 && ub >= 0) {
    *lo = NINF;
    *hi = INF;
    return;
  }
  // A store gone empty mid-sweep can hold lb > ub with a bound at 0:
  // the oracle divides by 1 and -1 there.
  const i64 as[2] = {la, ua}, bs[2] = {lb == 0 ? 1 : lb, ub == 0 ? -1 : ub};
  i64 l = 0, h = 0;
  bool first = true;
  for (i64 a : as)
    for (i64 b : bs) {
      i64 f = fdiv(a, b), c = cdiv(a, b);
      if (first || c < l) l = c;
      if (first || f > h) h = f;
      first = false;
    }
  *lo = l;
  *hi = h;
}

void fwd_div(i64 ly, i64 uy, i64 lz, i64 uz, i64* lo, i64* hi) {
  i64 l = INF, h = NINF;
  const i64 ys[2] = {ly, uy};
  if (lz <= -1) {
    const i64 zs[2] = {lz, std::min(uz, i64(-1))};
    for (i64 a : ys)
      for (i64 z : zs) {
        i64 q = tdiv(a, z);
        l = std::min(l, q);
        h = std::max(h, q);
      }
  }
  if (uz >= 1) {
    const i64 zs[2] = {std::max(lz, i64(1)), uz};
    for (i64 a : ys)
      for (i64 z : zs) {
        i64 q = tdiv(a, z);
        l = std::min(l, q);
        h = std::max(h, q);
      }
  }
  *lo = l;
  *hi = h;
}

inline i64 min4(i64 a, i64 b, i64 c, i64 d) { return std::min(std::min(a, b), std::min(c, d)); }
inline i64 max4(i64 a, i64 b, i64 c, i64 d) { return std::max(std::max(a, b), std::max(c, d)); }

// deduce_np.deduce for one row: c = (cxl, cxu, cyl, cyu, czl, czu).
template <int OP>
inline __attribute__((always_inline)) void deduce(i64 lx, i64 ux, i64 ly, i64 uy, i64 lz, i64 uz,
                                                  i64* c) {
  switch (OP) {
    case OP_ADD:
      c[0] = ly + lz; c[1] = uy + uz;
      c[2] = lx - uz; c[3] = ux - lz;
      c[4] = lx - uy; c[5] = ux - ly;
      break;
    case OP_MUL: {
      i64 p1 = ly * lz, p2 = ly * uz, p3 = uy * lz, p4 = uy * uz;
      c[0] = min4(p1, p2, p3, p4);
      c[1] = max4(p1, p2, p3, p4);
      inv_mul(lx, ux, lz, uz, &c[2], &c[3]);
      inv_mul(lx, ux, ly, uy, &c[4], &c[5]);
      break;
    }
    case OP_DIV: {
      fwd_div(ly, uy, lz, uz, &c[0], &c[1]);
      i64 mz = std::max(lz < 0 ? -lz : lz, uz < 0 ? -uz : uz);
      i64 p1 = lx * lz, p2 = lx * uz, p3 = ux * lz, p4 = ux * uz;
      i64 r = std::max(mz - 1, i64(0));
      c[2] = min4(p1, p2, p3, p4) - r;
      c[3] = max4(p1, p2, p3, p4) + r;
      c[4] = NINF; c[5] = INF;
      if (lz == 0 && uz == 0) { c[0] = INF; c[1] = NINF; }
      break;
    }
    case OP_MIN:
      c[0] = std::min(ly, lz); c[1] = std::min(uy, uz);
      c[2] = lx; c[3] = lz > ux ? ux : INF;
      c[4] = lx; c[5] = ly > ux ? ux : INF;
      break;
    case OP_MAX:
      c[0] = std::max(ly, lz); c[1] = std::max(uy, uz);
      c[3] = ux; c[2] = uz < lx ? lx : NINF;
      c[5] = ux; c[4] = uy < lx ? lx : NINF;
      break;
    case OP_LE: {
      c[0] = uy <= lz; c[1] = 1 - (ly > uz);
      bool tt = lx >= 1, ff = ux <= 0;
      c[2] = ff ? lz + 1 : NINF; c[3] = tt ? uz : INF;
      c[4] = tt ? ly : NINF;     c[5] = ff ? uy - 1 : INF;
      break;
    }
    default: {  // OP_EQ
      c[0] = (ly == uy) && (uy == lz) && (lz == uz);
      c[1] = std::max(ly, lz) <= std::min(uy, uz);
      bool tt = lx >= 1, ff = ux <= 0, zs = lz == uz, ys = ly == uy;
      c[2] = tt ? lz : ((ff && zs && lz == ly) ? ly + 1 : NINF);
      c[3] = tt ? uz : ((ff && zs && lz == uy) ? uy - 1 : INF);
      c[4] = tt ? ly : ((ff && ys && ly == lz) ? lz + 1 : NINF);
      c[5] = tt ? uy : ((ff && ys && ly == uz) ? uz - 1 : INF);
      break;
    }
  }
  for (int i = 0; i < 6; ++i) c[i] = clampv(c[i]);
}

// deduce_np.ask for one row.
bool ask(int op, i64 lx, i64 ux, i64 ly, i64 uy, i64 lz, i64 uz) {
  bool sing = lx == ux && ly == uy && lz == uz;
  switch (op) {
    case OP_ADD: return sing && lx == ly + lz;
    case OP_MUL: return sing && lx == ly * lz;
    case OP_DIV: return sing && lz != 0 && lx == tdiv(ly, lz == 0 ? 1 : lz);
    case OP_MIN: return sing && lx == std::min(ly, lz);
    case OP_MAX: return sing && lx == std::max(ly, lz);
    case OP_LE: return (lx >= 1 && uy <= lz) || (ux <= 0 && ly > uz);
    default:  // OP_EQ
      return (lx >= 1 && ly == uy && lz == uz && ly == lz) ||
             (ux <= 0 && (uy < lz || ly > uz));
  }
}

class Probe {
 public:
  explicit Probe(const ProbeIn& in)
      : in_(in), dirty_(in.G + 3), tmin_(in.K), tmax_(in.K) {
    // Rows are numbered ternary rows first (row r in PropTable's order),
    // then element, membership and linear rows; pass_[row] is the pass
    // that evaluates it (op group g, then G, G + 1, G + 2).
    const i64 R = in.P + in.E + in.M + in.L;
    pass_.resize(R);
    queued_.assign(R, 0);
    eq_.assign(R, 0);
    std::vector<std::vector<i64>> vars(R);
    for (i64 g = 0; g < in.G; ++g)
      for (i64 r = in.g_lo[g]; r < in.g_hi[g]; ++r) {
        pass_[r] = g;
        eq_[r] = in.g_op[g] == OP_EQ;
        vars[r] = {in.xs[r], in.ys[r], in.zs[r]};
      }
    for (i64 r = 0; r < in.E; ++r) {
      pass_[in.P + r] = in.G;
      vars[in.P + r] = {in.e_idx[r], in.e_res[r]};
    }
    for (i64 r = 0; r < in.M; ++r) {
      pass_[in.P + in.E + r] = in.G + 1;
      vars[in.P + in.E + r] = {in.m_x[r], in.m_b[r]};
    }
    for (i64 r = 0; r < in.L; ++r) {
      const i64 row = in.P + in.E + in.M + r;
      pass_[row] = in.G + 2;
      vars[row] = {in.l_b[r]};
      // A pad's coefficient is 0: its var moves no term of the row.
      for (i64 k = 0; k < in.K; ++k)
        if (in.l_coef[r * in.K + k] != 0) vars[row].push_back(in.l_var[r * in.K + k]);
    }
    // The rows of each var (CSR).
    adj_off_.assign(in.V + 1, 0);
    for (const auto& vs : vars)
      for (i64 v : vs) ++adj_off_[v + 1];
    for (i64 v = 0; v < in.V; ++v) adj_off_[v + 1] += adj_off_[v];
    adj_.resize(adj_off_[in.V]);
    std::vector<i64> fill(adj_off_.begin(), adj_off_.end() - 1);
    for (i64 row = 0; row < R; ++row)
      for (i64 v : vars[row]) adj_[fill[v]++] = row;
  }

  void run(ProbeOut* out) {
    const ProbeIn& in = in_;
    const i64 V = in.V, slot = 2 * V;
    const bool opt = in.obj_var >= 0;
    auto t0 = std::chrono::steady_clock::now();
    i64 nodes = 0, fails = 0, solutions = 0, exhaustive = 1, best = 0;
    i64 best_bound = INF + 1;
    // The DFS stack of unexplored stores, slot i at i * 2V (lb, ub), and
    // for each the var its branch narrowed (-1: the root, or a parent
    // that stopped at MAX_ITERS short of its fixpoint).
    std::vector<i64> stack(2 * slot), narrowed(2, -1);
    std::memcpy(stack.data(), in.lb0, V * sizeof(i64));
    std::memcpy(stack.data() + V, in.ub0, V * sizeof(i64));
    i64 n = 1;
    while (n > 0) {
      double el = std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
      if (el > in.timeout_s || nodes >= in.node_limit) {
        exhaustive = 0;
        break;
      }
      if (static_cast<i64>(stack.size()) < (n + 1) * slot) {
        stack.resize(2 * (n + 1) * slot);
        narrowed.resize(2 * (n + 1));
      }
      --n;
      i64* lb = stack.data() + n * slot;
      i64* ub = lb + V;
      // What differs from the parent's fixpoint: the narrowed var, and
      // the objective when its bound tightens here.
      begin_node(lb, ub, narrowed[n]);
      if (opt && best_bound <= INF && best_bound - 1 < ub[in.obj_var]) {
        ub[in.obj_var] = best_bound - 1;
        dirty(lb, ub, in.obj_var);
      }
      bool bot = propagate(lb, ub);
      ++nodes;
      if (bot) {
        ++fails;
        continue;
      }
      if (all_entailed(lb, ub)) {
        ++solutions;
        if (opt) {
          best_bound = best = lb[in.obj_var];
          continue;
        }
        exhaustive = 0;  // stop after the first solution
        break;
      }
      i64 var, valo;
      if (!select_var(lb, ub, &var, &valo)) {
        exhaustive = 0;  // unsplittable: infinite domains remain
        continue;
      }
      i64 lo = lb[var], hi = ub[var], mid = lo + (hi - lo) / 2;
      i64 c0l, c0u, c1l, c1u;
      switch (valo) {
        case 1: c0l = hi; c0u = hi; c1l = lo; c1u = hi - 1; break;
        case 2: c0l = lo; c0u = mid; c1l = mid + 1; c1u = hi; break;
        case 3: c0l = mid + 1; c0u = hi; c1l = lo; c1u = mid; break;
        default: c0l = lo; c0u = lo; c1l = lo + 1; c1u = hi; break;
      }
      // Right child in slot n, left child (explored first) in slot n + 1.
      i64* left = lb + slot;
      std::memcpy(left, lb, slot * sizeof(i64));
      lb[var] = std::max(lb[var], c1l);
      ub[var] = std::min(ub[var], c1u);
      left[var] = std::max(left[var], c0l);
      left[V + var] = std::min(left[V + var], c0u);
      narrowed[n] = narrowed[n + 1] = fixpoint_ ? var : -1;
      n += 2;
    }
    out->nodes = nodes;
    out->exhaustive = exhaustive;
    out->fails = fails;
    out->solutions = solutions;
    out->best = best;
  }

 private:
  // The fixpoint is the oracle's sweeps, with one shortcut that changes
  // no store: a pass evaluates only its rows with a var changed since
  // the row was last evaluated (the pass's dirty list). Another row's
  // candidates are a function of its vars' bounds and were met into the
  // store then, so they would meet nothing now. A child starts as if
  // every row had been evaluated at its parent's fixpoint (where every
  // row's candidates are met), with the narrowed vars changed since.

  void begin_node(const i64* lb, const i64* ub, i64 narrowed) {
    for (auto& d : dirty_) {  // a bot node leaves rows queued
      for (i64 row : d) queued_[row] = 0;
      d.clear();
    }
    bot_ = false;
    if (narrowed < 0) {
      for (i64 v = 0; v < in_.V; ++v) dirty(lb, ub, v);
    } else {
      dirty(lb, ub, narrowed);
    }
  }

  // Queues var v's rows after a change of v, but an EQ row in which
  // nothing can tighten (quiet). A row left out has every change of its
  // vars since its last evaluation checked so, the last with the bounds
  // it has now: evaluated, it would meet nothing.
  void dirty(const i64* lb, const i64* ub, i64 v) {
    bot_ |= lb[v] > ub[v];
    for (i64 i = adj_off_[v]; i < adj_off_[v + 1]; ++i) {
      const i64 row = adj_[i];
      if (queued_[row] || (eq_[row] && quiet_eq(lb, ub, row))) continue;
      queued_[row] = 1;
      dirty_[pass_[row]].push_back(row);
    }
  }

  // x = (y == z) fixed false, neither y nor z fixed, all inside [NINF,
  // INF]: deduce gives x [0, 1] or [0, 0] and y, z [NINF, INF], so none
  // of the row's candidates tightens the store.
  bool quiet_eq(const i64* lb, const i64* ub, i64 r) const {
    const i64 x = in_.xs[r], y = in_.ys[r], z = in_.zs[r];
    return lb[x] == 0 && ub[x] == 0 && lb[y] != ub[y] && lb[z] != ub[z] && lb[y] >= NINF &&
           ub[y] <= INF && lb[z] >= NINF && ub[z] <= INF;
  }

  // Queues a candidate interval that tightens var v's bounds as the
  // pass found them.
  inline void offer(const i64* lb, const i64* ub, i64 v, i64 lo, i64 hi) {
    if (lo > lb[v] || hi < ub[v]) pend_.push_back({v, lo, hi});
  }

  // Takes pass p's dirty rows into work_ (their evaluation reads the
  // store as the pass found it: Jacobi).
  const std::vector<i64>& take(i64 p) {
    work_.swap(dirty_[p]);
    dirty_[p].clear();
    for (i64 row : work_) queued_[row] = 0;
    return work_;
  }

  // Meets the pass's queued candidates into the store (their order does
  // not matter: meets commute); true when one tightened.
  bool apply(i64* lb, i64* ub) {
    bool ch = false;
    for (const Meet& m : pend_) {
      bool c = false;
      if (m.lo > lb[m.v]) { lb[m.v] = m.lo; c = true; }
      if (m.hi < ub[m.v]) { ub[m.v] = m.hi; c = true; }
      if (c) {
        dirty(lb, ub, m.v);
        ch = true;
      }
    }
    pend_.clear();
    return ch;
  }

  // PropTable.propagate: AC-1 to the fixpoint in place; true on bot.
  // Each pass reads the store as it was before the pass (Jacobi).
  bool propagate(i64* lb, i64* ub) {
    const ProbeIn& in = in_;
    fixpoint_ = false;
    for (int it = 0; it < MAX_ITERS; ++it) {
      bool changed = false;
      for (i64 g = 0; g < in.G; ++g) {
        switch (in.g_op[g]) {
          case OP_ADD: op_pass<OP_ADD>(lb, ub, g); break;
          case OP_MUL: op_pass<OP_MUL>(lb, ub, g); break;
          case OP_DIV: op_pass<OP_DIV>(lb, ub, g); break;
          case OP_MIN: op_pass<OP_MIN>(lb, ub, g); break;
          case OP_MAX: op_pass<OP_MAX>(lb, ub, g); break;
          case OP_LE: op_pass<OP_LE>(lb, ub, g); break;
          default: op_pass<OP_EQ>(lb, ub, g); break;
        }
        changed |= apply(lb, ub);
      }
      element_pass(lb, ub);
      changed |= apply(lb, ub);
      member_pass(lb, ub);
      changed |= apply(lb, ub);
      linear_pass(lb, ub);
      changed |= apply(lb, ub);
      if (bot_) return true;
      if (!changed) {
        fixpoint_ = true;
        return false;
      }
    }
    return bot_;
  }

  template <int OP>
  void op_pass(const i64* lb, const i64* ub, i64 g) {
    const i64* __restrict xs = in_.xs;
    const i64* __restrict ys = in_.ys;
    const i64* __restrict zs = in_.zs;
    for (i64 r : take(g)) {
      const i64 x = xs[r], y = ys[r], z = zs[r];
      i64 c[6];
      deduce<OP>(lb[x], ub[x], lb[y], ub[y], lb[z], ub[z], c);
      offer(lb, ub, x, c[0], c[1]);
      offer(lb, ub, y, c[2], c[3]);
      offer(lb, ub, z, c[4], c[5]);
    }
  }

  // PropTable._element_cands.
  void element_pass(const i64* lb, const i64* ub) {
    const ProbeIn& in = in_;
    const i64 T = in.T;
    for (i64 row : take(in.G)) {
      const i64 r = row - in.P, xi = in.e_idx[r], xr = in.e_res[r];
      i64 li = lb[xi], ui = ub[xi], lr = lb[xr], ur = ub[xr];
      const i64* tab = in.e_tab + r * T;
      // The extremes over every column, INF / NINF where not ok, as
      // numpy's masked min and max take them.
      bool any = false;
      i64 first = 0, last = 0, rmin = 0, rmax = 0;
      for (i64 j = 0; j < T; ++j) {
        bool ok = j >= li - 1 && j <= ui - 1 && j < in.e_len[r] && tab[j] >= lr && tab[j] <= ur;
        i64 a = ok ? tab[j] : INF, b = ok ? tab[j] : NINF;
        rmin = j == 0 ? a : std::min(rmin, a);
        rmax = j == 0 ? b : std::max(rmax, b);
        if (!ok) continue;
        if (!any) first = j;
        last = j;
        any = true;
      }
      offer(lb, ub, xi, any ? first + 1 : INF, any ? last + 1 : NINF);
      offer(lb, ub, xr, any ? rmin : INF, any ? rmax : NINF);
    }
  }

  bool element_ask(const i64* lb, const i64* ub, i64 r) const {
    const ProbeIn& in = in_;
    i64 len = in.e_len[r];
    i64 li = clip(lb[in.e_idx[r]], 1, len), ui = clip(ub[in.e_idx[r]], 1, len);
    i64 lr = lb[in.e_res[r]], ur = ub[in.e_res[r]];
    const i64* tab = in.e_tab + r * in.T;
    i64 tmin = 0, tmax = 0;
    for (i64 j = 0; j < in.T; ++j) {
      bool w = j >= li - 1 && j <= ui - 1 && j < len;
      i64 a = w ? tab[j] : INF, b = w ? tab[j] : NINF;
      tmin = j == 0 ? a : std::min(tmin, a);
      tmax = j == 0 ? b : std::max(tmax, b);
    }
    return lr == ur && tmin == lr && tmax == lr;
  }

  // Count of set members in [lx, ux] (PropTable's prefix counts).
  i64 member_count(i64 r, i64 lx, i64 ux) const {
    const i64 W = in_.W, base = in_.m_base[r];
    i64 wl = clip(lx - base, 0, W), wh = clip(ux - base + 1, 0, W);
    const i64* cnt = in_.m_cnt + r * (W + 1);
    return cnt[wh] - cnt[wl];
  }

  // PropTable._member_cands.
  void member_pass(const i64* lb, const i64* ub) {
    const ProbeIn& in = in_;
    const i64 W = in.W;
    for (i64 row : take(in.G + 1)) {
      const i64 r = row - in.P - in.E, vx = in.m_x[r], vb = in.m_b[r];
      i64 lx = lb[vx], ux = ub[vx];
      i64 base = in.m_base[r], top = in.m_top[r];
      i64 c = member_count(r, lx, ux), width = ux - lx + 1;
      bool tt = lb[vb] >= 1, ff = ub[vb] <= 0;
      i64 wl = clip(lx - base, 0, W - 1), wh = clip(ux - base, 0, W - 1);
      i64 nge = lx > top ? INF : in.m_next_ge[r * W + wl];
      i64 ple = ux < base ? NINF : in.m_prev_le[r * W + wh];
      i64 nout = (lx >= base && lx <= top) ? in.m_next_out[r * W + wl] : lx;
      i64 pout = (ux >= base && ux <= top) ? in.m_prev_out[r * W + wh] : ux;
      offer(lb, ub, vx, clampv(tt ? nge : (ff ? nout : NINF)), clampv(tt ? ple : (ff ? pout : INF)));
      offer(lb, ub, vb, c == width && width > 0, c > 0);
    }
  }

  bool member_ask(const i64* lb, const i64* ub, i64 r) const {
    const ProbeIn& in = in_;
    i64 lx = lb[in.m_x[r]], ux = ub[in.m_x[r]];
    i64 c = member_count(r, lx, ux), width = ux - lx + 1;
    return (lb[in.m_b[r]] >= 1 && c == width && width > 0) || (ub[in.m_b[r]] <= 0 && c == 0);
  }

  // PropTable._linear_sums for row r: the clamped terms in tmin_/tmax_
  // and their sums.
  void linear_sums(const i64* lb, const i64* ub, i64 r, i64* smin, i64* smax) {
    const i64 K = in_.K;
    i64 s0 = 0, s1 = 0;
    for (i64 k = 0; k < K; ++k) {
      i64 c = in_.l_coef[r * K + k], v = in_.l_var[r * K + k];
      i64 a = wmul(c, lb[v]), b = wmul(c, ub[v]);
      tmin_[k] = clip(std::min(a, b), -SUM_CLAMP, SUM_CLAMP);
      tmax_[k] = clip(std::max(a, b), -SUM_CLAMP, SUM_CLAMP);
      s0 += tmin_[k];
      s1 += tmax_[k];
    }
    *smin = s0;
    *smax = s1;
  }

  // PropTable._linear_cands (the pads' vars included, as numpy meets
  // them).
  void linear_pass(const i64* lb, const i64* ub) {
    const ProbeIn& in = in_;
    const i64 K = in.K;
    for (i64 row : take(in.G + 2)) {
      const i64 r = row - in.P - in.E - in.M;
      const i64* vars = in.l_var + r * K;
      i64 smin, smax;
      linear_sums(lb, ub, r, &smin, &smax);
      const i64 rhs = in.l_rhs[r];
      const bool is_eq = in.l_op[r] == 1;
      const bool tt = lb[in.l_b[r]] >= 1, ff = ub[in.l_b[r]] <= 0;
      const bool ge_act = (is_eq && tt) || (!is_eq && ff), le_act = tt;
      const i64 rhs2 = is_eq ? rhs : rhs + 1;
      for (i64 k = 0; k < K; ++k) {
        const i64 c = in.l_coef[r * K + k];
        const bool live = c != 0, cpos = c > 0;
        const i64 cs = live ? c : 1;
        const i64 R = rhs - (smin - tmin_[k]);
        const i64 R2 = rhs2 - (smax - tmax_[k]);
        i64 th = (live && le_act && cpos) ? fdiv(R, cs) : INF;
        th = std::min(th, (live && ge_act && !cpos) ? fdiv(R2, cs) : INF);
        i64 tl = (live && le_act && !cpos) ? cdiv(R, cs) : NINF;
        tl = std::max(tl, (live && ge_act && cpos) ? cdiv(R2, cs) : NINF);
        offer(lb, ub, vars[k], clampv(tl), clampv(th));
      }
      offer(lb, ub, in.l_b[r],
            is_eq ? (smin == rhs && smax == rhs) : smax <= rhs,
            is_eq ? (smin <= rhs && rhs <= smax) : smin <= rhs);
    }
  }

  bool linear_ask(const i64* lb, const i64* ub, i64 r) {
    const ProbeIn& in = in_;
    i64 smin, smax;
    linear_sums(lb, ub, r, &smin, &smax);
    const i64 rhs = in.l_rhs[r];
    const bool is_eq = in.l_op[r] == 1;
    const bool tt = lb[in.l_b[r]] >= 1, ff = ub[in.l_b[r]] <= 0;
    bool ent_t = is_eq ? (smin == rhs && smax == rhs) : smax <= rhs;
    bool ent_f = is_eq ? (rhs < smin || rhs > smax) : smin > rhs;
    return (tt && ent_t) || (ff && ent_f);
  }

  bool entailed(const i64* lb, const i64* ub, i64 row) {
    const ProbeIn& in = in_;
    const i64 p = pass_[row];
    if (p < in.G) {
      const i64 x = in.xs[row], y = in.ys[row], z = in.zs[row];
      return ask(static_cast<int>(in.g_op[p]), lb[x], ub[x], lb[y], ub[y], lb[z], ub[z]);
    }
    if (p == in.G) return element_ask(lb, ub, row - in.P);
    if (p == in.G + 1) return member_ask(lb, ub, row - in.P - in.E);
    return linear_ask(lb, ub, row - in.P - in.E - in.M);
  }

  // PropTable.all_entailed: every row entailed. The row that was not
  // entailed last time is asked first; the answer is the same in any
  // order.
  bool all_entailed(const i64* lb, const i64* ub) {
    const i64 R = static_cast<i64>(pass_.size());
    if (R == 0) return true;
    if (!entailed(lb, ub, last_open_)) return false;
    for (i64 row = 0; row < R; ++row)
      if (!entailed(lb, ub, row)) {
        last_open_ = row;
        return false;
      }
    return true;
  }

  // oracle.select_var: the first strategy with a splittable var; in it
  // the var of least split_key, the first position on ties.
  bool select_var(const i64* lb, const i64* ub, i64* var, i64* valo) const {
    const ProbeIn& in = in_;
    for (i64 s = 0; s < in.S; ++s) {
      const bool all = in.s_len[s] < 0;
      const i64 n = all ? in.V : in.s_len[s];
      const i64* ids = in.s_ids + in.s_off[s];
      const i64 vo = in.s_vo[s];
      i64 best_pos = -1, best_key = 0;
      for (i64 p = 0; p < n; ++p) {
        const i64 v = all ? p : ids[p];
        const i64 l = lb[v], u = ub[v];
        if (!(l < u && l > NINF && u < INF)) continue;
        i64 key;
        switch (vo) {
          case 0: key = p; break;
          case 1: key = u - l; break;
          case 2: key = -(u - l); break;
          case 3: key = l; break;
          default: key = -u; break;
        }
        if (best_pos < 0 || key < best_key) {
          best_pos = p;
          best_key = key;
        }
      }
      if (best_pos >= 0) {
        *var = all ? best_pos : ids[best_pos];
        *valo = in.s_valo[s];
        return true;
      }
    }
    return false;
  }

  struct Meet {
    i64 v, lo, hi;
  };

  const ProbeIn& in_;
  std::vector<std::vector<i64>> dirty_;  // each pass's rows to evaluate
  std::vector<i64> work_, pass_, adj_off_, adj_, tmin_, tmax_;
  std::vector<char> queued_;  // the row is on its pass's dirty list
  std::vector<char> eq_;      // the row is an EQ row
  std::vector<Meet> pend_;
  i64 last_open_ = 0;  // the row all_entailed last found not entailed
  bool bot_ = false, fixpoint_ = false;
};

}  // namespace

extern "C" int tp_probe(const ProbeIn* in, ProbeOut* out) {
  try {
    Probe(*in).run(out);
  } catch (...) {  // std::bad_alloc: the caller falls back to the oracle
    return 1;
  }
  return 0;
}
