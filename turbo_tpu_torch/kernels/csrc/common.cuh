// Shared device code of the solver kernels (fixpoint.cu, wac1.cu,
// classify.cuh and select.cuh use all of it; embed.cu and open_count.cu
// only the block size): the plan tables as one struct passed by
// value, and the per-propagator rules of
// turbo_tpu/solver/propagate_jax.py written for one thread. The rules
// read a dive's store through ``lb[v]`` / ``ub[v]``: a plain pointer
// (shared memory, or a (D, V) row) or a ``Plane`` (a strided column of
// (V, D) planes).
//
// Arithmetic follows the JAX package bit for bit: store values and
// TNF add/min/max/le/eq candidates are int32 with two's-complement
// wrap (done through unsigned arithmetic, which C++ defines); mul/div
// and linear sums are int64; every candidate is clamped to
// [NINF, INF] before it is narrowed to int32.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define TT_INF 1073741823
#define TT_NINF (-1073741823)
#define TT_SUM_CLAMP (1LL << 40)
#define TT_THREADS 256
// slot_tgt codes: a slot aimed at the singleton tail is folded against
// the fixed value conf_off[k] (which slot_tgt carries beside the code);
// a slot nothing reads is dropped.
#define TT_UNREAD (-1)
#define TT_CONF(k) (-2 - (k))

enum { OP_ADD = 0, OP_MUL = 1, OP_DIV = 2, OP_MIN = 3, OP_MAX = 4,
       OP_LE = 5, OP_EQ = 6 };

// cudaFuncSetAttribute holds per device, so a launch wrapper's record of
// the dynamic shared memory it raised a kernel's attribute to is kept per
// device: ``attr_slot(table)`` is the current device's row of a static
// table [TT_MAX_DEVICES][n], each entry the bytes set plus one (0: not
// set yet), or nullptr when the device cannot be read or lies beyond the
// table (cudaErrorInvalidDevice goes to *err).
#define TT_MAX_DEVICES 64
template <int N>
static int* attr_slot(int (*table)[N], cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return nullptr;
  if (dev < 0 || dev >= TT_MAX_DEVICES) {
    *err = cudaErrorInvalidDevice;
    return nullptr;
  }
  return table[dev];
}

// A launch's own span in a profiled chunk (solver/step_cuda.py), the
// time between launches left out: the first block's start and the last
// block's end on the global timer (ns), thread 0 of each block
// taking the atomic min into span[0] and, after the block's last
// barrier, the atomic max into span[1] (the host sets them to INT64_MAX
// and 0). The timed entries wrap a kernel's body in the two: span_end's
// barrier is the block's last, so a body may return early only where
// no barrier follows for the threads that go on.
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void span_begin(long long* span) {
  if (threadIdx.x == 0)
    atomicMin((unsigned long long*)span, global_ns());
}

__device__ __forceinline__ void span_end(long long* span) {
  __syncthreads();
  if (threadIdx.x == 0)
    atomicMax((unsigned long long*)span + 1, global_ns());
}

// Device tables of one plan (see kernels/__init__.py: KernelPlan).
// Candidate slots: [3P roles | E idx | E res | M x | M b | linear terms
// | linear b], the layout of solver/plan.py.
struct PlanView {
  int V, P;
  int G;
  const int* g_off;     // (G + 1,) op-groups as slices [g_off[g], g_off[g+1])
  int E, T;
  const int* e_idx;     // (E,)
  const int* e_res;
  const int* e_len;
  const int* e_tab;     // (E, T)
  int M, W;
  const int* m_x;       // (M,)
  const int* m_b;
  const int* m_base;
  const int* m_top;
  const int* m_cnt;     // (M, W + 1) prefix counts
  const int* m_next_ge; // (M, W)
  const int* m_prev_le;
  const int* m_next_out;
  const int* m_prev_out;
  int L, base_lin, base_linb;
  const long long* l_rhs; // (L,)
  const int4* l_head;   // (L,) packed: (flags | op << 2, first term, K, b);
                        // flags bit 0: unit coefficients, bit 1: fit32;
                        // op 1: eq
  const int2* l_term;   // (terms,) packed: (coef, var)
  int LB;
  const int* lb_off;    // (LB + 1,) linear buckets as row slices
  const int2* slot_tgt; // (n_cand,) K1's routing of a slot: (its target var,
                        // 0), (TT_CONF(k), conf_off[k]) or (TT_UNREAD, 0)
  const int4* tnf4;     // (P,) the TNF propagators in group order: (op, x,
                        // y, z)
  const int* lb_floor;  // (V,) lb0 - 1
  const int* ub_cap;    // (V,) ub0 + 1
  const unsigned* v_pass; // (V,) K8: bit s set when pass s reads the var
                          // (passes: the G op-groups, the element rows,
                          // the membership rows, the LB linear buckets;
                          // pass 31 and above share bit 31)
  const int* v_roff;    // (V + 1,) K8: the rules that read var v are
  const int* v_rule;    // v_rule[v_roff[v]:v_roff[v + 1]], numbered TNF
                        // [0, P), element, membership, linear rows
  int S;
  const int* s_off;     // (S + 1,) strategy ranges in s_ids
  const int* s_ids;
  const int* s_vo;      // (S,) var order code
  const int* s_valo;    // (S,) value order code
};

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int sub32(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int mul32(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ long long fdiv64(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}
__device__ __forceinline__ long long cdiv64(long long a, long long b) {
  return -fdiv64(-a, b);
}
// jnp _tdiv: floor, then +1 on a nonzero remainder of mixed signs,
// which is C's truncating division (b != 0).
__device__ __forceinline__ long long tdiv64(long long a, long long b) {
  return a / b;
}
__device__ __forceinline__ int clip32(long long v) {
  return (int)(v < TT_NINF ? TT_NINF : (v > TT_INF ? TT_INF : v));
}
__device__ __forceinline__ long long lmin(long long a, long long b) {
  return a < b ? a : b;
}
__device__ __forceinline__ long long lmax(long long a, long long b) {
  return a > b ? a : b;
}

// x = y op z: candidate intervals for the three roles
// (propagate_jax._deduce_group, deduce_np.deduce).
__device__ __forceinline__ void deduce(int op, int lx, int ux, int ly, int uy,
                                       int lz, int uz, int* c) {
  long long xl, xu, yl, yu, zl, zu;
  switch (op) {
    case OP_ADD:
      xl = add32(ly, lz); xu = add32(uy, uz);
      yl = sub32(lx, uz); yu = sub32(ux, lz);
      zl = sub32(lx, uy); zu = sub32(ux, ly);
      break;
    case OP_MUL: {
      long long p1 = (long long)ly * lz, p2 = (long long)ly * uz;
      long long p3 = (long long)uy * lz, p4 = (long long)uy * uz;
      xl = lmin(lmin(p1, p2), lmin(p3, p4));
      xu = lmax(lmax(p1, p2), lmax(p3, p4));
      // _inv_mul(a = x, b = z) for y, (a = x, b = y) for z.
      for (int r = 0; r < 2; ++r) {
        long long lb_ = r == 0 ? lz : ly, ub_ = r == 0 ? uz : uy;
        bool has0 = lb_ <= 0 && ub_ >= 0;
        long long sb = lb_ == 0 ? 1 : lb_, tb = ub_ == 0 ? -1 : ub_;
        long long lo = cdiv64(lx, sb), hi = fdiv64(lx, sb);
        lo = lmin(lo, cdiv64(lx, tb)); hi = lmax(hi, fdiv64(lx, tb));
        lo = lmin(lo, cdiv64(ux, sb)); hi = lmax(hi, fdiv64(ux, sb));
        lo = lmin(lo, cdiv64(ux, tb)); hi = lmax(hi, fdiv64(ux, tb));
        if (has0) { lo = TT_NINF; hi = TT_INF; }
        if (r == 0) { yl = lo; yu = hi; } else { zl = lo; zu = hi; }
      }
      break;
    }
    case OP_DIV: {
      // _fwd_div: hull of trunc(y / z) over z != 0.
      long long lo = TT_INF, hi = TT_NINF;
      for (int part = 0; part < 2; ++part) {
        bool valid = part == 0 ? lz <= -1 : uz >= 1;
        long long plo = part == 0 ? lz : (lz > 1 ? lz : 1);
        long long phi = part == 0 ? (uz < -1 ? uz : -1) : uz;
        if (!valid) continue;
        long long ys[2] = {ly, uy}, zs[2] = {plo, phi};
        for (int i = 0; i < 2; ++i)
          for (int j = 0; j < 2; ++j) {
            long long q = tdiv64(ys[i], zs[j]);
            lo = lmin(lo, q); hi = lmax(hi, q);
          }
      }
      xl = lo; xu = hi;
      if (lz == 0 && uz == 0) { xl = TT_INF; xu = TT_NINF; }
      long long alz = lz < 0 ? -(long long)lz : lz;
      long long auz = uz < 0 ? -(long long)uz : uz;
      long long pad = lmax(lmax(alz, auz) - 1, 0);
      long long p1 = (long long)lx * lz, p2 = (long long)lx * uz;
      long long p3 = (long long)ux * lz, p4 = (long long)ux * uz;
      yl = lmin(lmin(p1, p2), lmin(p3, p4)) - pad;
      yu = lmax(lmax(p1, p2), lmax(p3, p4)) + pad;
      zl = TT_NINF; zu = TT_INF;
      break;
    }
    case OP_MIN:
      xl = ly < lz ? ly : lz; xu = uy < uz ? uy : uz;
      yl = lx; yu = lz > ux ? ux : TT_INF;
      zl = lx; zu = ly > ux ? ux : TT_INF;
      break;
    case OP_MAX:
      xl = ly > lz ? ly : lz; xu = uy > uz ? uy : uz;
      yu = ux; yl = uz < lx ? lx : TT_NINF;
      zu = ux; zl = uy < lx ? lx : TT_NINF;
      break;
    case OP_LE: {
      bool tt = lx >= 1, ff = ux <= 0;
      xl = uy <= lz; xu = 1 - (ly > uz);
      yl = ff ? add32(lz, 1) : TT_NINF; yu = tt ? uz : TT_INF;
      zl = tt ? ly : TT_NINF; zu = ff ? sub32(uy, 1) : TT_INF;
      break;
    }
    default: {  // OP_EQ
      bool tt = lx >= 1, ff = ux <= 0;
      bool zsing = lz == uz, ysing = ly == uy;
      xl = ly == uy && uy == lz && lz == uz;
      xu = (ly > lz ? ly : lz) <= (uy < uz ? uy : uz);
      yl = tt ? lz : (ff && zsing && lz == ly ? add32(ly, 1) : TT_NINF);
      yu = tt ? uz : (ff && zsing && lz == uy ? sub32(uy, 1) : TT_INF);
      zl = tt ? ly : (ff && ysing && ly == lz ? add32(lz, 1) : TT_NINF);
      zu = tt ? uy : (ff && ysing && ly == uz ? sub32(uz, 1) : TT_INF);
      break;
    }
  }
  c[0] = clip32(xl); c[1] = clip32(xu);
  c[2] = clip32(yl); c[3] = clip32(yu);
  c[4] = clip32(zl); c[5] = clip32(zu);
}

// Entailment of x = y op z (propagate_jax._ask_group).
__device__ __forceinline__ bool ask(int op, int lx, int ux, int ly, int uy,
                                    int lz, int uz) {
  bool sing = lx == ux && ly == uy && lz == uz;
  switch (op) {
    case OP_ADD: return sing && lx == add32(ly, lz);
    case OP_MUL: return sing && (long long)lx == (long long)ly * lz;
    case OP_DIV: return sing && lz != 0 && (long long)lx == tdiv64(ly, lz);
    case OP_MIN: return sing && lx == (ly < lz ? ly : lz);
    case OP_MAX: return sing && lx == (ly > lz ? ly : lz);
    case OP_LE: return (lx >= 1 && uy <= lz) || (ux <= 0 && ly > uz);
    default:
      return (lx >= 1 && ly == uy && lz == uz && ly == lz) ||
             (ux <= 0 && (uy < lz || ly > uz));
  }
}

// Copies one dive's rows (lb, ub: V int32 each, in global memory) into
// shared memory (sl, su) in one coalesced pass, 16 bytes a thread where
// the rows' alignment and V allow it. The caller synchronises.
__device__ __forceinline__ void stage_store(const int* lb, const int* ub,
                                            int* sl, int* su, int V) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(lb) |
                               reinterpret_cast<unsigned long long>(ub) |
                               reinterpret_cast<unsigned long long>(su);
  if (V % 4 == 0 && (a & 15) == 0) {
    const int4* l4 = reinterpret_cast<const int4*>(lb);
    const int4* u4 = reinterpret_cast<const int4*>(ub);
    for (int i = threadIdx.x; i < V / 4; i += blockDim.x) {
      reinterpret_cast<int4*>(sl)[i] = __ldg(l4 + i);
      reinterpret_cast<int4*>(su)[i] = __ldg(u4 + i);
    }
  } else {
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      sl[v] = __ldg(lb + v);
      su[v] = __ldg(ub + v);
    }
  }
}

// One linear term's min/max contribution: int32 products under fit32
// (no clamp), else int64 clamped to +-SUM_CLAMP.
__device__ __forceinline__ void lin_term(bool fit32, int c, int xl, int xu,
                                         long long* tmin, long long* tmax) {
  if (fit32) {
    int a = mul32(c, xl), b = mul32(c, xu);
    *tmin = a < b ? a : b;
    *tmax = a > b ? a : b;
  } else {
    long long a = (long long)c * xl, b = (long long)c * xu;
    long long lo = lmin(a, b), hi = lmax(a, b);
    *tmin = lmax(-TT_SUM_CLAMP, lmin(lo, TT_SUM_CLAMP));
    *tmax = lmax(-TT_SUM_CLAMP, lmin(hi, TT_SUM_CLAMP));
  }
}

// One dive's bound plane inside (V, D) planes: element v at p[v * s].
struct Plane {
  int* p;
  long long s;
  __device__ __forceinline__ int& operator[](int v) const { return p[v * s]; }
};

// A linear row's header h = (flags | op << 2, first term, K, b): one
// 16-byte load, then its terms (coef, var) 8 bytes each.
template <class S>
__device__ __forceinline__ void lin_sums(const PlanView& p, int4 h,
                                         const S& lb, const S& ub,
                                         long long* smin, long long* smax) {
  bool fit32 = h.x & 2;
  long long s0 = 0, s1 = 0;
  for (int t = 0; t < h.z; ++t) {
    const int2 c = __ldg(p.l_term + h.y + t);
    long long a, b;
    lin_term(fit32, c.x, lb[c.y], ub[c.y], &a, &b);
    s0 += a; s1 += b;
  }
  *smin = s0; *smax = s1;
}

// Reified linear row: b = (sum c*x <op> rhs) (_linear_ask_all).
__device__ __forceinline__ bool lin_ask(const PlanView& p, int r,
                                        const int* lb, const int* ub) {
  const int4 h = __ldg(p.l_head + r);
  long long smin, smax;
  lin_sums(p, h, lb, ub, &smin, &smax);
  long long rhs = __ldg(p.l_rhs + r);
  bool is_eq = (h.x >> 2) == 1;
  bool tt = lb[h.w] >= 1, ff = ub[h.w] <= 0;
  bool ent_t = is_eq ? (smin == rhs && smax == rhs) : (smax <= rhs);
  bool ent_f = is_eq ? (rhs < smin || rhs > smax) : (smin > rhs);
  return (tt && ent_t) || (ff && ent_f);
}

// Element row i: values[idx - 1] == res (_element_ask).
__device__ __forceinline__ bool elem_ask(const PlanView& p, int i,
                                         const int* lb, const int* ub) {
  int len = __ldg(p.e_len + i);
  const int x = __ldg(p.e_idx + i), res = __ldg(p.e_res + i);
  int li = lb[x], ui = ub[x];
  li = li < 1 ? 1 : li; li = li > len ? len : li;
  ui = ui < 1 ? 1 : ui; ui = ui > len ? len : ui;
  int lr = lb[res], ur = ub[res];
  int tmin = TT_INF, tmax = TT_NINF;
  const int* tab = p.e_tab + (long long)i * p.T;
  for (int j = 0; j < p.T; ++j) {
    if (j >= li - 1 && j <= ui - 1 && j < len) {
      const int v = __ldg(tab + j);
      tmin = v < tmin ? v : tmin;
      tmax = v > tmax ? v : tmax;
    }
  }
  return lr == ur && tmin == lr && tmax == lr;
}

// Membership row i: window count of the set's members in [lx, ux].
__device__ __forceinline__ int member_count(const PlanView& p, int i, int lx,
                                            int ux) {
  int W = p.W, base = __ldg(p.m_base + i);
  int wl = sub32(lx, base), wh = add32(sub32(ux, base), 1);
  wl = wl < 0 ? 0 : (wl > W ? W : wl);
  wh = wh < 0 ? 0 : (wh > W ? W : wh);
  const int* cnt = p.m_cnt + (long long)i * (W + 1);
  return __ldg(cnt + wh) - __ldg(cnt + wl);
}

__device__ __forceinline__ bool member_ask(const PlanView& p, int i,
                                           const int* lb, const int* ub) {
  const int x = __ldg(p.m_x + i), b = __ldg(p.m_b + i);
  int lx = lb[x], ux = ub[x];
  int c = member_count(p, i, lx, ux);
  long long width = (long long)ux - lx + 1;
  return (lb[b] >= 1 && c == width && width > 0) || (ub[b] <= 0 && c == 0);
}

// -- candidates of one row: each rule hands (slot, var, lo, hi) for the
// slots of solver/plan.py and their target variables to ``out``: K1
// meets them into its store routed by the slot (fixpoint.cu), K8 by the
// variable (wac1.cu). The TNF propagators are evaluated inline by both,
// from ``tnf4`` -------------------------------------------------------

// Element row i: windowed min/max of the result, first/last feasible
// index (_element_cands).
template <class S, class Out>
__device__ __forceinline__ void cand_elem(const PlanView& p, int i,
                                          const S& lb, const S& ub,
                                          const Out& out) {
  int len = __ldg(p.e_len + i);
  const int x = __ldg(p.e_idx + i), res = __ldg(p.e_res + i);
  int li = lb[x], ui = ub[x];
  int lr = lb[res], ur = ub[res];
  int jlo = TT_INF - 1, jhi = TT_NINF - 1, rlo = TT_INF, rhi = TT_NINF;
  const int* tab = p.e_tab + (long long)i * p.T;
  int wlo = sub32(li, 1), whi = sub32(ui, 1);
  for (int j = 0; j < p.T; ++j) {
    int v = __ldg(tab + j);
    if (j >= wlo && j <= whi && j < len && v >= lr && v <= ur) {
      jlo = j < jlo ? j : jlo; jhi = j > jhi ? j : jhi;
      rlo = v < rlo ? v : rlo; rhi = v > rhi ? v : rhi;
    }
  }
  int s = 3 * p.P + i;
  out(s, x, jlo + 1, jhi + 1);
  out(s + p.E, res, rlo, rhi);
}

// Reified sparse membership row i (_member_cands).
template <class S, class Out>
__device__ __forceinline__ void cand_member(const PlanView& p, int i,
                                            const S& lb, const S& ub,
                                            const Out& out) {
  int W = p.W, base = __ldg(p.m_base + i), top = __ldg(p.m_top + i);
  const int x = __ldg(p.m_x + i), b = __ldg(p.m_b + i);
  int lx = lb[x], ux = ub[x];
  int c = member_count(p, i, lx, ux);
  long long width = (long long)ux - lx + 1;
  int b_lo = c == width && width > 0, b_hi = c > 0;
  int wl = sub32(lx, base), wh = sub32(ux, base);
  wl = wl < 0 ? 0 : (wl > W - 1 ? W - 1 : wl);
  wh = wh < 0 ? 0 : (wh > W - 1 ? W - 1 : wh);
  long long row = (long long)i * W;
  int nge = lx > top ? TT_INF : __ldg(p.m_next_ge + row + wl);
  int ple = ux < base ? TT_NINF : __ldg(p.m_prev_le + row + wh);
  int nout = lx >= base && lx <= top ? __ldg(p.m_next_out + row + wl) : lx;
  int pout = ux >= base && ux <= top ? __ldg(p.m_prev_out + row + wh) : ux;
  bool tt = lb[b] >= 1, ff = ub[b] <= 0;
  int x_lo = tt ? nge : (ff ? nout : TT_NINF);
  int x_hi = tt ? ple : (ff ? pout : TT_INF);
  int s = 3 * p.P + 2 * p.E + i;
  out(s, x, clip32(x_lo), clip32(x_hi));
  out(s + p.M, b, b_lo, b_hi);
}

// Reified linear row r: sum bounds, then per-term floor/ceil candidates
// (_linear_bucket_cands). A padding term (coefficient 0) hands nothing
// for its slot: no reader looks at it.
template <class S, class Out>
__device__ __forceinline__ void cand_linear(const PlanView& p, int r,
                                            const S& lb, const S& ub,
                                            const Out& out) {
  const int4 h = __ldg(p.l_head + r);
  bool unit = h.x & 1, fit32 = h.x & 2;
  long long smin, smax;
  lin_sums(p, h, lb, ub, &smin, &smax);
  long long rhs = __ldg(p.l_rhs + r);
  bool is_eq = (h.x >> 2) == 1;
  out(p.base_linb + r, h.w,
      is_eq ? (smin == rhs && smax == rhs) : (smax <= rhs),
      is_eq ? (smin <= rhs && rhs <= smax) : (smin <= rhs));
  bool tt = lb[h.w] >= 1, ff = ub[h.w] <= 0;
  bool ge_act = (is_eq && tt) || (!is_eq && ff), le_act = tt;
  long long rhs2 = is_eq ? rhs : rhs + 1;
  const int ts = p.base_lin + h.y;
  for (int t = 0; t < h.z; ++t) {
    const int2 term = __ldg(p.l_term + h.y + t);
    const int c = term.x;
    if (c == 0) continue;
    long long tmin, tmax;
    lin_term(fit32, c, lb[term.y], ub[term.y], &tmin, &tmax);
    long long R = rhs - (smin - tmin), R2 = rhs2 - (smax - tmax);
    long long q_le, ceil_le, q_ge, ceil_ge;
    if (unit) {
      q_le = ceil_le = R * c;
      q_ge = ceil_ge = R2 * c;
    } else {
      q_le = fdiv64(R, c);
      ceil_le = q_le + ((R - q_le * c) != 0);
      q_ge = fdiv64(R2, c);
      ceil_ge = q_ge + ((R2 - q_ge * c) != 0);
    }
    bool cpos = c > 0;
    long long hi = le_act && cpos ? q_le : TT_INF;
    hi = lmin(hi, ge_act && !cpos ? q_ge : TT_INF);
    long long lo = le_act && !cpos ? ceil_le : TT_NINF;
    lo = lmax(lo, ge_act && cpos ? ceil_ge : TT_NINF);
    out(ts + t, term.y, clip32(lo), clip32(hi));
  }
}
