// K1: the propagation fixpoint of one dive per thread block.
//
// Replaces PropagatorKernels.fixpoint / iteration / _clamp_store of
// turbo_tpu/solver/propagate_jax.py (with _deduce_group, _inv_mul,
// _fwd_div, _linear_bucket_cands, _element_cands, _member_cands): AC-1
// sweeps until the dive's store stops changing, turns bot, or reaches
// the cap. Returns (lb, ub, iters, unconv) as the JAX function does.
//
// What bounds it on an H100: the sweep is gather-bound. Each sweep
// reads the store at ~6 places per propagator and writes 2 candidate
// words per role; the per-variable combine reads them back. The
// arithmetic is int32/int64 compares and a few divisions.
//
// Design: the block keeps its dive's two store planes (2 V int32) in
// shared memory when they fit (V up to ~28k on 227 KB), so the gathers
// of phase A hit shared memory; otherwise it works in place on the
// output rows in global memory. The candidate planes (2 n_cand int32)
// live in a global scratch row of the dive, written and read by the
// same block (L1/L2 resident at the shapes the engine runs). Sweeps are
// Jacobi, as in the JAX sweep: phase A computes every candidate from
// the current store; phase B combines them per variable (max of lb
// candidates, min of ub candidates over the CSR incidence list), folds
// singleton-tail conflicts into the dummy column and clamps to the root
// box, in place: a variable reads only candidates and its own old
// bounds. A dive stops at its own convergence; the JAX loop sweeps on
// until the last lane converges, which is idempotent on converged lanes
// (bot lanes may differ: the engine discards their store).
//
// In the search step (solver/step_cuda.py) the kernel runs in place
// (lb_in == lb_out: each block reads its own rows before it writes
// them) and returns at once when *live is 0 (every lane was IDLE when the
// step began); the EPS table build passes no live flag.
#include "common.cuh"

__device__ __forceinline__ void phase_a(const PlanView& p, const int* lb,
                                        const int* ub, int* cl, int* cu) {
  const int P = p.P, E = p.E, M = p.M;
  const int n_items = P + E + M + p.L;
  for (int it = threadIdx.x; it < n_items; it += blockDim.x) {
    if (it < P) {
      int x = p.px[it], y = p.py[it], z = p.pz[it];
      int c[6];
      deduce(p.prop_op[it], lb[x], ub[x], lb[y], ub[y], lb[z], ub[z], c);
      cl[it] = c[0]; cu[it] = c[1];
      cl[P + it] = c[2]; cu[P + it] = c[3];
      cl[2 * P + it] = c[4]; cu[2 * P + it] = c[5];
    } else if (it < P + E) {
      // Element: windowed min/max of the result, first/last feasible
      // index (_element_cands).
      int i = it - P;
      int len = p.e_len[i];
      int li = lb[p.e_idx[i]], ui = ub[p.e_idx[i]];
      int lr = lb[p.e_res[i]], ur = ub[p.e_res[i]];
      int jlo = TT_INF - 1, jhi = TT_NINF - 1, rlo = TT_INF, rhi = TT_NINF;
      const int* tab = p.e_tab + (long long)i * p.T;
      int wlo = sub32(li, 1), whi = sub32(ui, 1);
      for (int j = 0; j < p.T; ++j) {
        int v = tab[j];
        if (j >= wlo && j <= whi && j < len && v >= lr && v <= ur) {
          jlo = j < jlo ? j : jlo; jhi = j > jhi ? j : jhi;
          rlo = v < rlo ? v : rlo; rhi = v > rhi ? v : rhi;
        }
      }
      int s = 3 * P + i;
      cl[s] = jlo + 1; cu[s] = jhi + 1;
      cl[s + E] = rlo; cu[s + E] = rhi;
    } else if (it < P + E + M) {
      // Reified sparse membership (_member_cands).
      int i = it - P - E;
      int W = p.W, base = p.m_base[i], top = p.m_top[i];
      int lx = lb[p.m_x[i]], ux = ub[p.m_x[i]];
      int c = member_count(p, i, lx, ux);
      long long width = (long long)ux - lx + 1;
      int b_lo = c == width && width > 0, b_hi = c > 0;
      int wl = sub32(lx, base), wh = sub32(ux, base);
      wl = wl < 0 ? 0 : (wl > W - 1 ? W - 1 : wl);
      wh = wh < 0 ? 0 : (wh > W - 1 ? W - 1 : wh);
      long long row = (long long)i * W;
      int nge = lx > top ? TT_INF : p.m_next_ge[row + wl];
      int ple = ux < base ? TT_NINF : p.m_prev_le[row + wh];
      int nout = lx >= base && lx <= top ? p.m_next_out[row + wl] : lx;
      int pout = ux >= base && ux <= top ? p.m_prev_out[row + wh] : ux;
      bool tt = lb[p.m_b[i]] >= 1, ff = ub[p.m_b[i]] <= 0;
      int x_lo = tt ? nge : (ff ? nout : TT_NINF);
      int x_hi = tt ? ple : (ff ? pout : TT_INF);
      int s = 3 * P + 2 * E + i;
      cl[s] = clip32(x_lo); cu[s] = clip32(x_hi);
      cl[s + M] = b_lo; cu[s + M] = b_hi;
    } else {
      // Reified linear row: sum bounds, then per-term floor/ceil
      // candidates (_linear_bucket_cands).
      int r = it - P - E - M;
      int flags = p.l_flags[r];
      bool unit = flags & 1, fit32 = flags & 2;
      long long smin, smax;
      lin_sums(p, r, lb, ub, &smin, &smax);
      long long rhs = p.l_rhs[r];
      bool is_eq = p.l_op[r] == 1;
      cl[p.base_linb + r] = is_eq ? (smin == rhs && smax == rhs) : (smax <= rhs);
      cu[p.base_linb + r] = is_eq ? (smin <= rhs && rhs <= smax) : (smin <= rhs);
      bool tt = lb[p.l_b[r]] >= 1, ff = ub[p.l_b[r]] <= 0;
      bool ge_act = (is_eq && tt) || (!is_eq && ff), le_act = tt;
      long long rhs2 = is_eq ? rhs : rhs + 1;
      const int* coef = p.l_coef + p.l_toff[r];
      const int* var = p.l_var + p.l_toff[r];
      int* tl = cl + p.base_lin + p.l_toff[r];
      int* tu = cu + p.base_lin + p.l_toff[r];
      for (int t = 0; t < p.l_K[r]; ++t) {
        int c = coef[t];
        if (c == 0) continue;  // padding term: its slot is never read
        long long tmin, tmax;
        lin_term(fit32, c, lb[var[t]], ub[var[t]], &tmin, &tmax);
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
        tl[t] = clip32(lo); tu[t] = clip32(hi);
      }
    }
  }
}

__global__ void __launch_bounds__(TT_THREADS)
fixpoint_kernel(PlanView p, const int* lb_in, const int* ub_in, int* lb_out,
                int* ub_out, int* iters_out, unsigned char* unconv_out,
                int* cand, int cap, int use_smem, const int* live) {
  if (live != nullptr && *live == 0) return;
  extern __shared__ int smem[];
  const int V = p.V;
  const long long d = blockIdx.x;
  int* lb = use_smem ? smem : lb_out + d * V;
  int* ub = use_smem ? smem + V : ub_out + d * V;
  int* cl = cand + d * 2LL * p.n_cand;
  int* cu = cl + p.n_cand;
  if (use_smem || lb != lb_in + d * V) {
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      lb[v] = lb_in[d * V + v];
      ub[v] = ub_in[d * V + v];
    }
  }
  __syncthreads();
  int iters = 0;
  bool m = true;
  for (int it = 0; m && it < cap; ++it) {
    phase_a(p, lb, ub, cl, cu);
    __syncthreads();
    // Singleton-tail conflict fold: a deduction (lo, hi) into a var
    // fixed at c conflicts iff lo > c or hi < c.
    int conf = 0;
    for (int k = threadIdx.x; k < p.n_conf; k += blockDim.x) {
      int s = p.conf_slot[k], off = p.conf_off[k];
      conf |= cl[s] > off || cu[s] < off;
    }
    conf = __syncthreads_or(conf) ? 1 : 0;
    int changed = 0, bot = 0;
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      int l0 = lb[v], u0 = ub[v];
      int l = l0, u = u0;
      if (v < p.n_active) {
        for (int k = p.inc_off[v]; k < p.inc_off[v + 1]; ++k) {
          int s = p.inc_slot[k];
          l = cl[s] > l ? cl[s] : l;
          u = cu[s] < u ? cu[s] : u;
        }
      } else if (v == V - 1 && p.n_conf > 0) {
        l = l > conf ? l : conf;
      }
      l = l < p.ub_cap[v] ? l : p.ub_cap[v];
      u = u > p.lb_floor[v] ? u : p.lb_floor[v];
      changed |= l != l0 || u != u0;
      bot |= l > u;
      lb[v] = l;
      ub[v] = u;
    }
    changed = __syncthreads_or(changed);
    bot = __syncthreads_or(bot);
    iters += 1;
    m = changed && !bot;
  }
  if (use_smem) {
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      lb_out[d * V + v] = lb[v];
      ub_out[d * V + v] = ub[v];
    }
  }
  if (threadIdx.x == 0) {
    iters_out[d] = iters + 1;
    unconv_out[d] = m;
  }
}

extern "C" int tt_fixpoint(const PlanView* p, const int* lb_in,
                           const int* ub_in, int* lb_out, int* ub_out,
                           int* iters, unsigned char* unconv, int* cand,
                           int D, int cap, int smem_limit, const int* live,
                           void* stream) {
  static int attr_set = -1;
  size_t smem = 2 * sizeof(int) * (size_t)p->V;
  int use_smem = smem <= (size_t)smem_limit;
  if (!use_smem) smem = 0;
  if ((int)smem > attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fixpoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = (int)smem;
  }
  fixpoint_kernel<<<D, TT_THREADS, smem, (cudaStream_t)stream>>>(
      *p, lb_in, ub_in, lb_out, ub_out, iters, unconv, cand, cap, use_smem,
      live);
  return (int)cudaGetLastError();
}

extern "C" const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
