// K8: the WAC1 propagation fixpoint of one dive per thread block.
//
// Replaces PropagatorKernels._group_local_fixpoint / sweep_wac1 /
// fixpoint_wac1 of turbo_tpu/solver/propagate_jax.py. One outer sweep:
// every op-group (a contiguous slice of the TNF propagators) runs to its
// local fixpoint, capped at inner_cap Jacobi iterations, in group order,
// so that a group reads what the groups before it wrote; then one pass
// each of the element rows, the membership rows (from the store after
// the element meet) and every linear bucket in turn. Outer sweeps run
// until one changes nothing, the store turns bot, or the cap. Returns
// (lb, ub, sweeps + 1, unconv) as the JAX function does; the inner
// iterations are not counted.
//
// Design: as K1, the block keeps its dive's store (2 V int32) in shared
// memory when it fits and works in place on the output rows otherwise.
// Every pass is Jacobi inside itself: its candidates are computed from
// the store into the dive's candidate scratch row (the slots K1 uses),
// the block synchronises, and only then the candidates meet the store
// by atomicMax / atomicMin. Duplicate targets combine monotonically, so
// the atomics give the scatter-meet's result in any order. The meet
// reaches every variable, the root-fixed tail too, and there is no
// conflict fold: a contradiction with a fixed variable empties that
// variable's own interval.
//
// The clamp to the root box (lb <= ub0 + 1, ub >= lb0 - 1) is applied
// to each candidate before its meet. On a store inside that box it is
// what the JAX function's clamp after the meet computes, and the meet's
// return value then says whether the store changed. Every state of the
// engine lies inside it (root, table rows, rebuilt lanes, the objective
// tighten).
//
// A dive stops at its own convergence and leaves a sweep as soon as it
// sees its store bot; the JAX loop sweeps every lane until the last one
// converges. A sweep at a fixpoint changes nothing and bot is monotone,
// so sweeps, unconv and bot agree on every lane and the store on every
// lane that is not bot (the engine discards a bot store).
//
// Like K1 the kernel runs in place in the search step and returns at
// once when *live is 0.
#include "common.cuh"

// Meet candidate (l, u) into variable v, clamped to the root box.
// Returns whether a bound moved.
__device__ __forceinline__ int meet(const PlanView& p, int* lb, int* ub,
                                    int v, int l, int u) {
  int cap = p.ub_cap[v], floor_ = p.lb_floor[v];
  l = l < cap ? l : cap;
  u = u > floor_ ? u : floor_;
  int ch = 0;
  if (l > lb[v]) ch |= atomicMax(&lb[v], l) < l;
  if (u < ub[v]) ch |= atomicMin(&ub[v], u) > u;
  return ch;
}

__global__ void __launch_bounds__(TT_THREADS)
wac1_kernel(PlanView p, const int* lb_in, const int* ub_in, int* lb_out,
            int* ub_out, int* iters_out, unsigned char* unconv_out,
            int* cand, int cap, int inner_cap, int use_smem,
            const int* live) {
  if (live != nullptr && *live == 0) return;
  extern __shared__ int smem[];
  const int V = p.V, P = p.P, E = p.E, M = p.M;
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
  int b0 = 0;
  for (int v = threadIdx.x; v < V; v += blockDim.x) b0 |= lb[v] > ub[v];
  bool bot = __syncthreads_or(b0);
  int sweeps = 0;
  bool m = true;
  for (int it = 0; m && it < cap; ++it) {
    int changed = 0;
    // Op-groups in order, each to its local fixpoint.
    for (int g = 0; g < p.G; ++g) {
      const int a = p.g_off[g], b = p.g_off[g + 1];
      for (int inner = 0; inner < inner_cap; ++inner) {
        for (int i = a + threadIdx.x; i < b; i += blockDim.x)
          cand_tnf(p, i, lb, ub, Slots{cl, cu});
        __syncthreads();
        int ch = 0;
        for (int i = a + threadIdx.x; i < b; i += blockDim.x) {
          ch |= meet(p, lb, ub, p.px[i], cl[i], cu[i]);
          ch |= meet(p, lb, ub, p.py[i], cl[P + i], cu[P + i]);
          ch |= meet(p, lb, ub, p.pz[i], cl[2 * P + i], cu[2 * P + i]);
        }
        ch = __syncthreads_or(ch);
        changed |= ch;
        if (!ch) break;
        // The store was not bot before this iteration, so it is bot now
        // iff a variable this group wrote is empty.
        int bb = 0;
        for (int i = a + threadIdx.x; i < b; i += blockDim.x) {
          int x = p.px[i], y = p.py[i], z = p.pz[i];
          bb |= lb[x] > ub[x] || lb[y] > ub[y] || lb[z] > ub[z];
        }
        bot = __syncthreads_or(bb) || bot;
        if (bot) break;
      }
      if (bot) break;
    }
    if (!bot) {
      int ch = 0;
      if (E > 0) {
        for (int i = threadIdx.x; i < E; i += blockDim.x)
          cand_elem(p, i, lb, ub, Slots{cl, cu});
        __syncthreads();
        for (int i = threadIdx.x; i < E; i += blockDim.x) {
          int s = 3 * P + i;
          ch |= meet(p, lb, ub, p.e_idx[i], cl[s], cu[s]);
          ch |= meet(p, lb, ub, p.e_res[i], cl[s + E], cu[s + E]);
        }
        __syncthreads();
      }
      if (M > 0) {
        for (int i = threadIdx.x; i < M; i += blockDim.x)
          cand_member(p, i, lb, ub, Slots{cl, cu});
        __syncthreads();
        for (int i = threadIdx.x; i < M; i += blockDim.x) {
          int s = 3 * P + 2 * E + i;
          ch |= meet(p, lb, ub, p.m_x[i], cl[s], cu[s]);
          ch |= meet(p, lb, ub, p.m_b[i], cl[s + M], cu[s + M]);
        }
        __syncthreads();
      }
      // Linear buckets one after the other: a bucket reads the store
      // the buckets before it wrote.
      for (int k = 0; k < p.LB; ++k) {
        const int a = p.lb_off[k], b = p.lb_off[k + 1];
        for (int r = a + threadIdx.x; r < b; r += blockDim.x)
          cand_linear(p, r, lb, ub, Slots{cl, cu});
        __syncthreads();
        for (int r = a + threadIdx.x; r < b; r += blockDim.x) {
          const int* coef = p.l_coef + p.l_toff[r];
          const int* var = p.l_var + p.l_toff[r];
          const int* tl = cl + p.base_lin + p.l_toff[r];
          const int* tu = cu + p.base_lin + p.l_toff[r];
          for (int t = 0; t < p.l_K[r]; ++t)
            if (coef[t] != 0) ch |= meet(p, lb, ub, var[t], tl[t], tu[t]);
          ch |= meet(p, lb, ub, p.l_b[r], cl[p.base_linb + r],
                     cu[p.base_linb + r]);
        }
        __syncthreads();
      }
      int bb = 0;
      for (int v = threadIdx.x; v < V; v += blockDim.x) bb |= lb[v] > ub[v];
      changed |= __syncthreads_or(ch);
      bot = __syncthreads_or(bb);
    }
    sweeps += 1;
    m = changed && !bot;
  }
  if (use_smem) {
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      lb_out[d * V + v] = lb[v];
      ub_out[d * V + v] = ub[v];
    }
  }
  if (threadIdx.x == 0) {
    iters_out[d] = sweeps + 1;
    unconv_out[d] = m;
  }
}

extern "C" int tt_wac1(const PlanView* p, const int* lb_in, const int* ub_in,
                       int* lb_out, int* ub_out, int* iters,
                       unsigned char* unconv, int* cand, int D, int cap,
                       int inner_cap, int smem_limit, const int* live,
                       void* stream) {
  static int attr_set = -1;
  size_t smem = 2 * sizeof(int) * (size_t)p->V;
  int use_smem = smem <= (size_t)smem_limit;
  if (!use_smem) smem = 0;
  if ((int)smem > attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        wac1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = (int)smem;
  }
  wac1_kernel<<<D, TT_THREADS, smem, (cudaStream_t)stream>>>(
      *p, lb_in, ub_in, lb_out, ub_out, iters, unconv, cand, cap, inner_cap,
      use_smem, live);
  return (int)cudaGetLastError();
}
