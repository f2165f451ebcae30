// K3: branch selection and the two children, one dive per thread block.
//
// Replaces BatchedSolver._select and _children of
// turbo_tpu/solver/engine.py: walk the strategies from the dive's
// cursor; in each, the splittable variable minimising the var-order key
// (ties: smallest position in the strategy's list) wins, and the first
// strategy with one stops the walk. Then the LightBranch child
// intervals of the value order (solver/strategy.py).
//
// The JAX function's default when no strategy >= cursor has a
// splittable variable: chosen = 0, valo = valo[0], and var = strategy
// 0's own argmin of the masked key, which is ids_0[0] when strategy 0
// has nothing splittable either. The kernel returns the same.
//
// What bounds it on an H100: one gather of (lb, ub) per listed variable
// of the strategies walked, and one block argmin each. Usually only the
// cursor's strategy is read.
//
// Design: threads stride over a strategy's positions keeping the least
// (key, position) pair packed in 64 bits (key biased to unsigned);
// warp shuffles and one shared word per warp finish the argmin.
#include "common.cuh"

__device__ __forceinline__ unsigned long long pack(int key, int pos) {
  return ((unsigned long long)((unsigned)key ^ 0x80000000u) << 32) |
         (unsigned)pos;
}

// Block argmin over strategy s: returns the packed (key, pos) minimum;
// *found is true iff some variable is splittable.
__device__ unsigned long long strategy_argmin(const PlanView& p, int s,
                                              const int* lb, const int* ub,
                                              int* found) {
  __shared__ unsigned long long warp_min[TT_THREADS / 32];
  const int big = 0x7fffffff;
  int vo = p.s_vo[s], b = p.s_off[s], n = p.s_off[s + 1] - b;
  unsigned long long best = ~0ULL;
  int any = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int v = p.s_ids[b + i];
    int l = lb[v], u = ub[v];
    bool ok = l < u && l > TT_NINF && u < TT_INF;
    int size = sub32(u, l);
    int key = vo == 0 ? i : vo == 1 ? size : vo == 2 ? sub32(0, size)
            : vo == 3 ? l : sub32(0, u);
    unsigned long long k = pack(ok ? key : big, i);
    best = k < best ? k : best;
    any |= ok;
  }
  for (int off = 16; off > 0; off >>= 1) {
    unsigned long long o = __shfl_down_sync(0xffffffffu, best, off);
    best = o < best ? o : best;
  }
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = best;
  *found = __syncthreads_or(any);
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      best = warp_min[w] < best ? warp_min[w] : best;
    warp_min[0] = best;
  }
  __syncthreads();
  best = warp_min[0];
  __syncthreads();  // warp_min is reused by the next call
  return best;
}

__global__ void __launch_bounds__(TT_THREADS)
select_kernel(PlanView p, const int* __restrict__ lb_all,
              const int* __restrict__ ub_all, const int* __restrict__ strat,
              unsigned char* found_out, int* var_out, int* chosen_out,
              int* valo_out, int* c0l_out, int* c0u_out, int* c1l_out,
              int* c1u_out, const int* live) {
  if (live != nullptr && *live == 0) return;  // every lane IDLE
  const long long d = blockIdx.x;
  const int* lb = lb_all + d * p.V;
  const int* ub = ub_all + d * p.V;
  int found = 0, chosen = 0;
  unsigned long long best = 0;
  for (int s = strat[d] < 0 ? 0 : strat[d]; s < p.S; ++s) {
    best = strategy_argmin(p, s, lb, ub, &found);
    if (found) { chosen = s; break; }
  }
  if (!found) {
    int unused;
    best = strategy_argmin(p, 0, lb, ub, &unused);
  }
  if (threadIdx.x != 0) return;
  int var = p.s_ids[p.s_off[chosen] + (int)(best & 0xffffffffu)];
  int valo = p.s_valo[chosen];
  int lo = lb[var], hi = ub[var];
  int mid = add32(lo, sub32(hi, lo) >> 1);  // arithmetic shift: floor
  int c0l = 0, c0u = 0, c1l = 0, c1u = 0;
  switch (valo) {
    case 0: c0l = lo; c0u = lo; c1l = add32(lo, 1); c1u = hi; break;
    case 1: c0l = hi; c0u = hi; c1l = lo; c1u = sub32(hi, 1); break;
    case 2: c0l = lo; c0u = mid; c1l = add32(mid, 1); c1u = hi; break;
    case 3: c0l = add32(mid, 1); c0u = hi; c1l = lo; c1u = mid; break;
  }
  found_out[d] = found != 0;
  var_out[d] = var;
  chosen_out[d] = chosen;
  valo_out[d] = valo;
  c0l_out[d] = c0l; c0u_out[d] = c0u;
  c1l_out[d] = c1l; c1u_out[d] = c1u;
}

extern "C" int tt_select(const PlanView* p, const int* lb, const int* ub,
                         const int* strat, unsigned char* found, int* var,
                         int* chosen, int* valo, int* c0l, int* c0u,
                         int* c1l, int* c1u, int D, const int* live,
                         void* stream) {
  select_kernel<<<D, TT_THREADS, 0, (cudaStream_t)stream>>>(
      *p, lb, ub, strat, found, var, chosen, valo, c0l, c0u, c1l, c1u, live);
  return (int)cudaGetLastError();
}
