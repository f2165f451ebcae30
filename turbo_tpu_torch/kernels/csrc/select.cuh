// K3's body: branch selection and the two children of one dive, on a
// whole thread block. K3's own kernel (select.cu) runs it on a store
// staged into shared memory; K1's step entry (fixpoint.cu) runs it on
// the store its block already holds.
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
// has nothing splittable either. The body returns the same.
//
// Threads stride over a strategy's positions keeping the least (key,
// position) pair packed in 64 bits (key biased to unsigned); warp
// shuffles leave one minimum per warp in shared memory, and one block
// barrier (an OR of "splittable") ends the strategy. Only the strategy
// that ends the walk is folded: warp 0 folds its per-warp minima with
// shuffles and thread 0 writes the outputs.
#pragma once
#include "common.cuh"

// K3's eight outputs, each indexed by the dive (valo may be null: the
// table level entries do not keep it).
struct SelectOut {
  unsigned char* found;
  int* var;
  int* chosen;
  int* valo;
  int* c0l;
  int* c0u;
  int* c1l;
  int* c1u;
};

__device__ __forceinline__ unsigned long long pack(int key, int pos) {
  return ((unsigned long long)((unsigned)key ^ 0x80000000u) << 32) |
         (unsigned)pos;
}

// Strategy s on this thread's positions: the least packed (key, pos) of
// each warp goes to wmin[warp]. Returns whether this thread saw a
// splittable variable.
__device__ __forceinline__ int strategy_scan(const PlanView& p, int s,
                                             const int* lb, const int* ub,
                                             unsigned long long* wmin) {
  const int big = 0x7fffffff;
  const int vo = __ldg(p.s_vo + s), b = __ldg(p.s_off + s);
  const int n = __ldg(p.s_off + s + 1) - b;
  unsigned long long best = ~0ULL;
  int any = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int v = __ldg(p.s_ids + b + i);
    const int l = lb[v], u = ub[v];
    const bool ok = l < u && l > TT_NINF && u < TT_INF;
    const int size = sub32(u, l);
    const int key = vo == 0 ? i : vo == 1 ? size : vo == 2 ? sub32(0, size)
                  : vo == 3 ? l : sub32(0, u);
    const unsigned long long k = pack(ok ? key : big, i);
    best = k < best ? k : best;
    any |= ok;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, best, off);
    best = o < best ? o : best;
  }
  if ((threadIdx.x & 31) == 0) wmin[threadIdx.x >> 5] = best;
  return any;
}

// Every thread of the block calls it (one block barrier per strategy
// walked, one more when none has a splittable variable); thread 0
// writes the outputs of dive d. strat: the dive's cursor. lb, ub: the
// dive's store (shared or global memory), complete and visible to the
// whole block on entry.
__device__ __forceinline__ void select_block(const PlanView& p,
                                             const int* lb, const int* ub,
                                             int strat, const SelectOut& o,
                                             long long d) {
  __shared__ unsigned long long wmin[TT_THREADS / 32];
  int found = 0, chosen = 0;
  for (int s = strat < 0 ? 0 : strat; s < p.S; ++s) {
    found = __syncthreads_or(strategy_scan(p, s, lb, ub, wmin));
    if (found) {
      chosen = s;
      break;
    }
  }
  if (!found) {
    strategy_scan(p, 0, lb, ub, wmin);
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    unsigned long long best =
        threadIdx.x < (blockDim.x >> 5) ? wmin[threadIdx.x] : ~0ULL;
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long w = __shfl_down_sync(0xffffffffu, best, off);
      best = w < best ? w : best;
    }
    if (threadIdx.x == 0) {
      const int var = __ldg(p.s_ids + __ldg(p.s_off + chosen) +
                            (int)(best & 0xffffffffu));
      const int valo = __ldg(p.s_valo + chosen);
      const int lo = lb[var], hi = ub[var];
      const int mid = add32(lo, sub32(hi, lo) >> 1);  // arithmetic: floor
      int c0l = 0, c0u = 0, c1l = 0, c1u = 0;
      switch (valo) {
        case 0: c0l = lo; c0u = lo; c1l = add32(lo, 1); c1u = hi; break;
        case 1: c0l = hi; c0u = hi; c1l = lo; c1u = sub32(hi, 1); break;
        case 2: c0l = lo; c0u = mid; c1l = add32(mid, 1); c1u = hi; break;
        case 3: c0l = add32(mid, 1); c0u = hi; c1l = lo; c1u = mid; break;
      }
      o.found[d] = found != 0;
      o.var[d] = var;
      o.chosen[d] = chosen;
      if (o.valo != nullptr) o.valo[d] = valo;
      o.c0l[d] = c0l;
      o.c0u[d] = c0u;
      o.c1l[d] = c1l;
      o.c1u[d] = c1u;
    }
  }
}
