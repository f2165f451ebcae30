// What K5 (open_count.cu) and K9 (steal.cu) share: the steal plan's
// layout in one int32 workspace (kernels/__init__.py ``StealPlan``), the
// state rows K9 rewrites (``StealView``) and the block-wide scans both
// use.
#pragma once
#include <climits>

#include "common.cuh"

#define TT_SOLVE 1
#define TT_IDLE 2
#define TT_WARPS (TT_THREADS / 32)

// The workspace's head words: K5's ticket, the end of the histogram's
// nonzero prefix and the open count (64 bits, words 2-3), each 0 between
// launches; the plan's victims and steals, which K5 writes for K9.
enum { W_TICKET = 0, W_TOP = 1, W_COUNT = 2, W_NVICT = 4, W_NSTEAL = 5,
       W_HEAD = 8 };

// After the head words: the open entries per depth (MAXD, 0 between
// launches), then seven (D,) arrays. By rank r in (depth, lane) order:
// thief (the r-th IDLE lane), d0 and victim (the r-th open entry) and
// next (the victim's next steal, -1 after its last). By lane: head (a
// victim's first steal) and last (its latest while K5 links them; -1
// between launches). vict: the victims, W_NVICT of them.
struct StealPlan {
  int* w;
  int* hist;
  int* thief;
  int* d0;
  int* victim;
  int* next;
  int* head;
  int* last;
  int* vict;
};

__device__ __forceinline__ StealPlan steal_plan(int* w, int D, int MAXD) {
  StealPlan p;
  p.w = w;
  p.hist = w + W_HEAD;
  int* a = p.hist + MAXD;
  p.thief = a;
  p.d0 = a + D;
  p.victim = a + 2 * (long long)D;
  p.next = a + 3 * (long long)D;
  p.head = a + 4 * (long long)D;
  p.last = a + 5 * (long long)D;
  p.vict = a + 6 * (long long)D;
  return p;
}

// The search state K9 reads and writes (kernels/__init__.py mirrors it):
// (D, V) stores, the seven (D, MAXD) stacks, the (D,) scalars, and the
// workspace with K5's plan.
struct StealView {
  int D, V, MAXD;
  int *lb, *ub, *root_lb, *root_ub;
  int *dec_var, *dec_l0, *dec_u0, *dec_l1, *dec_u1, *dec_rope1, *dec_cur;
  int *depth, *phase, *remaining, *subp, *kpow, *strat, *snap_strat;
  int* work;
};

// Inclusive scan (a sum, or with MAX a max) of one int per thread over
// the block's TT_THREADS threads in thread order: a shuffle scan per warp,
// then the earlier warps' totals from ``sh`` (TT_WARPS ints). Every
// thread must call it; *total gets the block's sum (max). Two barriers,
// so ``sh`` is free again on return.
template <bool MAX>
__device__ __forceinline__ int block_scan(int x, int* sh, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int v = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = MAX ? (y > v ? y : v) : v + y;
  }
  if (lane == 31) sh[w] = v;
  __syncthreads();
  int pre = MAX ? INT_MIN : 0, tot = pre;
  for (int k = 0; k < TT_WARPS; ++k) {
    const int y = sh[k];
    if (k < w) pre = MAX ? (y > pre ? y : pre) : pre + y;
    tot = MAX ? (y > tot ? y : tot) : tot + y;
  }
  __syncthreads();
  *total = tot;
  return MAX ? (pre > v ? pre : v) : pre + v;
}
