// The step entries' epilogue: K2's and K3's bodies (classify.cuh,
// select.cuh) on a block's final store, shared by K1's step entry
// (fixpoint.cu) and K8's (wac1.cu).
#pragma once
#include "classify.cuh"
#include "select.cuh"

// Static shared memory left beside the dynamic one under the block's
// limit: the epilogue's K2 and K3 words (68 bytes) and the level
// entries' mbarrier (8 bytes, level.cuh). Mirrored by
// kernels.STATIC_SMEM.
#define TT_STATIC_SMEM 128

// A step entry's extra arguments: K3's cursors (strat0) and K2's and
// K3's outputs, each indexed by the dive.
struct StepOut {
  const int* strat;
  unsigned char* bot;
  unsigned char* ent;
  SelectOut sel;
};

// K2 and K3 on the block's final store (lb, ub), complete and visible
// to the block: every thread calls it.
__device__ __forceinline__ void step_epilogue(const PlanView& p,
                                              const int* lb, const int* ub,
                                              const StepOut& so,
                                              long long d) {
  classify_block(p, lb, ub, so.bot + d, so.ent + d);
  select_block(p, lb, ub, so.strat[d], so.sel, d);
}
