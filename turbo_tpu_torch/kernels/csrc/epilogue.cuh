// The step entries' epilogue: K2's and K3's bodies (classify.cuh,
// select.cuh) on a block's final store, shared by K1's step entry
// (fixpoint.cu) and K8's (wac1.cu); and the clock stamps of their
// stamped entries.
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

// The stamped step entries: thread 0 reads the SM's clock when the block
// starts (after the live check), before the epilogue (after the sweeps
// and the row write) and when the block ends, and keeps what it needs in
// the dive's two words of ``stamps`` ((D, 2) int64), so that no register
// stays live across the sweeps. At the end stamps[d] holds (the cycles
// of the load, the sweeps and the row write; the epilogue's cycles):
// solver/profile_split.py splits the launch's device time by them.
__device__ __forceinline__ void stamp_start(long long* stamps, long long d) {
  if (threadIdx.x == 0) stamps[2 * d] = clock64();
}

__device__ __forceinline__ void stamp_epilogue(long long* stamps,
                                               long long d) {
  if (threadIdx.x == 0) {
    const long long t = clock64();
    stamps[2 * d] = t - stamps[2 * d];
    stamps[2 * d + 1] = t;
  }
}

__device__ __forceinline__ void stamp_end(long long* stamps, long long d) {
  if (threadIdx.x == 0) stamps[2 * d + 1] = clock64() - stamps[2 * d + 1];
}
