// K7: the two launches of a chunk of steps that are not a step's own:
// the chunk's live flag before the first step and the last step's
// refill and ring rows after it.
//
// Replaces the all-IDLE test of make_step_budget's while_loop,
// turbo_tpu/solver/engine.py:1336-1350, and the refill and ring rows of
// BatchedSolver.step, engine.py:906-919 and 1070-1101, of a chunk's last
// step (the plain torch version is BatchedSolver.lane_copy_plain of
// solver/engine.py); over S EPS shards the rows are each shard's, as in
// the sharded step of turbo_tpu/parallel/mesh.py:184-219. Inside a
// chunk the refill of step i runs at the head of step i + 1 (K6
// tt_step_head, step.cu), before the next K1 launch; the closing copy
// completes the state before the host reads it. Two entry points:
//
// - tt_step_live (one block): *live = some lane of any shard is not
//   IDLE, *steps = 0 and *bmin = the min of best_bound over every lane
//   (the incumbent min of the first step's tighten), once at the start
//   of a chunk; over card groups it publishes them into slot [0][xcard]
//   of every group (step.cuh xpublish), which the first step's K10
//   (xcard.cu) reduces;
// - tt_step_copy (one warp per lane): lane_copy of step.cuh under the
//   last step's live word: the refill of a finishing lane with work
//   (table mode: row clip(newidx, 0, n_pad - 1) of its shard's table
//   into the store and the root snapshot, straight into SOLVE phase;
//   table off: the root box, into DIVE phase) or IDLE without work, and
//   the row of an accepted solution in its shard's ring (the lane's
//   incumbent row, which K6 post just wrote).
//
// What bounds it on an H100: live reads the S*D phases and best_bound
// words on one SM (latency); the copy is bytes, two table rows read and
// four rows written per refilled lane (at golomb(12), D = 512, V =
// 2560: at most 21 MB when every lane refills, typically a few lanes),
// a row read and written per ring row.
//
// Design: the copy's warps of lanes without refill or ring row return
// after two loads; a warp moves a row in 16-byte words where V % 4 == 0,
// eight of each row in flight a thread.
#include <climits>

#include "step.cuh"

#define TT_LIVE_THREADS 1024

__global__ void __launch_bounds__(TT_THREADS)
step_copy_kernel(StepView s, const int* __restrict__ live) {
  const long long d = (long long)blockIdx.x * (TT_THREADS / 32) +
                      (threadIdx.x >> 5);
  if (d >= (long long)s.S * s.D || *live == 0) return;
  lane_copy(s, d, threadIdx.x & 31);
}

__global__ void __launch_bounds__(TT_LIVE_THREADS)
step_live_kernel(StepView s, int* __restrict__ live) {
  __shared__ int warp_min[TT_LIVE_THREADS / 32];
  const int n = s.S * s.D;
  int any = 0, m = INT_MAX;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    any |= s.phase[i] != TT_IDLE;
    const int b = s.best_bound[i];
    m = b < m ? b : m;
  }
  m = __reduce_min_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = m;
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) {
    for (int w = 1; w < TT_LIVE_THREADS / 32; ++w)
      m = warp_min[w] < m ? warp_min[w] : m;
    *live = any != 0;
    *s.steps = 0;
    *s.bmin = m;
    xpublish(s, 0, m, any != 0);  // card groups: for the first step's K10
  }
}

extern "C" int tt_step_copy(const StepView* s, const int* live,
                            void* stream) {
  const int blocks = (s->S * s->D + TT_THREADS / 32 - 1) / (TT_THREADS / 32);
  step_copy_kernel<<<blocks, TT_THREADS, 0, (cudaStream_t)stream>>>(*s,
                                                                     live);
  return (int)cudaGetLastError();
}

extern "C" int tt_step_live(const StepView* s, int* live, void* stream) {
  step_live_kernel<<<1, TT_LIVE_THREADS, 0, (cudaStream_t)stream>>>(*s,
                                                                    live);
  return (int)cudaGetLastError();
}

// What the kernels' first launches would do: their module loads
// (cudaFuncGetAttributes loads a lazily loaded kernel).
extern "C" int tt_step_tail_load(const void*, int) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, (const void*)step_copy_kernel);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&a, (const void*)step_live_kernel);
  return (int)e;
}
