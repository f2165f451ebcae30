// K5: the number of open right branches on the decision stacks of the
// SOLVE-phase dives: sum over d of #{j < depth[d] : dec_cur[d, j] == 0}
// where phase[d] == SOLVE, as one int64.
//
// Replaces `_open_branch_counter` of turbo_tpu/solver/engine.py:
// 1185-1201, the steal gate's precheck: a zero count spares the host
// the full-state read of a steal round.
//
// What bounds it on an H100: bytes, and only the live prefix of each
// stack is read (depth[d] words of dec_cur), never the (D, MAXD) plane.
//
// Design: one thread block per dive; a block whose dive is not in SOLVE
// phase returns at once. Threads stride over the live prefix (coalesced
// reads), count into a shared counter with shared-memory atomics, and
// thread 0 adds the block's count to the result with one global atomic.
// The wrapper zeroes the result before the launch.
#include "common.cuh"

#define TT_SOLVE 1

__global__ void __launch_bounds__(TT_THREADS)
open_count_kernel(const int* __restrict__ dec_cur,
                  const int* __restrict__ depth,
                  const int* __restrict__ phase, int MAXD,
                  unsigned long long* out) {
  const long long d = blockIdx.x;
  if (phase[d] != TT_SOLVE) return;
  __shared__ unsigned int block_count;
  if (threadIdx.x == 0) block_count = 0;
  __syncthreads();
  int dep = depth[d];
  dep = dep < MAXD ? dep : MAXD;
  const int* row = dec_cur + d * MAXD;
  unsigned int n = 0;
  for (int j = threadIdx.x; j < dep; j += blockDim.x) n += row[j] == 0;
  if (n) atomicAdd(&block_count, n);
  __syncthreads();
  if (threadIdx.x == 0 && block_count)
    atomicAdd(out, (unsigned long long)block_count);
}

extern "C" int tt_open_count(const int* dec_cur, const int* depth,
                             const int* phase, long long* out, int D,
                             int MAXD, void* stream) {
  open_count_kernel<<<D, TT_THREADS, 0, (cudaStream_t)stream>>>(
      dec_cur, depth, phase, MAXD, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
