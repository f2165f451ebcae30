// K10: the incumbent min and the live flag across card groups, at the
// head of each step.
//
// Replaces the ``lax.pmin`` of the incumbent in the sharded step of
// turbo_tpu/parallel/mesh.py:184-219 (``ShardedSolver.make_step_n``, a
// shard_map over the devices) with turbo_tpu/solver/engine.py:824-826,
// for shards on distinct devices; the plain torch version is
// ``parallel/mesh.py`` ``xcard_plain``, and the card-group step on the
// CPU (``exchange_plain``) is the reference on the card. On one card the
// lane groups of one state need no exchange: K6 post's shard scans
// already reduce every lane.
//
// Each card group (parallel/mesh.py: a run of consecutive EPS shards as
// lane groups of one state, on its own card, or beside other groups on
// one card) owns a slot array of 2 x N x 2 int32 words: slot [p][g] is
// group g's (incumbent min, live flag) for a step of parity p. K7 live
// (for a chunk's first step) and K6 post's last block (for the next
// step; an idle step too) write their group's slot in every group's
// array, through peer pointers across cards (step.cuh xpublish). The
// host orders the groups' streams: a group's step waits on CUDA events
// that the other groups' streams recorded after their previous post
// (solver/step_cuda.py ``run_groups``). Two parities keep a fast group's
// post of step t + 1, which writes the slots of step t + 2, off the
// words a slow group's K10 of step t has still to read: before the fast
// group can post t + 1, its step t + 1 waited on the slow group's post
// of step t, which came after the slow group's K10 of step t.
//
// - tt_xcard (one warp): live = OR and bmin = min over the N slots of
//   parity ``parity`` of a group's array, into the live word of the step
//   and the incumbent min that K6 head, K1's or K8's step entry and K6
//   post then read as they do on one card;
// - tt_enable_peer: peer access from one card to another (both
//   directions are two calls; "already enabled" counts as success).
//   Raises nothing: returns cudaErrorPeerAccessUnsupported when the pair
//   has no peer access, and the caller raises, naming the pair.
//
// What bounds it on an H100: latency. It reads 2 N words and writes 2
// (N = 4: 40 bytes, 1.2e-5 us at 3.35 TB/s); a launch costs a few us.
// Design: one warp, a lane a slot, the slots read past L1 (__ldcv: a
// peer's stores land in this card's L2), and two warp reductions. Folding
// it into K6 head is later work.
#include <climits>

#include "common.cuh"

__global__ void __launch_bounds__(32)
xcard_kernel(const int* __restrict__ slots, int n, int* __restrict__ live,
             int* __restrict__ bmin) {
  int m = INT_MAX, any = 0;
  for (int g = threadIdx.x; g < n; g += 32) {
    const int x = __ldcv(slots + 2 * g);
    m = x < m ? x : m;
    any |= __ldcv(slots + 2 * g + 1) != 0;
  }
  m = __reduce_min_sync(0xffffffffu, m);
  any = __reduce_or_sync(0xffffffffu, any);
  if (threadIdx.x == 0) {
    *live = any != 0;
    *bmin = m;
  }
}

// ``slots``: a group's slot array (2 x n x 2 int32).
extern "C" int tt_xcard(const int* slots, int n, int parity, int* live,
                        int* bmin, void* stream) {
  if (n < 1 || (parity & ~1) != 0) return (int)cudaErrorInvalidValue;
  xcard_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(slots + 2 * n * parity, n,
                                                   live, bmin);
  return (int)cudaGetLastError();
}

// Peer access from card ``dev`` to card ``peer`` (the current device is
// restored).
extern "C" int tt_enable_peer(int dev, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int prev = 0;
  e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(dev);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear it: already enabled is success
      e = cudaSuccess;
    }
  }
  const cudaError_t r = cudaSetDevice(prev);
  return (int)(e != cudaSuccess ? e : r);
}

// What the kernel's first launch would do: its module load.
extern "C" int tt_xcard_load(const void*, int) {
  cudaFuncAttributes a;
  return (int)cudaFuncGetAttributes(&a, (const void*)xcard_kernel);
}
