// K7: the cross-lane end of a search step, and the chunk's live flag.
//
// Replaces sections VIII-IX and the solution-ring append of
// BatchedSolver.step, turbo_tpu/solver/engine.py:906-919 and 1040-1101
// (the plain torch version is BatchedSolver.step_plain of
// solver/engine.py), the all-IDLE exit of make_step_budget's
// while_loop (engine.py:1336-1350), and, over S EPS shards, the
// per-shard part of the sharded step of turbo_tpu/parallel/mesh.py:
// 184-219 (each shard refills from its own counter, table and ring).
// Three entry points:
//
// - tt_step_scan (one block per shard): next_sub = max(next_sub, the
//   shard's dive leaves' nxt); a block scan of want gives each
//   finishing lane its rank and its new subproblem index, and whether
//   the shard's range still has work; a block scan of impr gives each
//   accepted solution its slot (w0 + rank) mod R in the shard's ring
//   (of more than R in one step only the last R land); the shard's
//   next_sub and sol_w advance by its totals. The last block to finish
//   writes *live_next = some lane of any shard is not IDLE after this
//   step, and counts the step in *steps. When *live is 0 it only
//   writes *live_next = 0.
// - tt_step_copy (one block per lane): the refill of a finishing lane
//   with work (table mode: row clip(newidx, 0, n_pad - 1) of its
//   shard's table into the store and the root snapshot, straight into
//   SOLVE phase; table off: the root box, into DIVE phase) or IDLE
//   without work, and the row of an accepted solution in its shard's
//   ring (the lane's incumbent row, which K6 just wrote).
// - tt_step_live (one block): *live = some lane is not IDLE, *steps = 0,
//   once at the start of a chunk.
//
// What bounds it on an H100: the scan is a few int32 per lane on one
// SM per shard, latency-bound; the copy is bytes, V words read and two
// or four planes of V words written per refilled lane (at golomb(12),
// D = 512, V = 2560: at most 21 MB when every lane refills, typically a
// few).
//
// Design: the scan is a warp-shuffle inclusive scan with one shared word
// per warp, chunked over the shard's lanes in blocks of 1024 with a
// running carry, so D may exceed the block. The shards' blocks meet in
// two words (tail_sync): each ORs its live bit into [1] and takes a
// ticket from [0] after a fence; the block that takes the last ticket
// publishes the flag and resets both, so one launch serves any S and
// S = 1 computes what the single-block scan did. The copy's blocks of
// lanes without refill or ring row return at once.
#include "step.cuh"

#define TT_SCAN_THREADS 1024

// Inclusive block scan of x; *total gets the block's sum.
__device__ int block_scan(int x, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[w] = x;
  __syncthreads();
  if (w == 0) {
    int t = lane < nw ? warp_tot[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  const int pre = w > 0 ? warp_tot[w - 1] : 0;
  *total = warp_tot[nw - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return x + pre;
}

__global__ void __launch_bounds__(TT_SCAN_THREADS)
step_scan_kernel(StepView s, const int* live, int* live_next) {
  if (*live == 0) {
    if (blockIdx.x == 0 && threadIdx.x == 0) *live_next = 0;
    return;
  }
  __shared__ int warp_tot[32];
  __shared__ int warp_max[32];
  const int D = s.D;
  const long long l0 = (long long)blockIdx.x * D;  // the shard's lane 0
  // Totals and the dive leaves' max nxt first.
  int m = -2147483647 - 1, nw = 0, ni = 0;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const int c = s.dleaf[l0 + i] ? s.nxt[l0 + i] : 0;
    m = c > m ? c : m;
    nw += s.want[l0 + i];
    ni += s.impr[l0 + i];
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int o = __shfl_down_sync(0xffffffffu, m, off);
    m = o > m ? o : m;
  }
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  int total_w, total_i;
  block_scan(nw, warp_tot, &total_w);
  block_scan(ni, warp_tot, &total_i);
  m = warp_max[0];  // block_scan synchronised the block
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    m = warp_max[w] > m ? warp_max[w] : m;
  const int ns0 = s.next_sub[l0];
  const int ns = ns0 > m ? ns0 : m;
  const int limit = s.sub_limit[l0];
  const int w0 = s.sol_w[l0];
  const int R = s.R;
  int any = 0, carry_w = 0, carry_i = 0;
  for (int base = 0; base < D; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const long long d = l0 + i;
    const int wt = i < D ? s.want[d] : 0;
    const int im = i < D ? s.impr[d] : 0;
    int tw, ti;
    const int inc_w = block_scan(wt, warp_tot, &tw) + carry_w;
    const int inc_i = block_scan(im, warp_tot, &ti) + carry_i;
    carry_w += tw;
    carry_i += ti;
    if (i < D) {
      const int idx = add32(ns, wt ? inc_w - 1 : 0);
      const bool hw = wt && idx < limit;
      s.newidx[d] = idx;
      s.havework[d] = hw;
      int r = -1;
      if (im && R > 0 && total_i - inc_i < R) {
        r = add32(w0, inc_i - 1) % R;
        r = r < 0 ? r + R : r;
      }
      s.ridx[d] = r;
      const int ph = wt ? (hw ? (s.use_table ? TT_SOLVE : TT_DIVE) : TT_IDLE)
                        : s.phase[d];
      any |= ph != TT_IDLE;
    }
  }
  any = __syncthreads_or(any);  // every read of sol_w[l0] is done
  const int ns2 = add32(ns, total_w);
  const int ns_new = ns2 < limit ? ns2 : limit;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    s.next_sub[l0 + i] = ns_new;
    if (R > 0) s.sol_w[l0 + i] = add32(s.sol_w[l0 + i], total_i);
  }
  if (threadIdx.x == 0) {
    if (any) atomicOr(&s.tail_sync[1], 1);
    __threadfence();
    if (atomicAdd(&s.tail_sync[0], 1) == (int)gridDim.x - 1) {
      *live_next = atomicExch(&s.tail_sync[1], 0) != 0;
      s.tail_sync[0] = 0;
      *s.steps += 1;
    }
  }
}

__global__ void __launch_bounds__(TT_THREADS)
step_copy_kernel(StepView s, const int* live) {
  if (*live == 0) return;
  const long long d = blockIdx.x;
  const long long shard = d / s.D;
  const int V = s.V;
  const bool want = s.want[d];
  const int r = s.ridx[d];
  if (!want && r < 0) return;
  if (want) {
    const bool hw = s.havework[d];
    if (hw && s.use_table) {
      const long long i = shard * s.n_pad + clampi(s.newidx[d], 0,
                                                   s.n_pad - 1);
      const int* tl = s.tab_lb + i * V;
      const int* tu = s.tab_ub + i * V;
      for (int v = threadIdx.x; v < V; v += blockDim.x) {
        const int l = tl[v], u = tu[v];
        s.lb[d * V + v] = l;
        s.root_lb[d * V + v] = l;
        s.ub[d * V + v] = u;
        s.root_ub[d * V + v] = u;
      }
      if (threadIdx.x == 0) {
        s.depth[d] = 0;
        s.strat[d] = s.tab_strat[i];
        s.snap_strat[d] = s.tab_strat[i];
        s.remaining[d] = 0;
        s.subp[d] = s.tab_path[i];
      }
    } else if (hw) {
      for (int v = threadIdx.x; v < V; v += blockDim.x) {
        s.lb[d * V + v] = s.lb0[v];
        s.ub[d * V + v] = s.ub0[v];
      }
      if (threadIdx.x == 0) {
        s.depth[d] = 0;
        s.strat[d] = 0;
        s.remaining[d] = s.kpow[d];
        s.subp[d] = s.newidx[d];
      }
    }
    if (threadIdx.x == 0)
      s.phase[d] = hw ? (s.use_table ? TT_SOLVE : TT_DIVE) : TT_IDLE;
  }
  if (r >= 0) {
    const int* src = s.best_lb + d * V;
    int* dst = s.sol_ring + (shard * s.R + r) * V;
    for (int v = threadIdx.x; v < V; v += blockDim.x) dst[v] = src[v];
  }
}

__global__ void __launch_bounds__(TT_SCAN_THREADS)
step_live_kernel(const int* phase, int D, int* live, int* steps) {
  int any = 0;
  for (int i = threadIdx.x; i < D; i += blockDim.x) any |= phase[i] != TT_IDLE;
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) {
    *live = any != 0;
    *steps = 0;
  }
}

extern "C" int tt_step_scan(const StepView* s, const int* live,
                            int* live_next, void* stream) {
  step_scan_kernel<<<s->S, TT_SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      *s, live, live_next);
  return (int)cudaGetLastError();
}

extern "C" int tt_step_copy(const StepView* s, const int* live,
                            void* stream) {
  step_copy_kernel<<<s->S * s->D, TT_THREADS, 0, (cudaStream_t)stream>>>(
      *s, live);
  return (int)cudaGetLastError();
}

extern "C" int tt_step_live(const int* phase, int D, int* live, int* steps,
                            void* stream) {
  step_live_kernel<<<1, TT_SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      phase, D, live, steps);
  return (int)cudaGetLastError();
}
