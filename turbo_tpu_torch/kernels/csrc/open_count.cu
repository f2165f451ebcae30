// K5: the steal gate and its plan. The number of open right branches on
// the decision stacks of the SOLVE-phase dives, sum over d of
// #{j < depth[d] : dec_cur[d, j] == 0} where phase[d] == SOLVE, as one
// int64; and in the same launch the plan of the steal round that a
// nonzero count starts: the r-th IDLE lane (by index) takes the r-th open
// entry (j, d) in (depth, lane) order, for r < min(count, IDLE lanes).
//
// Replaces `_open_branch_counter` of turbo_tpu/solver/engine.py:
// 1185-1201 (the count) and the `opens.sort()` / `opens.pop(0)` ranking
// of `_steal_open_branches` (engine.py:1246-1261); K9 (steal.cu) applies
// the plan in place.
//
// What bounds it on an H100: bytes, and only the live prefix of each
// stack is read (depth[d] words of dec_cur), never the (D, MAXD) plane;
// the plan reads a column of D words for each depth up to the cut-off.
//
// Design: one thread block per dive; a block whose dive is not in SOLVE
// phase only takes its ticket. A SOLVE block reads its live prefix in
// 16-byte words (4 KB a round, coalesced), counts with a block scan and
// adds each open entry to a per-depth histogram in global memory, but
// only while fewer than n_idle entries of its lane came before: no later
// entry of the lane can rank below n_idle, so the histogram is exact up to
// the depth where the plan ends. Every block fences and takes a ticket
// (the pattern of K6 post's shard scan); the last one ranks: the IDLE
// lanes by a block scan, the histogram's prefix up to the cut-off 256
// depths a round, and at each depth with entries the lanes open there
// (one column read, a block scan over 256 lanes a round), linking each
// victim's steals in depth order for K9. It then zeroes the words the
// next launch counts on, so no memset launch is needed.
#include "steal.cuh"

__global__ void __launch_bounds__(TT_THREADS)
open_count_kernel(const int* __restrict__ dec_cur,
                  const int* __restrict__ depth,
                  const int* __restrict__ phase, int D, int MAXD, bool vec,
                  int* work, long long* out) {
  __shared__ int sh[TT_WARPS];
  __shared__ int is_last, s_top, s_nvict;
  __shared__ long long s_total;
  __shared__ int hs[TT_THREADS], bs[TT_THREADS];
  const StealPlan p = steal_plan(work, D, MAXD);
  const long long d = blockIdx.x;
  int tot;
  if (phase[d] == TT_SOLVE) {  // block-uniform
    int n_idle = 0;
    for (int b = 0; b < D; b += TT_THREADS) {
      const int i = b + threadIdx.x;
      n_idle += __syncthreads_count(i < D && phase[i] == TT_IDLE);
    }
    int dep = depth[d];
    dep = dep < MAXD ? dep : MAXD;
    const int* row = dec_cur + d * MAXD;
    int seen = 0, top = 0;
    for (int b = 0; b < dep; b += 4 * TT_THREADS) {
      const int j = b + 4 * threadIdx.x;
      int c[4];
      if (vec && j + 3 < dep) {
        const int4 q = *reinterpret_cast<const int4*>(row + j);
        c[0] = q.x;
        c[1] = q.y;
        c[2] = q.z;
        c[3] = q.w;
      } else {
        for (int k = 0; k < 4; ++k) c[k] = j + k < dep ? row[j + k] : 1;
      }
      const bool take = seen < n_idle;  // block-uniform
      int n = 0;
      for (int k = 0; k < 4; ++k) {
        if (c[k] != 0) continue;
        ++n;
        if (take) atomicAdd(p.hist + j + k, 1);
      }
      block_scan<false>(n, sh, &tot);
      if (take && tot) {
        const int end = b + 4 * TT_THREADS;
        top = end < dep ? end : dep;
      }
      seen += tot;
    }
    if (threadIdx.x == 0 && seen) {
      atomicAdd(reinterpret_cast<unsigned long long*>(work + W_COUNT),
                (unsigned long long)seen);
      atomicMax(work + W_TOP, top);
    }
  }

  // Every block takes a ticket; the last one builds the plan.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(work + W_TICKET, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (threadIdx.x == 0) {
    s_total = (long long)atomicExch(
        reinterpret_cast<unsigned long long*>(work + W_COUNT), 0ULL);
    s_top = atomicExch(work + W_TOP, 0);
    s_nvict = 0;
    *out = s_total;
  }
  int n_idle = 0;
  for (int b = 0; b < D; b += TT_THREADS) {
    const int i = b + threadIdx.x;
    n_idle += __syncthreads_count(i < D && phase[i] == TT_IDLE);
  }
  const int top = s_top;
  const int n = s_total < n_idle ? (int)s_total : n_idle;  // the steals

  // The thieves: the first n IDLE lanes, by index.
  for (int b = 0, c = 0; b < D && c < n; b += TT_THREADS) {
    const int i = b + threadIdx.x;
    const int f = i < D && phase[i] == TT_IDLE;
    const int r = c + block_scan<false>(f, sh, &tot) - f;
    if (f && r < n) p.thief[r] = i;
    c += tot;
  }

  // The first n open entries in (depth, lane) order: the histogram's
  // prefix gives each depth's first rank, a column scan the lanes' ranks.
  for (int jb = 0, base = 0; jb < top && base < n; jb += TT_THREADS) {
    const int j = jb + threadIdx.x;
    const int h = j < top ? __ldcg(p.hist + j) : 0;
    const int inc = block_scan<false>(h, sh, &tot);
    hs[threadIdx.x] = h;
    bs[threadIdx.x] = base + inc - h;
    base += tot;
    __syncthreads();
    for (int k = 0; k < TT_THREADS && jb + k < top && bs[k] < n; ++k) {
      if (hs[k] == 0) continue;
      const int jj = jb + k;
      for (int vb = 0, c = bs[k]; vb < D && c < n; vb += TT_THREADS) {
        const int v = vb + threadIdx.x;
        int f = 0;
        if (v < D && phase[v] == TT_SOLVE && jj < depth[v])
          f = dec_cur[(long long)v * MAXD + jj] == 0;
        const int r = c + block_scan<false>(f, sh, &tot) - f;
        if (f && r < n) {
          p.d0[r] = jj;
          p.victim[r] = v;
          p.next[r] = -1;
          const int q = p.last[v];  // only this thread touches lane v
          if (q < 0) {
            p.head[v] = r;
            p.vict[atomicAdd(&s_nvict, 1)] = v;
          } else {
            p.next[q] = r;
          }
          p.last[v] = r;
        }
        c += tot;
      }
    }
    __syncthreads();  // hs and bs are rewritten next round
  }

  // Leave the counted words zero and the links unset for the next launch.
  for (int i = threadIdx.x; i < top; i += TT_THREADS) p.hist[i] = 0;
  __syncthreads();
  const int nv = s_nvict;
  for (int i = threadIdx.x; i < nv; i += TT_THREADS) p.last[p.vict[i]] = -1;
  if (threadIdx.x == 0) {
    work[W_NVICT] = nv;
    work[W_NSTEAL] = n;
    work[W_TICKET] = 0;
  }
}

extern "C" int tt_open_count(const int* dec_cur, const int* depth,
                             const int* phase, int* work, long long* out,
                             int D, int MAXD, void* stream) {
  // 16-byte loads when every row starts on a 16-byte boundary.
  const bool vec = (MAXD & 3) == 0 && ((uintptr_t)dec_cur & 15) == 0;
  open_count_kernel<<<D, TT_THREADS, 0, (cudaStream_t)stream>>>(
      dec_cur, depth, phase, D, MAXD, vec, work, out);
  return (int)cudaGetLastError();
}

// What the kernel's first launch would do: its module load
// (cudaFuncGetAttributes loads a lazily loaded kernel).
extern "C" int tt_open_count_load(const void*, int) {
  cudaFuncAttributes a;
  return (int)cudaFuncGetAttributes(&a, (const void*)open_count_kernel);
}
