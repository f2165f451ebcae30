// K9: the steal round applied in place, on the plan K5 (open_count.cu)
// left in the workspace: thief t takes victim v's open branch at depth d0
// for each planned steal (t, d0, v).
//
// Replaces the per-steal loop of `_steal_open_branches` in
// turbo_tpu/solver/engine.py:1203-1314 (the JAX package does it on the
// host, after `jax.device_get` of the whole state). Per steal: the
// victim's dec_cur[d0] = 1 and its rope chain above d0 recomputed; the
// thief's stacks [0, d0] copied from the victim with cur[d0] = 1 and
// rope1[d0] = -1; the victim's right child at d0 rewritten to the left
// one; the thief's store rebuilt from the victim's root snapshot met with
// decisions 0..d0 at their current child; the thief's scalars. Every
// other word keeps its value, the thief's stack rows beyond d0 too.
//
// What bounds it on an H100: bytes. A steal reads the victim's root rows
// (2 V words) and stack prefix (7 (d0 + 1)) and writes the thief's four
// store rows (4 V) and its prefix; at golomb(12) (V = 2560) about 61 KB.
//
// Design: one thread block per victim (the victims K5 listed; the launch
// has one block per steal and the rest return at once). A victim's steals
// run one after another in increasing d0, because a later thief copies a
// prefix that an earlier steal from the same victim rewrote; steals of
// different victims touch disjoint rows (a thief is IDLE, a victim in
// SOLVE phase) and run in parallel. The rope chain is a running "last
// open index": rope1[j] = the largest i in (d0, j] with cur[i-1] == 0,
// else rope1[d0], a block max-scan 256 depths a round. The store is
// rebuilt in the thief's rows in global memory: the root row, a barrier,
// then atomicMax/atomicMin of each decision's interval (max and min
// commute, so the order of the d0 + 1 meets does not matter).
#include "steal.cuh"

__global__ void __launch_bounds__(TT_THREADS) steal_kernel(StealView s) {
  __shared__ int sh[TT_WARPS];
  const StealPlan p = steal_plan(s.work, s.D, s.MAXD);
  if ((int)blockIdx.x >= s.work[W_NVICT]) return;
  const int v = p.vict[blockIdx.x];
  const long long MAXD = s.MAXD, V = s.V;
  const long long vo = v * MAXD, vr = v * V;
  const int dep = s.depth[v];
  int* const stack[7] = {s.dec_var, s.dec_l0, s.dec_u0, s.dec_l1,
                         s.dec_u1, s.dec_rope1, s.dec_cur};
  for (int r = p.head[v]; r >= 0; r = p.next[r]) {
    const int t = p.thief[r], d0 = p.d0[r];
    const long long to = t * MAXD, tr = t * V;
    // Close the branch on the victim, then its rope chain above d0.
    if (threadIdx.x == 0) s.dec_cur[vo + d0] = 1;
    __syncthreads();
    int carry = s.dec_rope1[vo + d0];
    for (int b = d0 + 1; b < dep; b += TT_THREADS) {
      const int j = b + threadIdx.x;
      const int x = j < dep && s.dec_cur[vo + j - 1] == 0 ? j : -1;
      int tot;
      const int m = block_scan<true>(x, sh, &tot);
      if (j < dep) s.dec_rope1[vo + j] = m >= 0 ? m : carry;
      if (tot >= 0) carry = tot;
    }
    __syncthreads();
    // Seed the thief with the prefix before the victim's l1/u1 rewrite,
    // so that it copies the true right child at d0.
    for (int j = threadIdx.x; j <= d0; j += TT_THREADS)
      for (int f = 0; f < 7; ++f) stack[f][to + j] = stack[f][vo + j];
    __syncthreads();
    if (threadIdx.x == 0) {
      s.dec_cur[to + d0] = 1;
      s.dec_rope1[to + d0] = -1;
      s.dec_l1[vo + d0] = s.dec_l0[vo + d0];
      s.dec_u1[vo + d0] = s.dec_u0[vo + d0];
      s.depth[t] = d0 + 1;
      s.phase[t] = TT_SOLVE;
      s.remaining[t] = 0;
      s.subp[t] = s.subp[v];
      s.kpow[t] = s.kpow[v];
      const int ss = s.snap_strat[v];
      s.strat[t] = ss;
      s.snap_strat[t] = ss;
    }
    // The thief's store: the victim's root snapshot met with decisions
    // 0..d0 at their current child (d0 at the right child).
    for (long long i = threadIdx.x; i < V; i += TT_THREADS) {
      const int l = s.root_lb[vr + i], u = s.root_ub[vr + i];
      s.lb[tr + i] = l;
      s.ub[tr + i] = u;
      s.root_lb[tr + i] = l;
      s.root_ub[tr + i] = u;
    }
    __syncthreads();
    for (int j = threadIdx.x; j <= d0; j += TT_THREADS) {
      const int x = s.dec_var[to + j];
      const bool right = j == d0 || s.dec_cur[to + j] == 1;
      atomicMax(s.lb + tr + x, right ? s.dec_l1[to + j] : s.dec_l0[to + j]);
      atomicMin(s.ub + tr + x, right ? s.dec_u1[to + j] : s.dec_u0[to + j]);
    }
    __syncthreads();
  }
}

extern "C" int tt_steal(const StealView* s, int n, void* stream) {
  steal_kernel<<<n, TT_THREADS, 0, (cudaStream_t)stream>>>(*s);
  return (int)cudaGetLastError();
}

// What the kernel's first launch would do: its module load
// (cudaFuncGetAttributes loads a lazily loaded kernel).
extern "C" int tt_steal_load(const void*, int) {
  cudaFuncAttributes a;
  return (int)cudaFuncGetAttributes(&a, (const void*)steal_kernel);
}
