// K6: the per-lane body of one search step, in place on the state.
//
// Replaces the lane-local part of BatchedSolver.step of
// turbo_tpu/solver/engine.py:801-1117 (the plain torch version is
// BatchedSolver.step_plain of solver/engine.py). Two entry points around
// K1-K3 (fixpoint, classify, select):
//
// - tt_step_pre: promote finished dives to SOLVE, the strategy cursor
//   strat0 (skip the EPS strategy after the dive), and the objective
//   tighten ub[obj] <= min(min_d best_bound, ext_bound[0], best_bound)
//   - 1 of every SOLVE lane (section I);
// - tt_step_post: the rest of the step that reads or writes one lane:
//   the leaf and solution rules (enumerate_all included), the counters,
//   the incumbent rows on an improvement, any_unfixed, dive branching,
//   the solve-branch push onto the seven stacks, the child bound, rope
//   backtracking with the store rebuild (the root snapshot met with the
//   first t decisions of the lane), the dive-leaf skip, and the flags
//   want, impr, dleaf and the value nxt that K7 reads.
//
// Every kernel of a step returns at once when *live is 0 (every lane
// was IDLE when the step began), so a chunk of steps enqueued without
// a host read changes nothing after the batch went idle. Both run over
// the S*D lanes of every EPS shard: the incumbent min of tt_step_pre
// over all of them is the JAX mesh's pmin (engine.py:824-827), since
// ext_bound is the same on every lane.
//
// What bounds it on an H100: neither bytes nor operations. A lane's
// step is a few dozen scalar reads and writes and, for the few lanes
// that improve, snapshot or backtrack, one or two V-word row copies; at
// golomb(12) (D = 512, V = 2560) about 1 MB of traffic. Launch latency
// and the dependent scalar chain of thread 0 bound it.
//
// Design: tt_step_pre runs one thread per lane; each block reduces the
// whole best_bound vector itself (D is at most a few thousand), so no
// second pass is needed. tt_step_post runs one block per lane: every
// thread computes the lane's scalar decisions redundantly from the same
// reads (no shared-memory broadcast needed), the row copies are strided
// over the block, thread 0 writes the scalars and the stacks, and the
// rebuild scatters the decisions with atomicMax/atomicMin into the
// lane's two rows staged in shared memory (in global memory when 2 V
// words do not fit). deds is a float32 multiply then add, rounded
// separately (__fmul_rn, __fadd_rn) as the plain version rounds them;
// int32 counters wrap through unsigned arithmetic.
#include "step.cuh"

__global__ void __launch_bounds__(TT_THREADS)
step_pre_kernel(StepView s, const int* live) {
  if (*live == 0) return;
  __shared__ int warp_min[TT_THREADS / 32];
  const int n = s.S * s.D;
  int m = 0x7fffffff;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int b = s.best_bound[i];
    m = b < m ? b : m;
  }
  for (int off = 16; off > 0; off >>= 1) {
    int o = __shfl_down_sync(0xffffffffu, m, off);
    m = o < m ? o : m;
  }
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_min[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    m = warp_min[w] < m ? warp_min[w] : m;
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= n) return;
  const int eb = s.ext_bound[0];
  const int g = m < eb ? m : eb;
  int ph = s.phase[d];
  const int st = s.strat[d];
  const bool promote = ph == TT_DIVE && s.remaining[d] == 0;
  if (promote) {
    ph = TT_SOLVE;
    s.phase[d] = TT_SOLVE;
  }
  const int es = s.eps_strat[d];
  s.strat0[d] = promote ? (st > es ? st : es) : st;
  if (s.is_opt && ph == TT_SOLVE) {
    const int bb = s.best_bound[d];
    const int lim = sub32(g < bb ? g : bb, 1);
    int* u = s.ub + (long long)d * s.V + s.obj;
    *u = *u < lim ? *u : lim;
  }
}

__global__ void __launch_bounds__(TT_THREADS)
step_post_kernel(StepView s, const int* live, int use_smem) {
  if (*live == 0) return;
  extern __shared__ int smem[];
  __shared__ int sh_t, sh_restore;
  const int V = s.V, MAXD = s.MAXD;
  const long long d = blockIdx.x;
  int* lb = s.lb + d * V;
  int* ub = s.ub + d * V;
  const long long so = d * MAXD;

  // Lane scalars: every thread derives the same values.
  const int ph = s.phase[d];  // promoted by tt_step_pre
  const bool act = ph != TT_IDLE, in_dive = ph == TT_DIVE,
             in_solve = ph == TT_SOLVE;
  const bool bot = s.bot[d], ent = s.ent[d] && !bot;
  const bool held = s.unconv[d] && !bot && !ent;
  const bool found = s.found[d];
  const int rem = s.remaining[d], sp = s.subp[d], dep = s.depth[d];
  bool sol, leaf;
  if (s.enumerate_all) {
    const bool leftmost = (sp & sub32(shl32(1, rem), 1)) == 0;
    sol = ent && !found && (in_dive ? leftmost : true);
    leaf = bot || (ent && !found);
  } else {
    sol = ent;
    leaf = bot || sol;
  }
  const int objv = s.is_opt ? lb[s.obj] : 0;
  bool better;
  if (s.is_opt) {
    const int bb = s.best_bound[d], eb = s.ext_bound[0];
    better = objv < (bb < eb ? bb : eb);
  } else {
    better = s.enumerate_all || !s.has_best[d];
  }
  const bool impr = act && sol && better;
  const bool no_split = act && !leaf && !found && !held;
  bool any_unfixed = false;
  if (no_split) {  // block-uniform
    int a = 0;
    for (int v = threadIdx.x; v < s.n_active; v += blockDim.x)
      a |= lb[v] < ub[v];
    any_unfixed = __syncthreads_or(a) != 0;
  }
  const bool incomplete = no_split && any_unfixed;
  const bool waiting = no_split && !any_unfixed;
  leaf = leaf || incomplete;
  const bool branching = act && !leaf && !waiting && !held;
  const bool dive_br = branching && in_dive;
  bool solve_br = branching && in_solve;
  const bool ovf = solve_br && dep >= MAXD;
  solve_br = solve_br && !ovf;
  leaf = leaf || ovf;
  const bool snap = solve_br && dep == 0;

  // Rows of the post-fixpoint store, before the child bound lands.
  if (impr || snap) {
    int* bl = s.best_lb + d * V;
    int* bu = s.best_ub + d * V;
    int* rl = s.root_lb + d * V;
    int* ru = s.root_ub + d * V;
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      const int l = lb[v], u = ub[v];
      if (impr) { bl[v] = l; bu[v] = u; }
      if (snap) { rl[v] = l; ru[v] = u; }
    }
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    const int it = s.iters[d];
    s.nodes[d] = add32(s.nodes[d], act && !held);
    s.fails[d] = add32(s.fails[d], act && bot);
    s.fpit[d] = add32(s.fpit[d], act ? it : 0);
    s.deds[d] = __fadd_rn(s.deds[d],
                          act ? __fmul_rn((float)it, s.pscale[d]) : 0.0f);
    const int tree_depth = add32(dep, sub32(s.kpow[d], rem));
    const int dm = s.dmax[d], dc = act ? tree_depth : 0;
    s.dmax[d] = dm > dc ? dm : dc;
    if (impr) {
      s.best_bound[d] = objv;
      s.has_best[d] = 1;
    }
    s.sols[d] = add32(s.sols[d], impr);
    s.nonexh[d] = s.nonexh[d] || incomplete || ovf;

    // V. Dive branching.
    const int bit = (sp >> (rem - 1 > 0 ? rem - 1 : 0)) & 1;
    const int rem2 = dive_br ? rem - 1 : rem;
    s.remaining[d] = rem2;

    // VI. Solve branching: push the decision.
    const int strat0 = s.strat0[d];
    const int snap_strat = snap ? strat0 : s.snap_strat[d];
    const int dd = clampi(dep, 0, MAXD - 1);
    const int parent = clampi(dep - 1, 0, MAXD - 1);
    const int rope1 = dep > 0 ? (s.dec_cur[so + parent] == 0
                                     ? dep : s.dec_rope1[so + parent])
                              : -1;
    const int c0l = s.c0l[d], c0u = s.c0u[d], c1l = s.c1l[d], c1u = s.c1u[d];
    if (solve_br) {
      s.dec_var[so + dd] = s.var[d];
      s.dec_l0[so + dd] = c0l;
      s.dec_u0[so + dd] = c0u;
      s.dec_l1[so + dd] = c1l;
      s.dec_u1[so + dd] = c1u;
      s.dec_rope1[so + dd] = rope1;
      s.dec_cur[so + dd] = 0;
    }
    const int dep1 = solve_br ? dep + 1 : dep;
    // The chosen child's bounds (dive: by path bit; solve: left).
    if (dive_br || solve_br) {
      const int v = s.var[d];
      const bool right = dive_br && bit == 1;
      const int el = right ? c1l : c0l, eu = right ? c1u : c0u;
      lb[v] = lb[v] > el ? lb[v] : el;
      ub[v] = ub[v] < eu ? ub[v] : eu;
    }

    // VII. Backtracking by ropes.
    const bool bt = act && leaf && in_solve;
    const int lastd = clampi(dep1 - 1, 0, MAXD - 1);
    const int t = s.dec_cur[so + lastd] == 0 ? dep1 : s.dec_rope1[so + lastd];
    const bool done_sub = bt && (dep1 == 0 || t == -1);
    const bool restore = bt && dep1 > 0 && t != -1;
    if (restore) s.dec_cur[so + clampi(t - 1, 0, MAXD - 1)] = 1;
    int strat = branching ? s.nstrat[d] : strat0;
    if (restore) strat = snap_strat;
    s.strat[d] = strat;
    s.snap_strat[d] = snap_strat;
    s.depth[d] = restore ? t : dep1;

    // VIII. Dive leaves: skip the unreachable subtree.
    const bool dleaf = act && leaf && in_dive;
    const int nxt = shl32(add32(sp >> rem2, 1), rem2);
    const bool dleaf_left = dleaf && (sp & sub32(shl32(1, rem2), 1)) == 0;
    s.skipped_sub[d] = add32(s.skipped_sub[d],
                             dleaf_left ? sub32(sub32(nxt, sp), 1) : 0);
    s.solved_sub[d] = add32(s.solved_sub[d], done_sub || dleaf_left);
    s.want[d] = dleaf || done_sub;
    s.impr[d] = impr;
    s.dleaf[d] = dleaf;
    s.nxt[d] = nxt;
    sh_t = t;
    sh_restore = restore;
  }
  __syncthreads();

  // Rebuild: the root snapshot met with decisions j < t at their current
  // child (the flipped one included).
  if (sh_restore) {
    const int t = sh_t;
    int* L = use_smem ? smem : lb;
    int* U = use_smem ? smem + V : ub;
    const int* rl = s.root_lb + d * V;
    const int* ru = s.root_ub + d * V;
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      L[v] = rl[v];
      U[v] = ru[v];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < t; j += blockDim.x) {
      const int v = s.dec_var[so + j];
      const bool c1 = s.dec_cur[so + j] == 1;
      atomicMax(&L[v], c1 ? s.dec_l1[so + j] : s.dec_l0[so + j]);
      atomicMin(&U[v], c1 ? s.dec_u1[so + j] : s.dec_u0[so + j]);
    }
    __syncthreads();
    if (use_smem) {
      for (int v = threadIdx.x; v < V; v += blockDim.x) {
        lb[v] = L[v];
        ub[v] = U[v];
      }
    }
  }
}

extern "C" int tt_step_pre(const StepView* s, const int* live, void* stream) {
  const int blocks = (s->S * s->D + TT_THREADS - 1) / TT_THREADS;
  step_pre_kernel<<<blocks, TT_THREADS, 0, (cudaStream_t)stream>>>(*s, live);
  return (int)cudaGetLastError();
}

extern "C" int tt_step_post(const StepView* s, const int* live,
                            int smem_limit, void* stream) {
  static int attr_set = -1;
  size_t smem = 2 * sizeof(int) * (size_t)s->V;
  const int use_smem = smem <= (size_t)smem_limit;
  if (!use_smem) smem = 0;
  if ((int)smem != attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        step_post_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = (int)smem;
  }
  step_post_kernel<<<s->S * s->D, TT_THREADS, smem, (cudaStream_t)stream>>>(
      *s, live, use_smem);
  return (int)cudaGetLastError();
}
