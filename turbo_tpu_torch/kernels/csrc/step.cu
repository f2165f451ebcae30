// K6: the body of one search step, in place on the state, and the
// shard scan that ends it.
//
// Replaces BatchedSolver.step of turbo_tpu/solver/engine.py:801-1117
// around K1-K3 (the plain torch version is BatchedSolver.step_plain of
// solver/engine.py: step_pre_plain, step_post_plain, shard_scan_plain,
// lane_copy_plain),
// the all-IDLE exit of make_step_budget's while_loop (engine.py:
// 1336-1350) and, over S EPS shards, the per-shard part of the sharded
// step of turbo_tpu/parallel/mesh.py:184-219. Two entry points around
// K1-K3 (fixpoint, classify, select):
//
// - tt_step_head (one warp per lane): the previous step's refill and
//   ring rows (lane_copy of step.cuh) under the previous step's live
//   word, then this step's promote of finished dives to SOLVE, the
//   strategy cursor strat0 (skip the EPS strategy after the dive), and
//   the objective tighten ub[obj] <= min(bmin, ext_bound[0],
//   best_bound) - 1 of every SOLVE lane (section I) under this step's.
//   bmin is the min of best_bound over every lane of every shard, which
//   the previous post's last block (or K7 live) wrote: over S shards it
//   is the JAX mesh's pmin (engine.py:824-827), since ext_bound is the
//   same on every lane. The first step of a chunk has no copy to do.
// - tt_step_post (one block per lane): the rest of the step that reads
//   or writes one lane: the leaf and solution rules (enumerate_all
//   included), the counters, the incumbent rows on an improvement,
//   any_unfixed, dive branching, the solve-branch push onto the seven
//   stacks, the child bound, rope backtracking with the store rebuild
//   (the root snapshot met with the first t decisions of the lane), the
//   dive-leaf skip, and the flags want, impr, dleaf and the value nxt.
//   The shard's last block to post then runs the shard scan (sections
//   VIII-IX and the ring append, engine.py:906-919, 1040-1101):
//   next_sub = max(next_sub, the dive leaves' nxt); ranks of want give
//   each finishing lane its new subproblem index and whether the
//   shard's range still has work; ranks of impr give each accepted
//   solution its slot (w0 + rank) mod R in the shard's ring (of more
//   than R in one step only the last R land); next_sub and sol_w
//   advance by the totals. The last shard to scan publishes live_next
//   (some lane of any shard is not IDLE after this step), bmin, and the
//   step count. Over card groups (parallel/mesh.py: the shards on
//   distinct cards, or as separate states on one) it also publishes the
//   group's (bmin, live_next) into slot [xpar][xcard] of every group's
//   slot array (step.cuh xpublish), an idle step included, and the next
//   step's K10 (xcard.cu) reduces them into live and bmin, the pmin
//   across cards.
// - tt_step_head_timed, tt_step_post_timed: the same, each launch also
//   writing its span on the global timer (common.cuh span_begin /
//   span_end); only profiled chunks launch them (solver/step_cuda.py).
//
// Every kernel of a step returns at once when *live is 0 (every lane was
// IDLE when the step began; the post's block 0 then writes live_next =
// 0), so a chunk of steps enqueued without a host read changes nothing
// after the batch went idle.
//
// What bounds it on an H100: neither bytes nor operations. A lane's
// step is a few dozen scalar reads and writes and, for the few lanes
// that improve, snapshot, backtrack or refill, a few V-word rows; at
// golomb(12) (D = 512, V = 2560) tens of KB per step. Launch latency,
// the dependent chain of a lane's scalars and the shard scan's
// barriers bound it.
//
// Design: the head runs 8 lanes per block of 256 threads, a warp a lane:
// the rows with eight 16-byte words of each row in flight a thread, then
// lane 0 loads its lane's scalars before it stores any. The post loads
// the lane's 32 scalars in one round (one field per thread of warp 0,
// all loads in flight together) and the 4 stack and store words that
// depend on depth and var in a second, into shared memory; every
// thread derives the same decisions from there, the row copies are
// strided over the block in 16-byte words, thread 0 writes the scalars
// and the stacks once, and the rebuild scatters the decisions with
// atomicMax/atomicMin into the lane's two rows staged in shared memory
// (in global memory when 2 V words do not fit). Thread 0 then fences and
// takes a ticket from its shard's counter; the block that takes the
// last one reads the other blocks' flags through L2 (__ldcg) once, keeps
// their ballots in shared memory, and ranks them with __popc per 32
// lanes and a prefix over the 8 warps' totals, 256 lanes a round. The
// shards' last blocks meet in three more words of tail_sync the same
// way, and the last resets them. deds is a float32 multiply then add, rounded
// separately (__fmul_rn, __fadd_rn) as the plain version rounds them;
// int32 counters wrap through unsigned arithmetic.
#include <climits>

#include "step.cuh"

#define TT_WARPS (TT_THREADS / 32)

// The head's body (step_head_kernel, and step_head_timed_kernel of a
// profiled chunk).
__device__ __forceinline__ void step_head_body(
    const StepView& s, const int* __restrict__ prev_live,
    const int* __restrict__ live) {
  const int lane = threadIdx.x & 31;
  const long long d = (long long)blockIdx.x * TT_WARPS + (threadIdx.x >> 5);
  if (d >= (long long)s.S * s.D) return;
  if (prev_live != nullptr && *prev_live != 0) lane_copy(s, d, lane);
  __syncwarp();
  if (*live == 0 || lane != 0) return;
  // Loads first, stores after: the fields may alias as far as the
  // compiler knows.
  int ph = s.phase[d];
  const int st = s.strat[d], rem = s.remaining[d], es = s.eps_strat[d];
  const int bb = s.best_bound[d], g0 = *s.bmin, eb = s.ext_bound[0];
  int* u = s.ub + d * s.V + s.obj;
  const int uo = s.is_opt ? *u : 0;
  const bool promote = ph == TT_DIVE && rem == 0;
  if (promote) {
    ph = TT_SOLVE;
    s.phase[d] = TT_SOLVE;
  }
  s.strat0[d] = promote ? (st > es ? st : es) : st;
  if (s.is_opt && ph == TT_SOLVE) {
    const int g = g0 < eb ? g0 : eb;
    const int lim = sub32(g < bb ? g : bb, 1);
    if (lim < uo) *u = lim;
  }
}

__global__ void __launch_bounds__(TT_THREADS)
step_head_kernel(StepView s, const int* __restrict__ prev_live,
                 const int* __restrict__ live) {
  step_head_body(s, prev_live, live);
}

// The head of a profiled chunk: the head's work, and the launch's span
// on the global timer in ``span`` (common.cuh span_begin / span_end).
__global__ void __launch_bounds__(TT_THREADS)
step_head_timed_kernel(StepView s, const int* __restrict__ prev_live,
                       const int* __restrict__ live, long long* span) {
  span_begin(span);
  step_head_body(s, prev_live, live);
  span_end(span);
}

// The lane scalars of K6 post, one per thread of warp 0.
enum {
  F_PHASE, F_BOT, F_ENT, F_UNCONV, F_FOUND, F_REM, F_SUBP, F_DEPTH, F_BB,
  F_HASB, F_EXT, F_OBJV, F_ITERS, F_NODES, F_FAILS, F_FPIT, F_DEDS,
  F_PSCALE, F_KPOW, F_DMAX, F_SOLS, F_NONEXH, F_STRAT0, F_SNAPS, F_VAR,
  F_NSTRAT, F_C0L, F_C0U, F_C1L, F_C1U, F_SKIP, F_SOLVED, F_N
};
static_assert(F_N == 32, "one field per thread of a warp");
// The second round: the parent's stack entry and the branch variable's
// bounds.
enum { G_PCUR, G_PROPE, G_LBV, G_UBV, G_N };

// The address of field f of lane d, and whether it is a byte.
__device__ __forceinline__ const void* field_addr(const StepView& s, int f,
                                                  long long d, bool* byte) {
  *byte = false;
  switch (f) {
    case F_PHASE: return s.phase + d;
    case F_BOT: *byte = true; return s.bot + d;
    case F_ENT: *byte = true; return s.ent + d;
    case F_UNCONV: *byte = true; return s.unconv + d;
    case F_FOUND: *byte = true; return s.found + d;
    case F_REM: return s.remaining + d;
    case F_SUBP: return s.subp + d;
    case F_DEPTH: return s.depth + d;
    case F_BB: return s.best_bound + d;
    case F_HASB: *byte = true; return s.has_best + d;
    case F_EXT: return s.ext_bound;
    case F_OBJV: return s.lb + d * s.V + (s.is_opt ? s.obj : 0);
    case F_ITERS: return s.iters + d;
    case F_NODES: return s.nodes + d;
    case F_FAILS: return s.fails + d;
    case F_FPIT: return s.fpit + d;
    case F_DEDS: return s.deds + d;
    case F_PSCALE: return s.pscale + d;
    case F_KPOW: return s.kpow + d;
    case F_DMAX: return s.dmax + d;
    case F_SOLS: return s.sols + d;
    case F_NONEXH: *byte = true; return s.nonexh + d;
    case F_STRAT0: return s.strat0 + d;
    case F_SNAPS: return s.snap_strat + d;
    case F_VAR: return s.var + d;
    case F_NSTRAT: return s.nstrat + d;
    case F_C0L: return s.c0l + d;
    case F_C0U: return s.c0u + d;
    case F_C1L: return s.c1l + d;
    case F_C1U: return s.c1u + d;
    case F_SKIP: return s.skipped_sub + d;
    default: return s.solved_sub + d;
  }
}

// The ballots of want and impr that the shard scan keeps in shared
// memory: 32 lanes a word, D <= 32 * TT_SCAN_WORDS; the lanes beyond are
// loaded again.
#define TT_SCAN_WORDS 256

// The shard scan, by the whole block, once every lane of shard ``sh``
// has posted (see the header). Returns (to every thread) whether some
// lane of the shard is not IDLE after the step; *bmin_out gets the
// shard's min best_bound.
__device__ __forceinline__ int shard_scan(const StepView& s, long long sh,
                                          int* bmin_out) {
  __shared__ int red[5][TT_WARPS];
  __shared__ int tot[2][2][TT_WARPS];
  __shared__ unsigned ballot[2][TT_SCAN_WORDS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int D = s.D, R = s.R;
  const long long l0 = sh * D;
  // Pass 1: the ballots, the totals, the dive leaves' max nxt, the min
  // best_bound and whether a lane that does not finish stays live.
  int nw = 0, ni = 0, m = INT_MIN, bm = INT_MAX, live_rest = 0;
  for (int base = 0; base < D; base += TT_THREADS) {
    const int i = base + threadIdx.x;
    const long long d = l0 + i;
    bool wt = false, im = false;
    if (i < D) {
      wt = __ldcg(s.want + d);
      im = __ldcg(s.impr + d);
      const bool dl = __ldcg(s.dleaf + d);
      const int nx = __ldcg(s.nxt + d), b = __ldcg(s.best_bound + d);
      const int ph = s.phase[d];
      const int c = dl ? nx : 0;
      m = c > m ? c : m;
      bm = b < bm ? b : bm;
      live_rest |= !wt && ph != TT_IDLE;
    }
    const unsigned mw = __ballot_sync(0xffffffffu, wt);
    const unsigned mi = __ballot_sync(0xffffffffu, im);
    const int word = i >> 5;
    if (lane == 0 && word < TT_SCAN_WORDS) {
      ballot[0][word] = mw;
      ballot[1][word] = mi;
    }
    nw += lane == 0 ? __popc(mw) : 0;
    ni += lane == 0 ? __popc(mi) : 0;
  }
  nw = __reduce_add_sync(0xffffffffu, nw);
  ni = __reduce_add_sync(0xffffffffu, ni);
  m = __reduce_max_sync(0xffffffffu, m);
  bm = __reduce_min_sync(0xffffffffu, bm);
  live_rest = __reduce_or_sync(0xffffffffu, live_rest);
  if (lane == 0) {
    red[0][w] = nw;
    red[1][w] = ni;
    red[2][w] = m;
    red[3][w] = bm;
    red[4][w] = live_rest;
  }
  const int ns0 = s.next_sub[l0], limit = s.sub_limit[l0];
  const int w0 = s.sol_w[l0];
  __syncthreads();
  int total_w = 0, total_i = 0, any = 0;
  m = INT_MIN;
  bm = INT_MAX;
  for (int k = 0; k < TT_WARPS; ++k) {
    total_w += red[0][k];
    total_i += red[1][k];
    m = red[2][k] > m ? red[2][k] : m;
    bm = red[3][k] < bm ? red[3][k] : bm;
    any |= red[4][k];
  }
  *bmin_out = bm;
  const int ns = ns0 > m ? ns0 : m;
  // Pass 2: ranks in lane order, 256 lanes a round: the lanes of
  // earlier rounds (a carry), of earlier warps (a prefix over the
  // warps' popc totals) and of earlier threads of this warp
  // (popc(mask & lanemask_lt)).
  const unsigned lt = (1u << lane) - 1u;
  int carry_w = 0, carry_i = 0;
  for (int base = 0, round = 0; base < D; base += TT_THREADS, ++round) {
    const int i = base + threadIdx.x;
    const long long d = l0 + i;
    const int word = i >> 5;
    unsigned mw, mi;
    if (word < TT_SCAN_WORDS) {
      mw = ballot[0][word];
      mi = ballot[1][word];
    } else {
      mw = __ballot_sync(0xffffffffu, i < D && __ldcg(s.want + d));
      mi = __ballot_sync(0xffffffffu, i < D && __ldcg(s.impr + d));
    }
    const bool wt = (mw >> lane) & 1, im = (mi >> lane) & 1;
    int(*t)[TT_WARPS] = tot[round & 1];
    if (lane == 0) {
      t[0][w] = __popc(mw);
      t[1][w] = __popc(mi);
    }
    __syncthreads();
    int pre_w = carry_w, pre_i = carry_i;
    for (int k = 0; k < TT_WARPS; ++k) {
      if (k < w) {
        pre_w += t[0][k];
        pre_i += t[1][k];
      }
      carry_w += t[0][k];
      carry_i += t[1][k];
    }
    const int inc_w = pre_w + __popc(mw & lt) + wt;
    const int inc_i = pre_i + __popc(mi & lt) + im;
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
      any |= hw;  // a refilled lane is live
    }
    // tot alternates by round, so the next round's writes need no
    // second barrier.
  }
  any = __syncthreads_or(any);  // every read of next_sub and sol_w is done
  const int ns2 = add32(ns, total_w);
  const int ns_new = ns2 < limit ? ns2 : limit;
  for (int i = threadIdx.x; i < D; i += TT_THREADS) {
    s.next_sub[l0 + i] = ns_new;
    if (R > 0) s.sol_w[l0 + i] = add32(s.sol_w[l0 + i], total_i);
  }
  return any;
}

// The post's body (step_post_kernel, and step_post_timed_kernel of a
// profiled chunk).
__device__ __forceinline__ void step_post_body(
    const StepView& s, const int* __restrict__ live,
    int* __restrict__ live_next, int use_smem, int xpar) {
  if (*live == 0) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      *live_next = 0;
      // Card groups: an idle step still publishes, or the other groups'
      // K10 would read a stale slot of this parity. Nothing moved, so
      // the incumbent min is the one K10 reduced for this step.
      if (s.xslots != nullptr) xpublish(s, xpar, *s.bmin, 0);
    }
    return;
  }
  extern __shared__ int smem[];
  __shared__ int sh[F_N + G_N];
  __shared__ int sh_last;
  const int V = s.V, MAXD = s.MAXD;
  const long long d = blockIdx.x;
  int* __restrict__ lb = s.lb + d * V;
  int* __restrict__ ub = s.ub + d * V;
  const long long so = d * MAXD;

  // Round 1: every scalar of the lane, one per thread of warp 0 (a byte
  // field reads its aligned word). Round 2: the words that depend on
  // depth and var.
  if (threadIdx.x < 32) {
    bool byte;
    const char* p = (const char*)field_addr(s, threadIdx.x, d, &byte);
    const int off = byte ? (int)((unsigned long long)p & 3) : 0;
    const int word = *(const int*)(p - off);
    const int x = byte ? (word >> (8 * off)) & 0xff : word;
    sh[threadIdx.x] = x;
    const int dep = __shfl_sync(0xffffffffu, x, F_DEPTH);
    const int var = __shfl_sync(0xffffffffu, x, F_VAR);
    const long long par = so + clampi(dep - 1, 0, MAXD - 1);
    const bool vok = var >= 0 && var < V;
    int y = 0;
    if (threadIdx.x == G_PCUR) y = s.dec_cur[par];
    else if (threadIdx.x == G_PROPE) y = s.dec_rope1[par];
    else if (threadIdx.x == G_LBV && vok) y = lb[var];
    else if (threadIdx.x == G_UBV && vok) y = ub[var];
    if (threadIdx.x < G_N) sh[F_N + threadIdx.x] = y;
  }
  __syncthreads();

  // Decisions: every thread derives the same values.
  const int ph = sh[F_PHASE];
  const bool act = ph != TT_IDLE, in_dive = ph == TT_DIVE,
             in_solve = ph == TT_SOLVE;
  const bool bot = sh[F_BOT], ent = sh[F_ENT] && !bot;
  const bool held = sh[F_UNCONV] && !bot && !ent;
  const bool found = sh[F_FOUND];
  const int rem = sh[F_REM], sp = sh[F_SUBP], dep = sh[F_DEPTH];
  bool sol, leaf;
  if (s.enumerate_all) {
    const bool leftmost = (sp & sub32(shl32(1, rem), 1)) == 0;
    sol = ent && !found && (in_dive ? leftmost : true);
    leaf = bot || (ent && !found);
  } else {
    sol = ent;
    leaf = bot || sol;
  }
  const int objv = s.is_opt ? sh[F_OBJV] : 0;
  bool better;
  if (s.is_opt) {
    const int bb = sh[F_BB], eb = sh[F_EXT];
    better = objv < (bb < eb ? bb : eb);
  } else {
    better = s.enumerate_all || !sh[F_HASB];
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
  // Backtracking by ropes: after a push the last entry is the new one
  // (dec_cur 0, so t = depth + 1), else the parent's.
  const int pcur = sh[F_N + G_PCUR], prope = sh[F_N + G_PROPE];
  const int dep1 = solve_br ? dep + 1 : dep;
  const int t = solve_br ? dep1 : (pcur == 0 ? dep1 : prope);
  const bool bt = act && leaf && in_solve;
  const bool done_sub = bt && (dep1 == 0 || t == -1);
  const bool restore = bt && dep1 > 0 && t != -1;

  // Rows of the post-fixpoint store, before the child bound lands.
  if (impr)
    copy_rows<3>(s.best_lb + d * V, nullptr, lb, s.best_ub + d * V, nullptr,
                 ub, V, threadIdx.x, blockDim.x);
  if (snap) {  // block-uniform
    copy_rows<3>(s.root_lb + d * V, nullptr, lb, s.root_ub + d * V, nullptr,
                 ub, V, threadIdx.x, blockDim.x);
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    const int it = sh[F_ITERS];
    s.nodes[d] = add32(sh[F_NODES], act && !held);
    s.fails[d] = add32(sh[F_FAILS], act && bot);
    s.fpit[d] = add32(sh[F_FPIT], act ? it : 0);
    s.deds[d] = __fadd_rn(
        __int_as_float(sh[F_DEDS]),
        act ? __fmul_rn((float)it, __int_as_float(sh[F_PSCALE])) : 0.0f);
    const int tree_depth = add32(dep, sub32(sh[F_KPOW], rem));
    const int dm = sh[F_DMAX], dc = act ? tree_depth : 0;
    s.dmax[d] = dm > dc ? dm : dc;
    if (impr) {
      s.best_bound[d] = objv;
      s.has_best[d] = 1;
    }
    s.sols[d] = add32(sh[F_SOLS], impr);
    s.nonexh[d] = sh[F_NONEXH] || incomplete || ovf;

    // V. Dive branching.
    const int bit = (sp >> (rem - 1 > 0 ? rem - 1 : 0)) & 1;
    const int rem2 = dive_br ? rem - 1 : rem;
    s.remaining[d] = rem2;

    // VI. Solve branching: push the decision.
    const int strat0 = sh[F_STRAT0];
    const int snap_strat = snap ? strat0 : sh[F_SNAPS];
    const int var = sh[F_VAR];
    const int c0l = sh[F_C0L], c0u = sh[F_C0U], c1l = sh[F_C1L],
              c1u = sh[F_C1U];
    if (solve_br) {
      const long long dd = so + dep;  // dep < MAXD
      s.dec_var[dd] = var;
      s.dec_l0[dd] = c0l;
      s.dec_u0[dd] = c0u;
      s.dec_l1[dd] = c1l;
      s.dec_u1[dd] = c1u;
      s.dec_rope1[dd] = dep > 0 ? (pcur == 0 ? dep : prope) : -1;
      s.dec_cur[dd] = 0;
    }
    // The chosen child's bounds (dive: by path bit; solve: left).
    if (dive_br || solve_br) {
      const bool right = dive_br && bit == 1;
      const int el = right ? c1l : c0l, eu = right ? c1u : c0u;
      const int l = sh[F_N + G_LBV], u = sh[F_N + G_UBV];
      lb[var] = l > el ? l : el;
      ub[var] = u < eu ? u : eu;
    }

    // VII. Backtracking (the rebuild below).
    if (restore) s.dec_cur[so + clampi(t - 1, 0, MAXD - 1)] = 1;
    int strat = branching ? sh[F_NSTRAT] : strat0;
    if (restore) strat = snap_strat;
    s.strat[d] = strat;
    s.snap_strat[d] = snap_strat;
    s.depth[d] = restore ? t : dep1;

    // VIII. Dive leaves: skip the unreachable subtree.
    const bool dleaf = act && leaf && in_dive;
    const int nxt = shl32(add32(sp >> rem2, 1), rem2);
    const bool dleaf_left = dleaf && (sp & sub32(shl32(1, rem2), 1)) == 0;
    s.skipped_sub[d] = add32(sh[F_SKIP],
                             dleaf_left ? sub32(sub32(nxt, sp), 1) : 0);
    s.solved_sub[d] = add32(sh[F_SOLVED], done_sub || dleaf_left);
    s.want[d] = dleaf || done_sub;
    s.impr[d] = impr;
    s.dleaf[d] = dleaf;
    s.nxt[d] = nxt;
    // The shard scan reads the flags and best_bound of every lane.
    __threadfence();
    sh_last = atomicAdd(&s.tail_sync[3 + d / s.D], 1) == s.D - 1;
  }

  // Rebuild: the root snapshot met with decisions j < t at their current
  // child (decision t - 1 at its right child, which thread 0 flips).
  if (restore) {  // block-uniform
    // In place, the incumbent rows must be read before the store goes.
    if (impr && !use_smem) __syncthreads();
    int* L = use_smem ? smem : lb;
    int* U = use_smem ? smem + V : ub;
    copy_rows<3>(L, nullptr, s.root_lb + d * V, U, nullptr,
                 s.root_ub + d * V, V, threadIdx.x, blockDim.x);
    __syncthreads();
    for (int j = threadIdx.x; j < t; j += blockDim.x) {
      const int v = s.dec_var[so + j];
      const bool c1 = j == t - 1 || s.dec_cur[so + j] == 1;
      atomicMax(&L[v], c1 ? s.dec_l1[so + j] : s.dec_l0[so + j]);
      atomicMin(&U[v], c1 ? s.dec_u1[so + j] : s.dec_u0[so + j]);
    }
    __syncthreads();
    if (use_smem)
      copy_rows<3>(lb, nullptr, L, ub, nullptr, U, V, threadIdx.x,
                   blockDim.x);
  }
  __syncthreads();
  if (!sh_last) return;

  // The shard's last lane has posted: its scan, then the shards meet.
  __threadfence();
  const long long shard = d / s.D;
  int bm;
  const int any = shard_scan(s, shard, &bm);
  if (threadIdx.x == 0) {
    int* ts = s.tail_sync;
    if (any) atomicOr(&ts[1], 1);
    atomicMin(&ts[2], bm);
    ts[3 + shard] = 0;
    __threadfence();
    if (atomicAdd(&ts[0], 1) == s.S - 1) {
      const int ln = atomicExch(&ts[1], 0) != 0;
      const int bm = atomicExch(&ts[2], INT_MAX);
      *live_next = ln;
      *s.bmin = bm;
      ts[0] = 0;
      *s.steps += 1;
      xpublish(s, xpar, bm, ln);
    }
  }
}

__global__ void __launch_bounds__(TT_THREADS)
step_post_kernel(StepView s, const int* __restrict__ live,
                 int* __restrict__ live_next, int use_smem, int xpar) {
  step_post_body(s, live, live_next, use_smem, xpar);
}

// The post of a profiled chunk: the post's work, and the launch's span
// on the global timer in ``span``.
__global__ void __launch_bounds__(TT_THREADS)
step_post_timed_kernel(StepView s, const int* __restrict__ live,
                       int* __restrict__ live_next, int use_smem,
                       int xpar, long long* span) {
  span_begin(span);
  step_post_body(s, live, live_next, use_smem, xpar);
  span_end(span);
}

extern "C" int tt_step_head(const StepView* s, const int* prev_live,
                            const int* live, void* stream) {
  const int blocks = (s->S * s->D + TT_WARPS - 1) / TT_WARPS;
  step_head_kernel<<<blocks, TT_THREADS, 0, (cudaStream_t)stream>>>(
      *s, prev_live, live);
  return (int)cudaGetLastError();
}

// tt_step_head, and the launch's span into ``span`` (2 int64).
extern "C" int tt_step_head_timed(const StepView* s, const int* prev_live,
                                  const int* live, void* stream,
                                  long long* span) {
  const int blocks = (s->S * s->D + TT_WARPS - 1) / TT_WARPS;
  step_head_timed_kernel<<<blocks, TT_THREADS, 0, (cudaStream_t)stream>>>(
      *s, prev_live, live, span);
  return (int)cudaGetLastError();
}

// The post's dynamic shared memory for stores of V variables (the lane's
// two rows where they fit under smem_limit, else none), with the
// attribute of ``kernel`` (0 the post, 1 the timed post) set to it on the
// current device. Returns a CUDA error code.
static int post_smem(int kernel, int V, int smem_limit, size_t* smem,
                     int* use_smem) {
  static int attr_set[TT_MAX_DEVICES][2];
  *smem = 2 * sizeof(int) * (size_t)V;
  *use_smem = *smem <= (size_t)smem_limit;
  if (!*use_smem) *smem = 0;
  cudaError_t e;
  int* set = attr_slot(attr_set, &e);
  if (set == nullptr) return (int)e;
  if ((int)*smem + 1 != set[kernel]) {
    e = cudaFuncSetAttribute(kernel ? (const void*)step_post_timed_kernel
                                    : (const void*)step_post_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
    if (e != cudaSuccess) return (int)e;
    set[kernel] = (int)*smem + 1;
  }
  return 0;
}

// ``xpar``: the parity of the next step, whose slots the last block
// publishes into (card groups only).
extern "C" int tt_step_post(const StepView* s, const int* live,
                            int* live_next, int smem_limit, int xpar,
                            void* stream) {
  size_t smem;
  int use_smem;
  const int rc = post_smem(0, s->V, smem_limit, &smem, &use_smem);
  if (rc != 0) return rc;
  step_post_kernel<<<s->S * s->D, TT_THREADS, smem, (cudaStream_t)stream>>>(
      *s, live, live_next, use_smem, xpar);
  return (int)cudaGetLastError();
}

// tt_step_post, and the launch's span into ``span`` (2 int64).
extern "C" int tt_step_post_timed(const StepView* s, const int* live,
                                  int* live_next, int smem_limit,
                                  int xpar, void* stream, long long* span) {
  size_t smem;
  int use_smem;
  const int rc = post_smem(1, s->V, smem_limit, &smem, &use_smem);
  if (rc != 0) return rc;
  step_post_timed_kernel<<<s->S * s->D, TT_THREADS, smem,
                           (cudaStream_t)stream>>>(*s, live, live_next,
                                                   use_smem, xpar, span);
  return (int)cudaGetLastError();
}

// What the kernels' first launches would do for this plan: their module
// loads (cudaFuncGetAttributes loads a lazily loaded kernel) and the
// post's shared-memory attribute.
extern "C" int tt_step_load(const PlanView* p, int smem_limit) {
  const void* kernels[] = {
      (const void*)step_head_kernel, (const void*)step_post_kernel,
      (const void*)step_head_timed_kernel,
      (const void*)step_post_timed_kernel};
  for (const void* k : kernels) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, k);
    if (e != cudaSuccess) return (int)e;
  }
  size_t smem;
  int use_smem;
  for (int kernel = 0; kernel < 2; ++kernel) {
    const int rc = post_smem(kernel, p->V, smem_limit, &smem, &use_smem);
    if (rc != 0) return rc;
  }
  return 0;
}
