// The EPS table build's level entries (K1's tt_fixpoint_level in
// fixpoint.cu, K8's tt_wac1_level in wac1.cu): one launch computes one
// frontier chunk of turbo_tpu/solver/eps_table.py ``dive_level``
// (122-142), one block per output row r:
// - the prologue is K4's old gather (``_embed``, 109-120): parent row
//   pidx[r] of the previous chunk, met at the parent's branch variable
//   with the child interval pbit[r] selects, copied straight into the
//   block's store (A and B), so that no parent-gathered row exists in
//   global memory;
// - the fixpoint is K1's or K8's sweep loop, unchanged;
// - the epilogue is K2's and K3's bodies (epilogue.cuh) on the block's
//   final store, with the gathered cursor strat_par[pidx[r]], and the
//   rest of dive_level's 13 outputs (``ent & ~bot``, ``strat2 = found ?
//   chosen : stp``, ``objlb = lb2[:, obj]``).
//
// What bounds the prologue on an H100: bytes, 8 V a row (two parent
// rows). On the shared-memory path, where V is a multiple of 4 and the
// planes start on 16-byte boundaries (a row is then 16-byte aligned and
// 4 V bytes long), thread 0 asks the TMA for the two rows as bulk copies
// into A, completing on an mbarrier; no thread spends registers or
// instructions on the copy, and the block waits on one barrier. Else (V
// not a multiple of 4, or A in global memory on the global path) the
// threads copy with the coalesced loop K1 loads with. Both are this
// kernel, chosen by shape.
#pragma once
#include "epilogue.cuh"

// One level's arguments, in the order of dive_level's parameters and
// its 13 outputs (each (W,) but the (W, V) planes). Mirrored by
// kernels.LevelView.
struct LevelView {
  const int* lb_par;  // (W, V) the previous chunk's stores
  const int* ub_par;
  const int* strat_par;  // (W,) its cursors, branch variables, children
  const int* var_par;
  const int* c0l;
  const int* c0u;
  const int* c1l;
  const int* c1u;
  const int* pidx;  // (W,) this chunk's parent rows and child bits
  const int* pbit;
  int* lb;  // (W, V) the propagated rows
  int* ub;
  int* strat;  // found ? chosen : the parent's cursor
  int* var;
  int* c0l_out;
  int* c0u_out;
  int* c1l_out;
  int* c1u_out;
  unsigned char* bot;
  unsigned char* ent;  // entailed and not bot
  unsigned char* found;
  int* iters;  // sweeps + 1 (0 without propagators)
  int* objlb;  // lb[obj]
  int obj;
};

// Row r's parent in the previous chunk, its branch variable and the
// child interval pbit[r] selects.
struct Parent {
  int row, var, cl, cu;
};

__device__ __forceinline__ Parent parent_of(const LevelView& lv,
                                            long long r) {
  const int p = __ldg(lv.pidx + r);
  const bool right = __ldg(lv.pbit + r) == 1;
  return {p, __ldg(lv.var_par + p), __ldg((right ? lv.c1l : lv.c0l) + p),
          __ldg((right ? lv.c1u : lv.c0u) + p)};
}

// A TMA bulk copy of ``bytes`` (a multiple of 16, both addresses 16-byte
// aligned) from global memory into shared memory, completing on the
// mbarrier at shared address ``bar``.
__device__ __forceinline__ void bulk_copy(int* dst, const int* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(
          (unsigned)__cvta_generic_to_shared(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The prologue: row r's parent row into A (al, au) and B (bl, bu), met
// at the branch variable. ``bulk``: A is in shared memory and the rows
// are 16-byte aligned, so they arrive by TMA. Every thread calls it; it
// returns this thread's OR of lb > ub over its variables. The caller
// synchronises before the block reads B or another thread's A.
__device__ __forceinline__ int gather_parent(const LevelView& lv,
                                             long long r, int V, int* al,
                                             int* au, int* bl, int* bu,
                                             bool bulk) {
  const Parent par = parent_of(lv, r);
  const int* src_l = lv.lb_par + (long long)par.row * V;
  const int* src_u = lv.ub_par + (long long)par.row * V;
  if (bulk) {
    __shared__ unsigned long long bar_word;
    const unsigned bar = (unsigned)__cvta_generic_to_shared(&bar_word);
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
              bar),
          "r"(8u * V)
          : "memory");
      bulk_copy(al, src_l, 4u * V, bar);
      bulk_copy(au, src_u, 4u * V, bar);
    }
    __syncthreads();  // the barrier is initialised before anyone waits
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, "
          "[%1], 0; selp.u32 %0, 1, 0, p; }"
          : "=r"(done)
          : "r"(bar)
          : "memory");
  }
  int b0 = 0;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    int l = bulk ? al[v] : __ldg(src_l + v);
    int u = bulk ? au[v] : __ldg(src_u + v);
    const bool at = v == par.var;
    if (at) {
      l = l > par.cl ? l : par.cl;
      u = u < par.cu ? u : par.cu;
    }
    if (!bulk || at) {
      al[v] = l;
      au[v] = u;
    }
    bl[v] = l;
    bu[v] = u;
    b0 |= l > u;
  }
  return b0;
}

// dive_level's outputs of row r but lb, ub and iters, from the block's
// final store (lb, ub), complete and visible to the block: K2's and K3's
// bodies from the parent's cursor. Every thread calls it.
__device__ __forceinline__ void level_epilogue(const PlanView& p,
                                               const int* lb, const int* ub,
                                               const LevelView& lv,
                                               long long r) {
  unsigned char bot = 0, ent = 0;
  classify_block(p, lb, ub, &bot, &ent);  // thread 0's bot and ent
  const int stp = __ldg(lv.strat_par + __ldg(lv.pidx + r));
  // K3's chosen strategy goes to strat; thread 0 keeps the parent's
  // cursor where no strategy had a splittable variable.
  select_block(p, lb, ub, stp,
               SelectOut{lv.found, lv.var, lv.strat, nullptr, lv.c0l_out,
                         lv.c0u_out, lv.c1l_out, lv.c1u_out},
               r);
  if (threadIdx.x == 0) {
    lv.bot[r] = bot;
    lv.ent[r] = ent && !bot;
    if (!lv.found[r]) lv.strat[r] = stp;
    lv.objlb[r] = lb[lv.obj];
  }
}

// The launch's 16-byte TMA rows: V a multiple of 4 and both parent
// planes 16-byte aligned.
static bool level_rows_aligned(const LevelView& lv, int V) {
  return (V & 3) == 0 && ((uintptr_t)lv.lb_par & 15) == 0 &&
         ((uintptr_t)lv.ub_par & 15) == 0;
}
