// K2's body: classify one dive's store, bot (some domain empty) and ent
// (every propagator entailed), on a whole thread block. K2's own kernel
// (classify.cu) runs it on a store staged into shared memory; K1's step
// entry (fixpoint.cu) runs it on the store its block already holds.
//
// Replaces PropagatorKernels.is_bot and all_entailed of
// turbo_tpu/solver/propagate_jax.py (with _ask_group, _linear_ask_all,
// _element_ask, _member_ask). `ent` is not masked by `bot`; the engine
// does that, as the JAX step does.
//
// Threads stride over the V variables (bot), then over all rows of
// every family, padding rows included (they are entailed by
// construction, as in the JAX sum over padded groups). A TNF rule loads
// (op, x, y, z) as one int4 through the read-only path. The entailment
// loops stop on a shared "some rule failed" word, read in every
// iteration without a barrier: the answer is an AND, so a thread that
// stops early because another failed cannot change it, and with no
// failure every rule is asked.
#pragma once
#include "common.cuh"

// Every thread of the block calls it (two block barriers); thread 0
// writes *bot_out and *ent_out. lb, ub: the dive's store (shared or
// global memory), complete and visible to the whole block on entry.
__device__ __forceinline__ void classify_block(const PlanView& p,
                                               const int* lb, const int* ub,
                                               unsigned char* bot_out,
                                               unsigned char* ent_out) {
  __shared__ int failed;
  if (threadIdx.x == 0) failed = 0;
  int bot = 0;
  for (int v = threadIdx.x; v < p.V; v += blockDim.x) bot |= lb[v] > ub[v];
  bot = __syncthreads_or(bot);  // also publishes failed = 0
  volatile int* stop = &failed;
  int ok = 1;
  if (p.P > 0) {
    for (int i = threadIdx.x; i < p.P && ok && !*stop; i += blockDim.x) {
      const int4 r = __ldg(p.tnf4 + i);  // (op, x, y, z)
      ok = ask(r.x, lb[r.y], ub[r.y], lb[r.z], ub[r.z], lb[r.w], ub[r.w]);
    }
    for (int i = threadIdx.x; i < p.E && ok && !*stop; i += blockDim.x)
      ok = elem_ask(p, i, lb, ub);
    for (int i = threadIdx.x; i < p.M && ok && !*stop; i += blockDim.x)
      ok = member_ask(p, i, lb, ub);
    for (int r = threadIdx.x; r < p.L && ok && !*stop; r += blockDim.x)
      ok = lin_ask(p, r, lb, ub);
    if (!ok) *stop = 1;
  }
  ok = __syncthreads_and(ok);
  if (threadIdx.x == 0) {
    *bot_out = bot != 0;
    *ent_out = ok != 0;
  }
}
