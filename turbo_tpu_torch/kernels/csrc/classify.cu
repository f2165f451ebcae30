// K2: classify each dive's store: bot (some domain empty) and ent
// (every propagator entailed), one dive per thread block.
//
// Replaces PropagatorKernels.is_bot and all_entailed of
// turbo_tpu/solver/propagate_jax.py (with _ask_group, _linear_ask_all,
// _element_ask, _member_ask). `ent` is not masked by `bot`; the engine
// does that, as the JAX step does.
//
// What bounds it on an H100: one pass of gathers over the store (about
// 3 reads per propagator, K per linear row, T per element row) and a
// block-wide AND; no arithmetic to speak of. Launch latency dominates
// at small D.
//
// Design: threads stride over the V variables (bot) and then over all
// rows of every family, padding rows included (they are entailed by
// construction, as in the JAX sum over padded groups); two block
// reductions (__syncthreads_or / __syncthreads_and) give the answers.
// The store is read from global memory: each word is read a few times
// per launch, so L1 serves the repeats.
#include "common.cuh"

__global__ void __launch_bounds__(TT_THREADS)
classify_kernel(PlanView p, const int* __restrict__ lb_all,
                const int* __restrict__ ub_all, unsigned char* bot_out,
                unsigned char* ent_out, const int* live) {
  if (live != nullptr && *live == 0) return;  // every lane IDLE
  const long long d = blockIdx.x;
  const int* lb = lb_all + d * p.V;
  const int* ub = ub_all + d * p.V;
  int bot = 0;
  for (int v = threadIdx.x; v < p.V; v += blockDim.x) bot |= lb[v] > ub[v];
  int ok = 1;
  if (p.P > 0) {
    for (int i = threadIdx.x; i < p.P && ok; i += blockDim.x) {
      int x = p.px[i], y = p.py[i], z = p.pz[i];
      ok = ask(p.prop_op[i], lb[x], ub[x], lb[y], ub[y], lb[z], ub[z]);
    }
    for (int i = threadIdx.x; i < p.E && ok; i += blockDim.x)
      ok = elem_ask(p, i, lb, ub);
    for (int i = threadIdx.x; i < p.M && ok; i += blockDim.x)
      ok = member_ask(p, i, lb, ub);
    for (int r = threadIdx.x; r < p.L && ok; r += blockDim.x)
      ok = lin_ask(p, r, lb, ub);
  }
  bot = __syncthreads_or(bot);
  ok = __syncthreads_and(ok);
  if (threadIdx.x == 0) {
    bot_out[d] = bot != 0;
    ent_out[d] = ok != 0;
  }
}

extern "C" int tt_classify(const PlanView* p, const int* lb, const int* ub,
                           unsigned char* bot, unsigned char* ent, int D,
                           const int* live, void* stream) {
  classify_kernel<<<D, TT_THREADS, 0, (cudaStream_t)stream>>>(*p, lb, ub,
                                                                bot, ent, live);
  return (int)cudaGetLastError();
}
