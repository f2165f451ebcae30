// K2: classify each dive's store, bot (some domain empty) and ent
// (every propagator entailed), one dive per thread block; the body is
// classify_block (classify.cuh), which K1's step entry also runs.
//
// Replaces PropagatorKernels.is_bot and all_entailed of
// turbo_tpu/solver/propagate_jax.py (see classify.cuh).
//
// What bounds it on an H100: one read of the store (2 V int32 a dive)
// and of the plan's rule tables; no arithmetic to speak of. Launch
// latency and the chains of dependent gathers dominate at small D.
//
// Design: the search step no longer launches it (K1's step entry runs
// the body on the store in its shared memory); the EPS table build,
// the hybrid rounds and the steps of the other propagation modes do.
// Each block first stages its dive's two rows into shared memory in one
// coalesced pass (16-byte loads; 20 KB at golomb(12)), so the rules'
// gathers wait on shared memory and not on L2. Rows above the default
// 48 KB of shared memory (V > 6144) are read where they lie.
#include "classify.cuh"

__global__ void __launch_bounds__(TT_THREADS)
classify_kernel(PlanView p, const int* __restrict__ lb_all,
                const int* __restrict__ ub_all, unsigned char* bot_out,
                unsigned char* ent_out, const int* live, int staged) {
  if (live != nullptr && *live == 0) return;  // every lane IDLE
  extern __shared__ int4 stage4[];
  const long long d = blockIdx.x;
  const int* lb = lb_all + d * p.V;
  const int* ub = ub_all + d * p.V;
  if (staged) {
    int* sl = reinterpret_cast<int*>(stage4);
    stage_store(lb, ub, sl, sl + p.V, p.V);
    lb = sl;
    ub = sl + p.V;
    __syncthreads();
  }
  classify_block(p, lb, ub, bot_out + d, ent_out + d);
}

extern "C" int tt_classify(const PlanView* p, const int* lb, const int* ub,
                           unsigned char* bot, unsigned char* ent, int D,
                           const int* live, void* stream) {
  const size_t smem = 8 * (size_t)p->V;
  const int staged = smem <= 48 * 1024;
  classify_kernel<<<D, TT_THREADS, staged ? smem : 0,
                    (cudaStream_t)stream>>>(*p, lb, ub, bot, ent, live,
                                            staged);
  return (int)cudaGetLastError();
}

// What the kernel's first launch would do: its module load
// (cudaFuncGetAttributes loads a lazily loaded kernel).
extern "C" int tt_classify_load(const void*, int) {
  cudaFuncAttributes a;
  return (int)cudaFuncGetAttributes(&a, (const void*)classify_kernel);
}
