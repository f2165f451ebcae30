// K3: branch selection and the two children, one dive per thread block;
// the body is select_block (select.cuh), which K1's step entry also
// runs.
//
// Replaces BatchedSolver._select and _children of
// turbo_tpu/solver/engine.py (see select.cuh).
//
// What bounds it on an H100: one gather of (lb, ub) per listed variable
// of the strategies walked, and one block argmin each. Usually only the
// cursor's strategy is read.
//
// Design: the search step no longer launches it (K1's step entry runs
// the body on the store in its shared memory); the EPS table build and
// the steps of the other propagation modes do. Each block first stages
// its dive's two rows into shared memory in one coalesced pass (16-byte
// loads), as K2 does, so the argmin's gathers wait on shared memory.
// Rows above the default 48 KB of shared memory (V > 6144) are read
// where they lie.
#include "select.cuh"

__global__ void __launch_bounds__(TT_THREADS)
select_kernel(PlanView p, const int* __restrict__ lb_all,
              const int* __restrict__ ub_all, const int* __restrict__ strat,
              SelectOut o, const int* live, int staged) {
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
  select_block(p, lb, ub, strat[d], o, d);
}

extern "C" int tt_select(const PlanView* p, const int* lb, const int* ub,
                         const int* strat, unsigned char* found, int* var,
                         int* chosen, int* valo, int* c0l, int* c0u,
                         int* c1l, int* c1u, int D, const int* live,
                         void* stream) {
  const size_t smem = 8 * (size_t)p->V;
  const int staged = smem <= 48 * 1024;
  const SelectOut o{found, var, chosen, valo, c0l, c0u, c1l, c1u};
  select_kernel<<<D, TT_THREADS, staged ? smem : 0, (cudaStream_t)stream>>>(
      *p, lb, ub, strat, o, live, staged);
  return (int)cudaGetLastError();
}

// What the kernel's first launch would do: its module load
// (cudaFuncGetAttributes loads a lazily loaded kernel).
extern "C" int tt_select_load(const void*, int) {
  cudaFuncAttributes a;
  return (int)cudaFuncGetAttributes(&a, (const void*)select_kernel);
}
