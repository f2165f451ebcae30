// K4: the table-row refill that seeds the first lanes of a search from
// the EPS subproblem-root table, in place, int32 throughout. Replaces the
// table seeding of turbo_tpu/solver/engine.py ``_init_state_impl``
// (696-704; the step's own refill, 1077-1084, runs in K6 head and K7
// copy): every lane d with refill[d] copies table row clip(idx[d], 0,
// n_pad - 1) into its store and its root snapshot.
//
// What bounds it on an H100: bytes. A refilled lane reads two rows of V
// words and writes four; there is no arithmetic. At golomb(12) (V =
// 2560) a refill of 266 of D = 512 lanes moves 16.3 MB: 0.0049 ms at
// 3.35 TB/s.
//
// Design: one block a lane; a lane without refill returns before it
// loads anything, so a refill costs only the lanes that take a new
// subproblem. A refilled lane moves its rows as 16-byte words (every
// row starts on a 16-byte boundary when V is a multiple of 4 and the
// planes are 16-byte aligned, as torch allocates them): neighbouring
// threads read and write neighbouring words, each thread issuing its
// loads of both rows before its four stores. Other shapes take the same
// loop 4 bytes at a time.
//
// K4's other former entry, the table build's parent gather (JAX
// ``_embed``), runs as the prologue of the table level entries
// (level.cuh).
#include "common.cuh"

template <class T>
__device__ __forceinline__ void refill_rows(const T* __restrict__ src_l,
                                            const T* __restrict__ src_u,
                                            T* lb, T* ub, T* root_lb,
                                            T* root_ub, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const T l = __ldg(src_l + k), u = __ldg(src_u + k);
    lb[k] = l;
    root_lb[k] = l;
    ub[k] = u;
    root_ub[k] = u;
  }
}

__global__ void __launch_bounds__(TT_THREADS)
table_refill_kernel(const int* __restrict__ tab_lb,
                    const int* __restrict__ tab_ub,
                    const int* __restrict__ idx,
                    const unsigned char* __restrict__ refill, int* lb,
                    int* ub, int* root_lb, int* root_ub, int n_pad, int V,
                    int vec) {
  const long long d = blockIdx.x;
  if (!refill[d]) return;
  int i = idx[d];
  i = i < 0 ? 0 : (i > n_pad - 1 ? n_pad - 1 : i);
  const long long s = (long long)i * V, t = d * V;
  if (vec) {
    refill_rows(reinterpret_cast<const int4*>(tab_lb + s),
                reinterpret_cast<const int4*>(tab_ub + s),
                reinterpret_cast<int4*>(lb + t),
                reinterpret_cast<int4*>(ub + t),
                reinterpret_cast<int4*>(root_lb + t),
                reinterpret_cast<int4*>(root_ub + t), V / 4);
  } else {
    refill_rows(tab_lb + s, tab_ub + s, lb + t, ub + t, root_lb + t,
                root_ub + t, V);
  }
}

extern "C" int tt_table_refill(const int* tab_lb, const int* tab_ub,
                               const int* idx, const unsigned char* refill,
                               int* lb, int* ub, int* root_lb, int* root_ub,
                               int D, int n_pad, int V, void* stream) {
  const uintptr_t a = (uintptr_t)tab_lb | (uintptr_t)tab_ub | (uintptr_t)lb |
                      (uintptr_t)ub | (uintptr_t)root_lb |
                      (uintptr_t)root_ub;
  const int vec = (V & 3) == 0 && (a & 15) == 0;
  table_refill_kernel<<<D, TT_THREADS, 0, (cudaStream_t)stream>>>(
      tab_lb, tab_ub, idx, refill, lb, ub, root_lb, root_ub, n_pad, V, vec);
  return (int)cudaGetLastError();
}

// What the kernel's first launch would do: its module load
// (cudaFuncGetAttributes loads a lazily loaded kernel).
extern "C" int tt_table_refill_load(const void*, int) {
  cudaFuncAttributes a;
  return (int)cudaFuncGetAttributes(&a, (const void*)table_refill_kernel);
}
