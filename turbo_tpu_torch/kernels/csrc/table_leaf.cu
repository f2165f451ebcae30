// K4's leaf entry: the EPS table's leaf level, written straight into the
// table's (n_pad, V) planes, int32 throughout. Replaces the leaf level of
// turbo_tpu/solver/eps_table.py ``build_table`` (its embed of each
// surviving parent's two children, the stable sort by bit-path and the
// padding with root rows, 325-386 there), which the JAX package runs in
// numpy on the host and then uploads.
//
// The host orders the live rows by bit-path and hands the kernel, per
// row r < n_live, (chunk, parent row, bit, path) as one int4, and per
// chunk of the last propagated level the eight pointers of its outputs
// (lb, ub, strat, var, c0l, c0u, c1l, c1u). Row r copies its parent's
// store and meets the parent's branch variable with the child interval
// that ``bit`` selects (max with c{bit}l into lb, min with c{bit}u into
// ub); its strat is max(strat, eps_skip) and its path the given one. A
// row r >= n_live takes the root box lb0 / ub0, strat 0 and path 0.
//
// What bounds it on an H100: bytes. A live row reads two rows of V words
// and writes two; a padding row writes two and reads the root box, which
// stays in L2. At golomb(8) with D = 1024 (n_pad = 4096, V = 640) a full
// table moves 42 MB: 0.0125 ms at 3.35 TB/s.
//
// Design: one block a row, as K4's refill. Rows move as 16-byte words
// where V is a multiple of 4 and every plane is 16-byte aligned (the
// wrapper checks the chunks' planes, which torch allocates so), 4-byte
// words otherwise: neighbouring threads read and write neighbouring
// words. The thread whose word holds the branch variable meets it in its
// registers before its store, so no word is written twice and the block
// needs no barrier. A row loads nothing beyond what it writes, its
// parent's four scalars aside.
#include "common.cuh"

// Meets the int at position j of the words l and u: max with cl into
// the lower bound, min with cu into the upper one.
__device__ __forceinline__ void meet(int& l, int& u, int, int cl, int cu) {
  l = l > cl ? l : cl;
  u = u < cu ? u : cu;
}
__device__ __forceinline__ void meet(int4& l, int4& u, int j, int cl,
                                     int cu) {
  if (j == 0) meet(l.x, u.x, 0, cl, cu);
  else if (j == 1) meet(l.y, u.y, 0, cl, cu);
  else if (j == 2) meet(l.z, u.z, 0, cl, cu);
  else meet(l.w, u.w, 0, cl, cu);
}

// Row copy src -> dst of n words of T (int or int4; E ints a word), the
// int at position v met with cl and cu (a v < 0 meets nothing).
template <class T, int E>
__device__ __forceinline__ void leaf_rows(const T* __restrict__ src_l,
                                          const T* __restrict__ src_u,
                                          T* dst_l, T* dst_u, int n, int v,
                                          int cl, int cu) {
  const int vw = v < 0 ? -1 : v / E, vj = v % E;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    T l = __ldg(src_l + k), u = __ldg(src_u + k);
    if (k == vw) meet(l, u, vj, cl, cu);
    dst_l[k] = l;
    dst_u[k] = u;
  }
}

template <class T, int E>
__device__ __forceinline__ void leaf_row(const long long* __restrict__ ptrs,
                                         const int4* __restrict__ rows,
                                         const int* lb0, const int* ub0,
                                         int* tab_lb, int* tab_ub,
                                         int* tab_strat, int* tab_path,
                                         int n_live, int V, int eps_skip) {
  const int r = blockIdx.x;
  const long long t = (long long)r * V;
  T* dl = reinterpret_cast<T*>(tab_lb + t);
  T* du = reinterpret_cast<T*>(tab_ub + t);
  if (r >= n_live) {
    leaf_rows<T, E>(reinterpret_cast<const T*>(lb0),
                    reinterpret_cast<const T*>(ub0), dl, du, V / E, -1, 0,
                    0);
    if (threadIdx.x == 0) {
      tab_strat[r] = 0;
      tab_path[r] = 0;
    }
    return;
  }
  const int4 q = __ldg(rows + r);  // (chunk, parent row, bit, path)
  const long long* p = ptrs + 8 * (long long)q.x;
  const int i = q.y;
  const int* strat = reinterpret_cast<const int*>(__ldg(p + 2));
  const int* var = reinterpret_cast<const int*>(__ldg(p + 3));
  const int* cl = reinterpret_cast<const int*>(__ldg(p + (q.z ? 6 : 4)));
  const int* cu = reinterpret_cast<const int*>(__ldg(p + (q.z ? 7 : 5)));
  const long long s = (long long)i * V;
  leaf_rows<T, E>(
      reinterpret_cast<const T*>(reinterpret_cast<const int*>(__ldg(p)) + s),
      reinterpret_cast<const T*>(reinterpret_cast<const int*>(__ldg(p + 1)) +
                                 s),
      dl, du, V / E, __ldg(var + i), __ldg(cl + i), __ldg(cu + i));
  if (threadIdx.x == 0) {
    const int st = __ldg(strat + i);
    tab_strat[r] = st > eps_skip ? st : eps_skip;
    tab_path[r] = q.w;
  }
}

__global__ void __launch_bounds__(TT_THREADS)
table_leaf_kernel(const long long* __restrict__ ptrs,
                  const int4* __restrict__ rows, const int* lb0,
                  const int* ub0, int* tab_lb, int* tab_ub, int* tab_strat,
                  int* tab_path, int n_live, int V, int eps_skip, int vec) {
  if (vec)
    leaf_row<int4, 4>(ptrs, rows, lb0, ub0, tab_lb, tab_ub, tab_strat,
                      tab_path, n_live, V, eps_skip);
  else
    leaf_row<int, 1>(ptrs, rows, lb0, ub0, tab_lb, tab_ub, tab_strat,
                     tab_path, n_live, V, eps_skip);
}

// ptrs: (n_chunks, 8) device addresses; rows: (n_live, 4) int32; vec: the
// wrapper's check that V % 4 == 0 and every plane is 16-byte aligned.
// Launches n_pad blocks on ``stream`` and does not synchronise.
extern "C" int tt_table_leaf(const long long* ptrs, const int* rows,
                             const int* lb0, const int* ub0, int* tab_lb,
                             int* tab_ub, int* tab_strat, int* tab_path,
                             int n_live, int n_pad, int V, int eps_skip,
                             int vec, void* stream) {
  table_leaf_kernel<<<n_pad, TT_THREADS, 0, (cudaStream_t)stream>>>(
      ptrs, reinterpret_cast<const int4*>(rows), lb0, ub0, tab_lb, tab_ub,
      tab_strat, tab_path, n_live, V, eps_skip, vec);
  return (int)cudaGetLastError();
}

// What the kernel's first launch would do: its module load
// (cudaFuncGetAttributes loads a lazily loaded kernel).
extern "C" int tt_table_leaf_load(const void*, int) {
  cudaFuncAttributes a;
  return (int)cudaFuncGetAttributes(&a, (const void*)table_leaf_kernel);
}
