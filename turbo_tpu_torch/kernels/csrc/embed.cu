// K4: row gathers of the EPS subproblem-root table, int32 throughout,
// one thread block per output row, threads striding over the V
// variables. Two entry points:
//
// - tt_embed replaces `_embed` of turbo_tpu/solver/eps_table.py:109-120
//   (the first stage of `dive_level`): row r copies parent row pidx[r]
//   of the previous frontier chunk and meets the parent's branch
//   variable with the child interval that pbit[r] selects.
// - tt_table_refill replaces the table-refill gathers of
//   BatchedSolver.step, turbo_tpu/solver/engine.py:1077-1084: every lane
//   with refill[d] copies table row clip(idx[d], 0, n_pad - 1) into its
//   store and its root snapshot, in place.
//
// What bounds it on an H100: bytes. A row is V words read and two
// planes of V words written (four for the refill); there is no
// arithmetic to speak of. At golomb(12) (V = 2560) an embed of W = 512
// rows moves about 15 MB, a refill of D = 512 lanes at most 31 MB.
//
// Design: neighbouring threads read and write neighbouring words, so
// every access is coalesced; the per-row scalars (parent index, branch
// variable, child interval) are read once per thread from L1. A lane
// without refill returns before touching its row, so a refill costs
// only the lanes that take a new subproblem.
#include "common.cuh"

__global__ void __launch_bounds__(TT_THREADS)
embed_kernel(const int* __restrict__ lb_par, const int* __restrict__ ub_par,
             const int* __restrict__ strat_par,
             const int* __restrict__ var_par, const int* __restrict__ c0l,
             const int* __restrict__ c0u, const int* __restrict__ c1l,
             const int* __restrict__ c1u, const int* __restrict__ pidx,
             const int* __restrict__ pbit, int* lbp, int* ubp, int* stp,
             int V) {
  const long long r = blockIdx.x;
  const long long p = pidx[r];
  const int var = var_par[p];
  const bool right = pbit[r] == 1;
  const int cl = right ? c1l[p] : c0l[p];
  const int cu = right ? c1u[p] : c0u[p];
  const int* src_l = lb_par + p * V;
  const int* src_u = ub_par + p * V;
  int* dst_l = lbp + r * V;
  int* dst_u = ubp + r * V;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    int l = src_l[v], u = src_u[v];
    if (v == var) {
      l = l > cl ? l : cl;
      u = u < cu ? u : cu;
    }
    dst_l[v] = l;
    dst_u[v] = u;
  }
  if (threadIdx.x == 0) stp[r] = strat_par[p];
}

__global__ void __launch_bounds__(TT_THREADS)
table_refill_kernel(const int* __restrict__ tab_lb,
                    const int* __restrict__ tab_ub,
                    const int* __restrict__ idx,
                    const unsigned char* __restrict__ refill, int* lb,
                    int* ub, int* root_lb, int* root_ub, int n_pad, int V) {
  const long long d = blockIdx.x;
  if (!refill[d]) return;
  int i = idx[d];
  i = i < 0 ? 0 : (i > n_pad - 1 ? n_pad - 1 : i);
  const int* src_l = tab_lb + (long long)i * V;
  const int* src_u = tab_ub + (long long)i * V;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    const int l = src_l[v], u = src_u[v];
    lb[d * V + v] = l;
    root_lb[d * V + v] = l;
    ub[d * V + v] = u;
    root_ub[d * V + v] = u;
  }
}

extern "C" int tt_embed(const int* lb_par, const int* ub_par,
                        const int* strat_par, const int* var_par,
                        const int* c0l, const int* c0u, const int* c1l,
                        const int* c1u, const int* pidx, const int* pbit,
                        int* lbp, int* ubp, int* stp, int W, int V,
                        void* stream) {
  embed_kernel<<<W, TT_THREADS, 0, (cudaStream_t)stream>>>(
      lb_par, ub_par, strat_par, var_par, c0l, c0u, c1l, c1u, pidx, pbit,
      lbp, ubp, stp, V);
  return (int)cudaGetLastError();
}

extern "C" int tt_table_refill(const int* tab_lb, const int* tab_ub,
                               const int* idx, const unsigned char* refill,
                               int* lb, int* ub, int* root_lb, int* root_ub,
                               int D, int n_pad, int V, void* stream) {
  table_refill_kernel<<<D, TT_THREADS, 0, (cudaStream_t)stream>>>(
      tab_lb, tab_ub, idx, refill, lb, ub, root_lb, root_ub, n_pad, V);
  return (int)cudaGetLastError();
}
