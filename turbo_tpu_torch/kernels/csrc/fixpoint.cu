// K1: the propagation fixpoint of one dive per thread block.
//
// Replaces PropagatorKernels.fixpoint / iteration / _clamp_store of
// turbo_tpu/solver/propagate_jax.py (with _deduce_group, _inv_mul,
// _fwd_div, _linear_bucket_cands, _element_cands, _member_cands): AC-1
// sweeps until the dive's store stops changing, turns bot, or reaches
// the cap. Returns (lb, ub, iters, unconv) as the JAX function does.
//
// What bounds it on an H100: the sweep is gather-bound. Each sweep
// reads the store at ~6 places per propagator and writes 2 candidate
// words per role; the per-variable combine reads them back. The
// arithmetic is int32/int64 compares and a few divisions.
//
// Design: the block keeps its dive's two store planes (2 V int32) in
// shared memory when they fit (V up to ~28k on 227 KB), so the gathers
// of phase A hit shared memory; otherwise it works in place on the
// output rows in global memory. The candidate planes (2 n_cand int32)
// live in a global scratch row of the dive, written and read by the
// same block (L1/L2 resident at the shapes the engine runs). Sweeps are
// Jacobi, as in the JAX sweep: phase A computes every candidate from
// the current store; phase B combines them per variable (max of lb
// candidates, min of ub candidates over the CSR incidence list), folds
// singleton-tail conflicts into the dummy column and clamps to the root
// box, in place: a variable reads only candidates and its own old
// bounds. A dive stops at its own convergence; the JAX loop sweeps on
// until the last lane converges, which is idempotent on converged lanes
// (bot lanes may differ: the engine discards their store).
//
// In the search step (solver/step_cuda.py) the kernel runs in place
// (lb_in == lb_out: each block reads its own rows before it writes
// them) and returns at once when *live is 0 (every lane was IDLE when the
// step began); the EPS table build passes no live flag.
//
// Three entry points share the kernel:
// - tt_fixpoint: (D, V) planes, sweeps to the fixpoint or the cap;
// - tt_fixed_sweeps: (D, V) planes, exactly n sweeps with no exit on
//   convergence or bot, iters = n and unconv = 0
//   (PropagatorKernels.fixed_sweeps);
// - tt_fixpoint_t: dive-minor (V, D) planes (PropagatorKernels.fixpoint_t,
//   iteration_t and the *_cands_t rules, which compute the same values
//   as the (D, V) forms): dive d's element v lies at [v * D + d]. The
//   block gathers its strided column into shared memory, sweeps there
//   and scatters it back; when the store does not fit it sweeps the
//   strided column in place through a ``Plane``.
#include "common.cuh"

template <class S>
__device__ __forceinline__ void phase_a(const PlanView& p, const S& lb,
                                        const S& ub, int* cl, int* cu) {
  const int P = p.P, E = p.E, M = p.M;
  const int n_items = P + E + M + p.L;
  for (int it = threadIdx.x; it < n_items; it += blockDim.x) {
    if (it < P) cand_tnf(p, it, lb, ub, cl, cu);
    else if (it < P + E) cand_elem(p, it - P, lb, ub, cl, cu);
    else if (it < P + E + M) cand_member(p, it - P - E, lb, ub, cl, cu);
    else cand_linear(p, it - P - E - M, lb, ub, cl, cu);
  }
}

// The sweeps of one dive on its store lb / ub. ``fixed``: exactly cap
// sweeps. Returns the sweeps run; *m_out: still changing at the cap.
template <class S>
__device__ __forceinline__ int sweep_loop(const PlanView& p, const S& lb,
                                          const S& ub, int* cl, int* cu,
                                          int cap, int fixed, bool* m_out) {
  const int V = p.V;
  int iters = 0;
  bool m = true;
  for (int it = 0; (m || fixed) && it < cap; ++it) {
    phase_a(p, lb, ub, cl, cu);
    __syncthreads();
    // Singleton-tail conflict fold: a deduction (lo, hi) into a var
    // fixed at c conflicts iff lo > c or hi < c.
    int conf = 0;
    for (int k = threadIdx.x; k < p.n_conf; k += blockDim.x) {
      int s = p.conf_slot[k], off = p.conf_off[k];
      conf |= cl[s] > off || cu[s] < off;
    }
    conf = __syncthreads_or(conf) ? 1 : 0;
    int changed = 0, bot = 0;
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      int l0 = lb[v], u0 = ub[v];
      int l = l0, u = u0;
      if (v < p.n_active) {
        for (int k = p.inc_off[v]; k < p.inc_off[v + 1]; ++k) {
          int s = p.inc_slot[k];
          l = cl[s] > l ? cl[s] : l;
          u = cu[s] < u ? cu[s] : u;
        }
      } else if (v == V - 1 && p.n_conf > 0) {
        l = l > conf ? l : conf;
      }
      l = l < p.ub_cap[v] ? l : p.ub_cap[v];
      u = u > p.lb_floor[v] ? u : p.lb_floor[v];
      changed |= l != l0 || u != u0;
      bot |= l > u;
      lb[v] = l;
      ub[v] = u;
    }
    changed = __syncthreads_or(changed);
    bot = __syncthreads_or(bot);
    iters += 1;
    m = changed && !bot;
  }
  *m_out = m;
  return iters;
}

// ds / vs: the strides of the dive and of the variable in the planes
// ((D, V): V and 1; (V, D): 1 and D).
__global__ void __launch_bounds__(TT_THREADS)
fixpoint_kernel(PlanView p, const int* lb_in, const int* ub_in, int* lb_out,
                int* ub_out, int* iters_out, unsigned char* unconv_out,
                int* cand, int cap, int use_smem, const int* live,
                long long ds, long long vs, int fixed) {
  if (live != nullptr && *live == 0) return;
  extern __shared__ int smem[];
  const int V = p.V;
  const long long d = blockIdx.x;
  int* cl = cand + d * 2LL * p.n_cand;
  int* cu = cl + p.n_cand;
  const bool copy_in = lb_out != lb_in;
  if (use_smem || copy_in) {
    int* l = use_smem ? smem : lb_out + d * ds;
    int* u = use_smem ? smem + V : ub_out + d * ds;
    long long s = use_smem ? 1 : vs;
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      l[v * s] = lb_in[d * ds + v * vs];
      u[v * s] = ub_in[d * ds + v * vs];
    }
  }
  __syncthreads();
  int iters;
  bool m;
  if (use_smem) {
    int* sl = smem;
    int* su = smem + V;
    iters = sweep_loop(p, sl, su, cl, cu, cap, fixed, &m);
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      lb_out[d * ds + v * vs] = sl[v];
      ub_out[d * ds + v * vs] = su[v];
    }
  } else if (vs == 1) {
    int* gl = lb_out + d * ds;
    int* gu = ub_out + d * ds;
    iters = sweep_loop(p, gl, gu, cl, cu, cap, fixed, &m);
  } else {
    Plane lb{lb_out + d * ds, vs}, ub{ub_out + d * ds, vs};
    iters = sweep_loop(p, lb, ub, cl, cu, cap, fixed, &m);
  }
  if (threadIdx.x == 0) {
    iters_out[d] = fixed ? iters : iters + 1;
    unconv_out[d] = fixed ? 0 : m;
  }
}

static int launch(const PlanView* p, const int* lb_in, const int* ub_in,
                  int* lb_out, int* ub_out, int* iters, unsigned char* unconv,
                  int* cand, int D, int cap, int smem_limit, const int* live,
                  void* stream, long long ds, long long vs, int fixed) {
  static int attr_set = -1;
  size_t smem = 2 * sizeof(int) * (size_t)p->V;
  int use_smem = smem <= (size_t)smem_limit;
  if (!use_smem) smem = 0;
  if ((int)smem > attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fixpoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = (int)smem;
  }
  fixpoint_kernel<<<D, TT_THREADS, smem, (cudaStream_t)stream>>>(
      *p, lb_in, ub_in, lb_out, ub_out, iters, unconv, cand, cap, use_smem,
      live, ds, vs, fixed);
  return (int)cudaGetLastError();
}

extern "C" int tt_fixpoint(const PlanView* p, const int* lb_in,
                           const int* ub_in, int* lb_out, int* ub_out,
                           int* iters, unsigned char* unconv, int* cand,
                           int D, int cap, int smem_limit, const int* live,
                           void* stream) {
  return launch(p, lb_in, ub_in, lb_out, ub_out, iters, unconv, cand, D, cap,
                smem_limit, live, stream, p->V, 1, 0);
}

extern "C" int tt_fixed_sweeps(const PlanView* p, const int* lb_in,
                               const int* ub_in, int* lb_out, int* ub_out,
                               int* iters, unsigned char* unconv, int* cand,
                               int D, int n, int smem_limit, const int* live,
                               void* stream) {
  return launch(p, lb_in, ub_in, lb_out, ub_out, iters, unconv, cand, D, n,
                smem_limit, live, stream, p->V, 1, 1);
}

extern "C" int tt_fixpoint_t(const PlanView* p, const int* lb_in,
                             const int* ub_in, int* lb_out, int* ub_out,
                             int* iters, unsigned char* unconv, int* cand,
                             int D, int cap, int smem_limit, const int* live,
                             void* stream) {
  return launch(p, lb_in, ub_in, lb_out, ub_out, iters, unconv, cand, D, cap,
                smem_limit, live, stream, 1, D, 0);
}

extern "C" const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
