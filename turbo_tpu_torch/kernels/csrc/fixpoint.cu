// K1: the propagation fixpoint of one dive per thread block.
//
// Replaces PropagatorKernels.fixpoint / iteration / _clamp_store of
// turbo_tpu/solver/propagate_jax.py (517-601, 912-965; with the rules
// _deduce_group, _inv_mul, _fwd_div, _linear_bucket_cands,
// _element_cands, _member_cands in common.cuh): AC-1 sweeps until the
// dive's store stops changing, turns bot, or reaches the cap. Returns
// (lb, ub, iters, unconv) as the JAX function does.
//
// What bounds it on an H100: neither bytes nor arithmetic (a golomb(12)
// launch at D = 512 moves about 10 MB and its sweeps do a few G int32
// operations: a bound near 0.006 ms). It is latency: one block per dive
// runs up to cap dependent sweeps (at cap 16 most launches run all 16),
// each a pass over the rules and the variables between block barriers,
// four blocks per SM at golomb(12), and every rule waits on loads of the
// plan's tables from L2 (the blocks' shared memory leaves the SM little
// L1). The design cuts what a sweep waits on: global round trips,
// barriers, and rules that need not run.
//
// Design. A sweep is Jacobi, as the JAX sweep: every candidate comes
// from the store as the sweep found it. JAX gathers each variable's
// candidates and combines them with max / min; max and min are
// associative and commutative, so scattering each candidate into a
// second copy of the store with atomicMax / atomicMin gives the same
// integers in any order (a scatter-meet).
// - The block keeps two copies of its dive's store in shared memory, A
//   (read by the rules) and B (met into), 4 V int32, a worklist of P
//   int32 and a byte per variable that says it moved in the sweep
//   before: 53 KB at golomb(12). Each candidate slot is routed by
//   slot_tgt (code, value), the exact inverse of the plan's incidence
//   lists and conflict fold (built in kernels/__init__.py): a slot
//   aimed at an active variable is met into B; one aimed at the
//   root-fixed singleton tail is folded against the fixed value it
//   carries, and a conflict raises the dummy column's lb to 1 (the JAX
//   fold, met like any candidate); the rest is dropped. A candidate not
//   above A's bound cannot move B (B starts each sweep equal to A and
//   only tightens) and skips its atomic; most candidates do. No
//   candidate plane exists in global memory (the JAX layout's 2 n_cand
//   words per dive, written and read back every sweep, was the old
//   kernel's largest traffic).
// - One pass over the variables then clamps B to the root box, writes
//   the result into both A and B (the next sweep needs no copy), marks
//   the variables that moved, and ORs "changed" and "bot" into a flag
//   word of the sweep's parity (warp-reduced first; thread 0 clears the
//   other word). After the first sweep A lies inside the box, so a
//   variable that no candidate moved needs neither the box nor a write.
// - From the second sweep of a launch on, a rule runs only if one of
//   its variables moved in the sweep before: x, y, z of a TNF
//   propagator; idx, res of an element row; x, b of a membership row;
//   the terms and b of a linear row. This is exact: the skipped rule's
//   candidate is the one it gave when it last ran, and the store has
//   absorbed that one. From the first clamp on, lb only grows and stays
//   at or below ub0 + 1, so min(max(lb, c), ub0 + 1) is lb again; the
//   same holds for ub. So every sweep's store, changed, bot, iters and
//   unconv are bit for bit those of the full sweep. The first sweep runs
//   every rule: the kernel does not know what moved before the launch.
//   The TNF propagators to run are first gathered into the worklist (a
//   ballot per warp), so that they run on dense warps: at golomb(12)
//   from a few to three quarters of them run in a sweep, spread over
//   most warps of a strided loop. So a sweep after the first has three
//   barriers and the first two (the gather-combine took five). Built with
//   -DTT_NO_SKIP every sweep runs every rule (only chip_smoke.py
//   builds that variant, to time the skip against it).
// - The TNF propagators, most of the work, load (op, x, y, z) as one
//   int4 through the read-only path; a linear row loads a packed header
//   and (coef, var) per term. The element, membership and linear rows
//   follow in loops of their own on the threads after the last TNF
//   rule's, so no warp iteration mixes a 3-variable rule with a K-term
//   row or a T-entry scan. Measured and dropped (PERF.md): the rows on
//   warps of their own, the TNF loads issued four at a time, marking
//   the rules through a variable-to-rule CSR in place of the worklist's
//   scan, and 384 or 512 threads per block; none beat this build (256
//   threads, 4 blocks per SM by registers and shared memory) at
//   golomb(12) by more than the spread of the readings. The packed TNF
//   table (16 P bytes, 44 KB at golomb(12)) stays in global memory:
//   staged in shared memory it would cost a block per SM.
// - Large stores: when the block's shared memory cannot hold them (V
//   above about 13k at golomb(12)'s P), the same algorithm runs with A
//   in the output rows and B, the worklist and the marks in a global
//   scratch row of the dive, met by global atomics. ``smem=False``
//   forces that path, and chip_smoke.py holds it to the plain version.
// A dive stops at its own convergence; the JAX loop sweeps on until the
// last lane converges, which is idempotent on converged lanes (bot lanes
// may differ: the engine discards their store).
//
// In the search step (solver/step_cuda.py) the kernel runs in place
// (lb_in == lb_out: each block reads its own rows before it writes
// them) and returns at once when *live is 0 (every lane was IDLE when the
// step began); the hybrid rounds pass no live flag. It allocates
// nothing, so a chunk of steps is captured into a CUDA graph.
//
// Five entry points share the kernel's sweeps:
// - tt_fixpoint: (D, V) planes, sweeps to the fixpoint or the cap;
// - tt_fixed_sweeps: (D, V) planes, exactly n sweeps with no exit on
//   convergence or bot, iters = n and unconv = 0
//   (PropagatorKernels.fixed_sweeps); the skip stays exact there, since
//   a sweep after bot or convergence is still monotone;
// - tt_fixpoint_t: dive-minor (V, D) planes (PropagatorKernels.fixpoint_t,
//   iteration_t and the *_cands_t rules, which compute the same values
//   as the (D, V) forms): dive d's element v lies at [v * D + d]. The
//   block gathers its strided column into shared memory, sweeps there
//   and scatters it back; on the global path A is the strided column
//   itself, read and written through a ``Plane``;
// - tt_fixpoint_step, the search step's launch (a kernel of its own,
//   fixpoint_step_kernel): tt_fixpoint, then K2's and K3's bodies
//   (classify.cuh, select.cuh) on the block's final store, A in shared
//   memory (or the output rows on the global path), so that the step
//   needs no launch of K2 or K3 and reads the store back from nowhere.
//   On a bot lane the store is K1's, as the separate launches read it.
//   It is built for at most 64 registers, to keep four blocks per SM;
// - tt_fixpoint_level, one level of the EPS table build
//   (fixpoint_level_kernel, level.cuh): K4's parent gather as the load
//   stage (by TMA into shared memory), the sweeps, then K2's and K3's
//   bodies and the rest of dive_level's outputs, so that a table level
//   is one launch. Also at most 64 registers.
// tt_fixpoint_load does what each kernel's first launch would (its
// module load and shared-memory attribute), so that the solver pays it
// when it is built and not inside the -t window.
#include "level.cuh"

#ifdef TT_NO_SKIP
#define TT_K1_SKIP 0
#else
#define TT_K1_SKIP 1
#endif

// The int32 words of a dive's global scratch row: B (2 V), the worklist
// (P) and the marks (V bytes).
__host__ __device__ __forceinline__ long long scratch_words(
    const PlanView& p) {
  return 2LL * p.V + p.P + (p.V + 3) / 4;
}

// Dynamic shared memory: the flag words (16 bytes: changed / bot of two
// sweep parities and the worklist's length), and on the shared-memory
// path A, B (4 V int32), the worklist (P int32) and the marks (V bytes,
// rounded up to 16). Mirrored by kernels.fixpoint_smem_bytes.
static size_t smem_bytes(const PlanView& p) {
  return 16 + 16 * (size_t)p.V + 4 * (size_t)p.P +
         ((size_t)p.V + 15) / 16 * 16;
}

// Meets a rule's candidate (lo, hi) for slot s into B, routed by
// slot_tgt (the target variable that the rules hand beside the slot is
// not read); A is the store the sweep reads.
template <class S>
struct Meet {
  S al, au;
  int* bl;
  int* bu;
  const int2* __restrict__ tgt;
  int dummy;
  __device__ __forceinline__ void operator()(int s, int, int lo,
                                            int hi) const {
    const int2 t = __ldg(tgt + s);
    if (t.x >= 0) {
      if (lo > al[t.x]) atomicMax(bl + t.x, lo);
      if (hi < au[t.x]) atomicMin(bu + t.x, hi);
    } else if (t.x != TT_UNREAD) {
      // A deduction (lo, hi) into a var fixed at c = t.y conflicts iff
      // lo > c or hi < c.
      if ((lo > t.y || hi < t.y) && al[dummy] < 1) atomicMax(bl + dummy, 1);
    }
  }
};

// The first item of this thread in a loop that continues the block's
// strided assignment after ``before`` items: item i runs on thread
// (before + i) % blockDim.x.
__device__ __forceinline__ int first_item(int before) {
  return (threadIdx.x + blockDim.x - before % blockDim.x) % blockDim.x;
}

// Phase A of a sweep: every rule (``all``), or every rule with a marked
// variable, computes its candidates from A and meets them into B. The
// TNF propagators to run are first gathered into the worklist wl
// (length *wn), so that their evaluation runs on dense warps: after the
// first sweep only a fifth to a half of golomb(12)'s propagators run,
// but spread so that nearly every warp of a strided loop would hold one.
template <class S>
__device__ __forceinline__ void phase_a(const PlanView& p, const Meet<S>& out,
                                        const unsigned char* mk, int* wl,
                                        int* wn, bool all) {
  const S& lb = out.al;
  const S& ub = out.au;
  const int P = p.P, E = p.E, M = p.M;
  if (!all) {
    // Whole warps take part in each round (the ballot).
    for (int base = 0; base < P; base += blockDim.x) {
      const int i = base + threadIdx.x;
      bool run = false;
      if (i < P) {
        const int4 r = __ldg(p.tnf4 + i);
        run = mk[r.y] | mk[r.z] | mk[r.w];
      }
      const unsigned ball = __ballot_sync(0xffffffffu, run);
      const int lane = threadIdx.x & 31;
      int at = 0;
      if (lane == 0 && ball) at = atomicAdd(wn, __popc(ball));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (run) wl[at + __popc(ball & ((1u << lane) - 1))] = i;
    }
    __syncthreads();
  }
  const int n = all ? P : *wn;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int i = all ? k : wl[k];
    const int4 r = __ldg(p.tnf4 + i);  // (op, x, y, z)
    int c[6];
    deduce(r.x, lb[r.y], ub[r.y], lb[r.z], ub[r.z], lb[r.w], ub[r.w], c);
    out(i, r.y, c[0], c[1]);
    out(P + i, r.z, c[2], c[3]);
    out(2 * P + i, r.w, c[4], c[5]);
  }
  // The rows follow on the threads after the last TNF rule's.
  for (int i = first_item(n); i < E; i += blockDim.x)
    if (all || (mk[__ldg(p.e_idx + i)] | mk[__ldg(p.e_res + i)]))
      cand_elem(p, i, lb, ub, out);
  for (int i = first_item(n + E); i < M; i += blockDim.x)
    if (all || (mk[__ldg(p.m_x + i)] | mk[__ldg(p.m_b + i)]))
      cand_member(p, i, lb, ub, out);
  for (int r = first_item(n + E + M); r < p.L; r += blockDim.x) {
    const int4 h = __ldg(p.l_head + r);  // (flags | op << 2, toff, K, b)
    bool run = all || mk[h.w];
    for (int t = 0; !run && t < h.z; ++t)
      run = mk[__ldg(p.l_term + h.y + t).y];
    if (run) cand_linear(p, r, lb, ub, out);
  }
}

// The sweeps of one dive on stores A (al, au) and B (bl, bu), equal on
// entry, with the marks mk and the two flag words. ``fixed``: exactly
// cap sweeps. Returns the sweeps run; *m_out: still changing at the cap.
template <class S>
__device__ __forceinline__ int sweep_loop(const PlanView& p, S al, S au,
                                          int* bl, int* bu, int* wl,
                                          unsigned char* mk, int* flag,
                                          int cap, int fixed, bool* m_out) {
  const Meet<S> out{al, au, bl, bu, p.slot_tgt, p.V - 1};
  int iters = 0;
  bool m = true;
  for (int it = 0; (m || fixed) && it < cap; ++it) {
    phase_a(p, out, mk, wl, flag + 2, !TT_K1_SKIP || it == 0);
    __syncthreads();
    // Clamp to the root box; A and B take the result; bit 0: changed,
    // bit 1: bot. After the first sweep A lies inside the clamp, so a
    // variable no candidate moved (B == A) needs neither the root box
    // nor a write.
    unsigned f = 0;
    for (int v = threadIdx.x; v < p.V; v += blockDim.x) {
      const int l0 = al[v], u0 = au[v];
      int l = bl[v], u = bu[v];
      bool ch = false;
      if (it == 0 || l != l0 || u != u0) {
        const int hi = __ldg(p.ub_cap + v), lo = __ldg(p.lb_floor + v);
        l = l < hi ? l : hi;
        u = u > lo ? u : lo;
        ch = l != l0 || u != u0;
        if (ch) {
          al[v] = l;
          au[v] = u;
        }
        bl[v] = l;
        bu[v] = u;
      }
      if (TT_K1_SKIP) mk[v] = ch;
      f |= (ch ? 1u : 0u) | (l > u ? 2u : 0u);
    }
    f = __reduce_or_sync(0xffffffffu, f);
    if ((threadIdx.x & 31) == 0 && f) atomicOr(flag + (it & 1), (int)f);
    // Every thread read the other word, and the worklist's length,
    // before this sweep's phase A ended.
    if (threadIdx.x == 0) {
      flag[(it + 1) & 1] = 0;
      flag[2] = 0;
    }
    __syncthreads();
    f = flag[it & 1];
    iters += 1;
    m = (f & 1) && !(f & 2);
  }
  *m_out = m;
  return iters;
}

// The kernel's body. ds / vs: the strides of the dive and of the
// variable in the planes ((D, V): V and 1; (V, D): 1 and D). scratch:
// (D, scratch_words(p)) int32, read only on the global path. STEP: the
// step entry (only (D, V) planes), which ends with step_epilogue. STAMP:
// the stamped step entry, which also writes the block's clock stamps
// (epilogue.cuh) into ``stamps``.
template <bool STEP, bool STAMP = false>
__device__ __forceinline__ void fixpoint_body(
    const PlanView& p, const int* lb_in, const int* ub_in, int* lb_out,
    int* ub_out, int* iters_out, unsigned char* unconv_out, int* scratch,
    int cap, int use_smem, const int* live, long long ds, long long vs,
    int fixed, const StepOut& so, long long* stamps = nullptr) {
  if (live != nullptr && *live == 0) return;
  extern __shared__ int smem[];
  const int V = p.V;
  const long long d = blockIdx.x;
  if constexpr (STAMP) stamp_start(stamps, d);
  int* flag = smem;
  int* al = smem + 4;
  int* au = al + V;
  int* bl = au + V;
  if (!use_smem) bl = scratch + d * scratch_words(p);
  int* bu = bl + V;
  int* wl = bu + V;
  unsigned char* mk = reinterpret_cast<unsigned char*>(wl + p.P);
  const bool copy_in = lb_out != lb_in;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    const int l = lb_in[d * ds + v * vs], u = ub_in[d * ds + v * vs];
    bl[v] = l;
    bu[v] = u;
    if (use_smem) {
      al[v] = l;
      au[v] = u;
    } else if (copy_in) {
      lb_out[d * ds + v * vs] = l;
      ub_out[d * ds + v * vs] = u;
    }
  }
  if (threadIdx.x == 0) flag[0] = flag[1] = flag[2] = 0;
  __syncthreads();
  int iters = 0;
  bool m = false;
  if (use_smem) {
    iters = sweep_loop(p, al, au, bl, bu, wl, mk, flag, cap, fixed, &m);
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      lb_out[d * ds + v * vs] = al[v];
      ub_out[d * ds + v * vs] = au[v];
    }
    if constexpr (STAMP) stamp_epilogue(stamps, d);
    if constexpr (STEP) step_epilogue(p, al, au, so, d);
  } else if (vs == 1) {
    // sweep_loop ends on a block barrier: the rows are visible.
    iters = sweep_loop(p, lb_out + d * ds, ub_out + d * ds, bl, bu, wl, mk,
                       flag, cap, fixed, &m);
    if constexpr (STAMP) stamp_epilogue(stamps, d);
    if constexpr (STEP) step_epilogue(p, lb_out + d * ds, ub_out + d * ds,
                                      so, d);
  } else if constexpr (!STEP) {
    iters = sweep_loop(p, Plane{lb_out + d * ds, vs},
                       Plane{ub_out + d * ds, vs}, bl, bu, wl, mk, flag, cap,
                       fixed, &m);
  }
  if (threadIdx.x == 0) {
    iters_out[d] = fixed ? iters : iters + 1;
    unconv_out[d] = fixed ? 0 : m;
  }
  if constexpr (STAMP) stamp_end(stamps, d);
}

__global__ void __launch_bounds__(TT_THREADS)
fixpoint_kernel(PlanView p, const int* lb_in, const int* ub_in, int* lb_out,
                int* ub_out, int* iters_out, unsigned char* unconv_out,
                int* scratch, int cap, int use_smem, const int* live,
                long long ds, long long vs, int fixed) {
  fixpoint_body<false>(p, lb_in, ub_in, lb_out, ub_out, iters_out,
                       unconv_out, scratch, cap, use_smem, live, ds, vs,
                       fixed, StepOut{});
}

// The step entry: at most 64 registers a thread, so that it keeps K1's
// four blocks per SM at golomb(12).
__global__ void __launch_bounds__(TT_THREADS, 4)
fixpoint_step_kernel(PlanView p, const int* lb_in, const int* ub_in,
                     int* lb_out, int* ub_out, int* iters_out,
                     unsigned char* unconv_out, int* scratch, int cap,
                     int use_smem, const int* live, StepOut so) {
  fixpoint_body<true>(p, lb_in, ub_in, lb_out, ub_out, iters_out,
                      unconv_out, scratch, cap, use_smem, live, p.V, 1, 0,
                      so);
}

// The stamped step entry: the step entry's work and outputs, each
// block's clock stamps in ``stamps`` ((D, 2) int64: the cycles before the
// epilogue, the epilogue's) and the launch's span on the global timer in
// ``span`` (common.cuh). Only profiled chunks launch it.
__global__ void __launch_bounds__(TT_THREADS, 4)
fixpoint_step_stamped_kernel(PlanView p, const int* lb_in, const int* ub_in,
                             int* lb_out, int* ub_out, int* iters_out,
                             unsigned char* unconv_out, int* scratch,
                             int cap, int use_smem, const int* live,
                             StepOut so, long long* stamps,
                             long long* span) {
  span_begin(span);
  fixpoint_body<true, true>(p, lb_in, ub_in, lb_out, ub_out, iters_out,
                            unconv_out, scratch, cap, use_smem, live, p.V, 1,
                            0, so, stamps);
  span_end(span);
}

// The table level entry (level.cuh): row r's parent gathered into the
// block's store, K1's sweeps to the fixpoint or the cap, the rows
// written, then dive_level's epilogue on the store. A is in shared
// memory, or in the output rows on the global path (B, the worklist and
// the marks in the row's scratch); ``bulk``: the parent rows arrive by
// TMA. With no propagator (P == 0) the store is the gathered one and
// iters 0, as the JAX fixpoint returns. At most 64 registers a thread.
__global__ void __launch_bounds__(TT_THREADS, 4)
fixpoint_level_kernel(PlanView p, LevelView lv, int* scratch, int cap,
                      int use_smem, int bulk) {
  extern __shared__ __align__(16) int level_smem[];
  const int V = p.V;
  const long long r = blockIdx.x;
  int* flag = level_smem;
  int* al = level_smem + 4;  // 16-byte aligned: a TMA destination
  int* au = al + V;
  int* bl = au + V;
  if (!use_smem) {
    al = lv.lb + r * V;
    au = lv.ub + r * V;
    bl = scratch + r * scratch_words(p);
  }
  int* bu = bl + V;
  int* wl = bu + V;
  unsigned char* mk = reinterpret_cast<unsigned char*>(wl + p.P);
  gather_parent(lv, r, V, al, au, bl, bu, bulk);
  if (threadIdx.x == 0) flag[0] = flag[1] = flag[2] = 0;
  __syncthreads();
  bool m;
  const int iters =
      p.P > 0 ? sweep_loop(p, al, au, bl, bu, wl, mk, flag, cap, 0, &m) + 1
              : 0;
  if (use_smem)
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      lv.lb[r * V + v] = al[v];
      lv.ub[r * V + v] = au[v];
    }
  level_epilogue(p, al, au, lv, r);
  if (threadIdx.x == 0) lv.iters[r] = iters;
}

// K1's kernels by entry: the fixpoint (and its fixed-sweeps and
// transposed entries), the step entry, the level entry, the stamped step
// entry.
enum { FP_FIXPOINT = 0, FP_STEP = 1, FP_LEVEL = 2, FP_STEP_STAMPED = 3 };

static const void* entry_kernel(int entry) {
  return entry == FP_STEP           ? (const void*)fixpoint_step_kernel
         : entry == FP_LEVEL        ? (const void*)fixpoint_level_kernel
         : entry == FP_STEP_STAMPED ? (const void*)fixpoint_step_stamped_kernel
                                    : (const void*)fixpoint_kernel;
}

// Dynamic shared memory of a launch of ``entry`` (16 bytes of flags on
// the global path, which needs the scratch), with the kernel's attribute
// raised to it on the current device; each kernel keeps its own
// attribute on each device. Returns a CUDA error code.
static int prepare(int entry, const PlanView* p, const int* scratch,
                   int smem_limit, size_t* smem, int* use_smem) {
  static int attr_set[TT_MAX_DEVICES][4];
  *smem = smem_bytes(*p);
  *use_smem = *smem + TT_STATIC_SMEM <= (size_t)smem_limit;
  if (!*use_smem) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    *smem = 16;
  }
  cudaError_t e;
  int* set = attr_slot(attr_set, &e);
  if (set == nullptr) return (int)e;
  if ((int)*smem + 1 > set[entry]) {
    e = cudaFuncSetAttribute(entry_kernel(entry),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
    if (e != cudaSuccess) return (int)e;
    set[entry] = (int)*smem + 1;
  }
  return 0;
}

static int launch(const PlanView* p, const int* lb_in, const int* ub_in,
                  int* lb_out, int* ub_out, int* iters, unsigned char* unconv,
                  int* scratch, int D, int cap, int smem_limit,
                  const int* live, void* stream, long long ds, long long vs,
                  int fixed) {
  size_t smem;
  int use_smem;
  int rc = prepare(FP_FIXPOINT, p, scratch, smem_limit, &smem, &use_smem);
  if (rc != 0) return rc;
  fixpoint_kernel<<<D, TT_THREADS, smem, (cudaStream_t)stream>>>(
      *p, lb_in, ub_in, lb_out, ub_out, iters, unconv, scratch, cap,
      use_smem, live, ds, vs, fixed);
  return (int)cudaGetLastError();
}

extern "C" int tt_fixpoint(const PlanView* p, const int* lb_in,
                           const int* ub_in, int* lb_out, int* ub_out,
                           int* iters, unsigned char* unconv, int* scratch,
                           int D, int cap, int smem_limit, const int* live,
                           void* stream) {
  return launch(p, lb_in, ub_in, lb_out, ub_out, iters, unconv, scratch, D,
                cap, smem_limit, live, stream, p->V, 1, 0);
}

extern "C" int tt_fixed_sweeps(const PlanView* p, const int* lb_in,
                               const int* ub_in, int* lb_out, int* ub_out,
                               int* iters, unsigned char* unconv,
                               int* scratch, int D, int n, int smem_limit,
                               const int* live, void* stream) {
  return launch(p, lb_in, ub_in, lb_out, ub_out, iters, unconv, scratch, D,
                n, smem_limit, live, stream, p->V, 1, 1);
}

extern "C" int tt_fixpoint_t(const PlanView* p, const int* lb_in,
                             const int* ub_in, int* lb_out, int* ub_out,
                             int* iters, unsigned char* unconv, int* scratch,
                             int D, int cap, int smem_limit, const int* live,
                             void* stream) {
  return launch(p, lb_in, ub_in, lb_out, ub_out, iters, unconv, scratch, D,
                cap, smem_limit, live, stream, 1, D, 0);
}

// tt_fixpoint, then K2 and K3 on each dive's result in the same block:
// bot and ent as tt_classify writes them, the eight outputs of
// tt_select from the cursors strat.
extern "C" int tt_fixpoint_step(const PlanView* p, const int* lb_in,
                                const int* ub_in, int* lb_out, int* ub_out,
                                int* iters, unsigned char* unconv,
                                int* scratch, int D, int cap, int smem_limit,
                                const int* live, void* stream,
                                const int* strat, unsigned char* bot,
                                unsigned char* ent, unsigned char* found,
                                int* var, int* chosen, int* valo, int* c0l,
                                int* c0u, int* c1l, int* c1u) {
  size_t smem;
  int use_smem;
  int rc = prepare(FP_STEP, p, scratch, smem_limit, &smem, &use_smem);
  if (rc != 0) return rc;
  const StepOut so{strat, bot, ent,
                   SelectOut{found, var, chosen, valo, c0l, c0u, c1l, c1u}};
  fixpoint_step_kernel<<<D, TT_THREADS, smem, (cudaStream_t)stream>>>(
      *p, lb_in, ub_in, lb_out, ub_out, iters, unconv, scratch, cap,
      use_smem, live, so);
  return (int)cudaGetLastError();
}

// tt_fixpoint_step, each block's clock stamps into ``stamps`` ((D, 2)
// int64) and the launch's span into ``span`` (2 int64).
extern "C" int tt_fixpoint_step_stamped(
    const PlanView* p, const int* lb_in, const int* ub_in, int* lb_out,
    int* ub_out, int* iters, unsigned char* unconv, int* scratch, int D,
    int cap, int smem_limit, const int* live, void* stream, const int* strat,
    unsigned char* bot, unsigned char* ent, unsigned char* found, int* var,
    int* chosen, int* valo, int* c0l, int* c0u, int* c1l, int* c1u,
    long long* stamps, long long* span) {
  size_t smem;
  int use_smem;
  int rc = prepare(FP_STEP_STAMPED, p, scratch, smem_limit, &smem, &use_smem);
  if (rc != 0) return rc;
  const StepOut so{strat, bot, ent,
                   SelectOut{found, var, chosen, valo, c0l, c0u, c1l, c1u}};
  fixpoint_step_stamped_kernel<<<D, TT_THREADS, smem, (cudaStream_t)stream>>>(
      *p, lb_in, ub_in, lb_out, ub_out, iters, unconv, scratch, cap,
      use_smem, live, so, stamps, span);
  return (int)cudaGetLastError();
}

// One level of the EPS table build, W rows, in one launch (level.cuh).
extern "C" int tt_fixpoint_level(const PlanView* p, const LevelView* lv,
                                 int* scratch, int W, int cap,
                                 int smem_limit, void* stream) {
  size_t smem;
  int use_smem;
  int rc = prepare(FP_LEVEL, p, scratch, smem_limit, &smem, &use_smem);
  if (rc != 0) return rc;
  const int bulk = use_smem && level_rows_aligned(*lv, p->V);
  fixpoint_level_kernel<<<W, TT_THREADS, smem, (cudaStream_t)stream>>>(
      *p, *lv, scratch, cap, use_smem, bulk);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of a launch of ``entry`` (0 the fixpoint, 1 the
// step entry, 2 the level entry, 3 the stamped step entry) at the
// smem_limit the wrappers pass, into *blocks.
extern "C" int tt_fixpoint_blocks_per_sm(const PlanView* p, int entry,
                                         int smem_limit, int* blocks) {
  size_t smem;
  int use_smem;
  const int* scratch = blocks;  // not read: any pointer allows the global path
  int rc = prepare(entry, p, scratch, smem_limit, &smem, &use_smem);
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, entry_kernel(entry), TT_THREADS, smem);
}

// What a first launch of each of K1's kernels would do, for this plan:
// the kernel's module load (cudaFuncGetAttributes loads a lazily loaded
// kernel) and its shared-memory attribute.
extern "C" int tt_fixpoint_load(const PlanView* p, int smem_limit) {
  for (int entry = FP_FIXPOINT; entry <= FP_STEP_STAMPED; ++entry) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, entry_kernel(entry));
    if (e != cudaSuccess) return (int)e;
    size_t smem;
    int use_smem;
    const int* scratch = &smem_limit;  // not read
    int rc = prepare(entry, p, scratch, smem_limit, &smem, &use_smem);
    if (rc != 0) return rc;
  }
  return 0;
}

// Initialises the library's CUDA runtime (its first call does) on the
// current device.
extern "C" int tt_runtime_init() { return (int)cudaFree(nullptr); }

extern "C" const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
