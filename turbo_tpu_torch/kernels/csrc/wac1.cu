// K8: the WAC1 propagation fixpoint of one dive per thread block.
//
// Replaces PropagatorKernels._group_local_fixpoint / sweep_wac1 /
// fixpoint_wac1 of turbo_tpu/solver/propagate_jax.py (815-908). One
// outer sweep: every op-group (a contiguous slice of the TNF
// propagators) runs to its local fixpoint, capped at inner_cap Jacobi
// iterations, in group order, so that a group reads what the groups
// before it wrote; then one pass each of the element rows, the
// membership rows (from the store after the element meet) and every
// linear bucket in turn. Outer sweeps run until one changes nothing, the
// store turns bot, or the cap. Returns (lb, ub, sweeps + 1, unconv) as
// the JAX function does; the inner iterations are not counted.
//
// What bounds it on an H100: as K1, neither bytes nor arithmetic (a
// golomb(12) launch at D = 512 moves about 10 MB: a bound near 0.006
// ms). A sweep is a chain of dependent passes (an inner iteration of a
// group, or a row pass), each a read of the rules and a meet between
// block barriers; the slowest dive of a launch runs up to cap sweeps of
// up to inner_cap iterations of its largest group (150 passes at
// golomb(12), cap 16). A pass waits on latency: table loads from L2 and
// meets, in as many dependent rounds as a warp runs rules one after the
// other (per-pass clock64 counts of a first design: the rules took 70 %
// of a block's time, about ten rounds a pass in golomb(12)'s largest
// group). The design cuts the rounds, the loads and the barriers of a
// pass.
//
// Design. Each pass is Jacobi inside itself, as in JAX: every candidate
// comes from the store as the pass found it. JAX gathers a variable's
// candidates and meets them with max / min, which are associative and
// commutative, so scattering each candidate into a second copy of the
// store with atomicMax / atomicMin gives the same integers in any order.
// - The block keeps two copies of its dive's store in shared memory, A
//   (read by the rules) and B (met into), 4 V int32; a dirty bit per
//   rule; a claim bit per variable; the list of the variables the
//   current pass moved (V uint16); a worklist per warp (uint16): 52944
//   bytes at golomb(12), four blocks per SM. No candidate row exists in
//   global memory.
// - Routing is by the plan's own variable ids (x, y, z of a TNF rule,
//   idx and res, x and b, the terms and b of a linear row), not by K1's
//   slot_tgt: WAC1 has no conflict fold, and its meets reach every
//   variable, the root-fixed tail too. Each candidate is clamped to the
//   root box (lb <= ub0 + 1, ub >= lb0 - 1) before its meet, as the
//   plain version does; the box is read only for a candidate past A's
//   bound, and only such a candidate moves B.
// - A meet that moves B past A claims its variable and appends it to
//   the list once. After the pass's barrier only the listed variables
//   are copied from B to A (A == B again), unclaimed and tested for an
//   empty domain: the store was not bot before the pass, so it is bot
//   after it iff a moved variable is empty. A pass that moved nothing
//   has no commit and no second barrier.
// - The skip. A rule is dirty when one of its variables moved since its
//   pass last ran: the commit marks the rules of each moved variable
//   (the CSR v_roff / v_rule, a warp a variable), and a pass runs its
//   dirty rules only and clears their bits. It tests 32 rules with one
//   shared-memory word, gathers each warp's dirty rules into a worklist
//   and runs them 32 at a time, and reads a rule's table entry only to
//   run it. A
//   clean rule's candidate is the one it gave at its last run, and the
//   store has absorbed it (meets only tighten, and its clamp is the root
//   box's), so running it would move nothing: each pass's store, and so
//   the inner iterations, sweeps, unconv and bot, are bit for bit those
//   of running every rule (the argument of fixpoint.cu's skip). An inner
//   iteration with nothing dirty is one whose store does not change, and
//   ends the group's loop as before. Above the rules, a block-uniform
//   word ``pend`` has a bit per pass (passes 31 and above share bit 31),
//   set when a variable that pass reads moved (``v_pass``) and cleared
//   when the pass runs: a pass with its bit clear is skipped whole, with
//   no barrier (the padding-only groups of golomb(12) after the first
//   sweep). The first sweep of a launch runs every rule: the kernel does
//   not know what moved before it. Built with -DTT_NO_SKIP every pass
//   runs every rule (only chip_smoke.py builds that variant, to time the
//   skip against it).
// - TNF rules load (op, x, y, z) as one int4 through the read-only path;
//   linear rows a packed header and (coef, var) per term.
// - Large stores: when shared memory cannot hold the above, the same
//   algorithm runs with A, B and the list (int32) in a global scratch
//   row of the dive, met by global atomics, and A is written to the
//   output rows at the end (the bits stay in shared memory).
//   ``smem=False`` forces that path.
// A dive stops at its own convergence, or after the sweep in which its
// store turned bot, as the plain version's lanes do; the JAX loop sweeps
// every lane until the last one converges. A sweep at a fixpoint changes
// nothing and bot is monotone, so sweeps, unconv and bot agree on every
// lane and the store on every lane that is not bot (the engine discards
// a bot store).
//
// Like K1 the kernel runs in place in the search step (lb_in ==
// lb_out), returns at once when *live is 0 and allocates nothing, so a
// chunk of steps is captured into a CUDA graph. Three entry points, each
// a kernel per memory path:
// - tt_wac1: the fixpoint (the hybrid rounds);
// - tt_wac1_step, the search step's launch (wac1_kernel<true, ...>): the
//   fixpoint, then K2's and K3's bodies (classify.cuh, select.cuh) on
//   the block's final store, A in shared memory (or in the scratch row
//   on the global path), so that the step launches neither K2 nor K3;
// - tt_wac1_level, one level of the EPS table build under -fp wac1
//   (wac1_level_kernel, level.cuh): K4's parent gather as the load stage
//   (by TMA into shared memory), the sweeps, then K2's and K3's bodies
//   and the rest of dive_level's outputs, so that a level is one launch.
// On the shared-memory path all are built for at most 64 registers, to
// keep four blocks per SM. tt_wac1_load does what each kernel's first
// launch would (its module load and shared-memory attribute).
#include "level.cuh"

#ifdef TT_NO_SKIP
#define TT_K8_SKIP 0
#else
#define TT_K8_SKIP 1
#endif

// The block's dynamic shared memory, in 32-bit words: TT_FLAG_WORDS flag
// words (the list's length and the OR of the moved variables' v_pass,
// each for three passes in turn: pass t uses t % 3); a dirty bit per
// rule; a claim bit per variable; then, on the shared-memory path, the
// stores and the lists. Named here, so that its words need no register.
extern __shared__ __align__(16) int k8_smem[];
#define TT_FLAG_WORDS 8

// Rules in one numbering: the TNF propagators [0, P), the element rows,
// the membership rows, the linear rows; R of them.
__host__ __device__ __forceinline__ int rule_count(const PlanView& p) {
  return p.P + p.E + p.M + p.L;
}
__host__ __device__ __forceinline__ int dirty_words(const PlanView& p) {
  return (rule_count(p) + 127) / 128 * 4;
}
__host__ __device__ __forceinline__ int claim_words(const PlanView& p) {
  return (p.V + 127) / 128 * 4;
}
// A warp's worklist entries: room for every rule of its words of any
// pass (a pass's words are at most R / 32 + 1; warp k takes every
// TT_WARPS-th).
#define TT_WARPS (TT_THREADS / 32)
__host__ __device__ __forceinline__ int work_seg(const PlanView& p) {
  return 32 * ((rule_count(p) / 32 + 1) / TT_WARPS + 1);
}
// The words ahead of the stores: the flags, the dirty and the claim bits.
__host__ __device__ __forceinline__ int head_words(const PlanView& p) {
  return TT_FLAG_WORDS + dirty_words(p) + claim_words(p);
}
__device__ __forceinline__ unsigned* dirty_bits() {
  return reinterpret_cast<unsigned*>(k8_smem + TT_FLAG_WORDS);
}
__device__ __forceinline__ unsigned* claim_bits(const PlanView& p) {
  return reinterpret_cast<unsigned*>(k8_smem + TT_FLAG_WORDS +
                                     dirty_words(p));
}

// A row of the block's dynamic shared memory from word ``off`` on,
// addressed with 32-bit offsets (no 64-bit pointer in a register).
struct SRow {
  int off;
  __device__ __forceinline__ int& operator[](int v) const {
    return k8_smem[off + v];
  }
};

// A dive's working set: A (al, au) and B (bl, bu), rows of V words from
// ``base`` on, then the list of the variables the current pass moved and
// the warps' worklists (TT_WARPS segments of work_seg(p) entries). On the
// shared-memory path ``base`` is a word of the block's shared memory and
// the list and the worklists uint16 (the list at 2 V words, rounded up
// to 4); on the global path it is the dive's scratch row and both int32.
struct SmemSet {
  int base;
  int V;
  __device__ __forceinline__ SRow row(int k) const { return {base + k * V}; }
  __device__ __forceinline__ unsigned short* list() const {
    return reinterpret_cast<unsigned short*>(k8_smem + base + 4 * V);
  }
  __device__ __forceinline__ unsigned short* work() const {
    return reinterpret_cast<unsigned short*>(k8_smem + base + 4 * V +
                                             (V + 7) / 8 * 4);
  }
  __device__ __forceinline__ SRow al() const { return row(0); }
  __device__ __forceinline__ SRow au() const { return row(1); }
  __device__ __forceinline__ SRow bl() const { return row(2); }
  __device__ __forceinline__ SRow bu() const { return row(3); }
};

struct GlobalSet {
  int* base;
  int V;
  __device__ __forceinline__ int* row(int k) const { return base + k * V; }
  __device__ __forceinline__ int* list() const { return row(4); }
  __device__ __forceinline__ int* work() const { return row(5); }
  __device__ __forceinline__ int* al() const { return row(0); }
  __device__ __forceinline__ int* au() const { return row(1); }
  __device__ __forceinline__ int* bl() const { return row(2); }
  __device__ __forceinline__ int* bu() const { return row(3); }
};

// Meets a rule's candidate (lo, hi) for variable v, clamped to the root
// box, into B; a variable moved past A is claimed and listed once.
template <class W>
struct Meet {
  const PlanView& p;
  const W& w;
  int c;  // the flag word of the list's length
  __device__ __forceinline__ void operator()(int, int v, int lo,
                                            int hi) const {
    bool moved = false;
    if (lo > w.al()[v]) {
      const int cap = __ldg(p.ub_cap + v);
      lo = lo < cap ? lo : cap;
      if (lo > w.al()[v]) {
        atomicMax(&w.bl()[v], lo);
        moved = true;
      }
    }
    if (hi < w.au()[v]) {
      const int f = __ldg(p.lb_floor + v);
      hi = hi > f ? hi : f;
      if (hi < w.au()[v]) {
        atomicMin(&w.bu()[v], hi);
        moved = true;
      }
    }
    const unsigned bit = 1u << (v & 31);
    if (moved && !(atomicOr(claim_bits(p) + (v >> 5), bit) & bit))
      w.list()[atomicAdd(k8_smem + c, 1)] = v;
  }
};

// Block-uniform pass state: the count of the passes run, and the passes
// with a variable moved since they last ran.
struct Clock {
  int t;
  unsigned pend;
};

__device__ __forceinline__ unsigned pass_bit(int s) {
  return 1u << (s < 31 ? s : 31);
}

// Calls f(i) for every rule i in [a, b) whose dirty bit is set (every
// rule without the skip) and clears those bits. Warp k of the block takes
// the bit words j = a / 32 + k, + TT_WARPS, ...; only it touches them in
// the pass, and the commit sets bits only after the pass's barrier. It
// first gathers its dirty rules (the q-th word's lane l as 32 q + l) into
// its worklist, then runs them 32 at a time: a round of rules costs a
// table load and a meet's latency, and 20 % of a word's rules in each of
// ten words would otherwise take ten rounds.
template <class W, class F>
__device__ __forceinline__ void each_dirty(const PlanView& p, const W& w,
                                           int a, int b, const F& f) {
  unsigned* dirty = dirty_bits();
  const int lane = threadIdx.x & 31, j0 = (a >> 5) + (threadIdx.x >> 5);
  const auto wl = w.work() + (threadIdx.x >> 5) * work_seg(p);
  int n = 0;
  for (int j = j0, q = 0; j <= (b - 1) >> 5; j += TT_WARPS, ++q) {
    const int lo = a - (j << 5), hi = b - (j << 5);
    unsigned bits = (lo > 0 ? ~0u << lo : ~0u) &
                    (hi < 32 ? (1u << hi) - 1 : ~0u);
    if (TT_K8_SKIP) {
      bits &= dirty[j];
      __syncwarp();
      if (lane == 0 && bits) dirty[j] &= ~bits;
    }
    if (bits >> lane & 1)
      wl[n + __popc(bits & ((1u << lane) - 1))] = (q << 5) + lane;
    n += __popc(bits);
  }
  __syncwarp();
  for (int k = lane; k < n; k += 32) {
    const int e = wl[k];
    f(((j0 + (e >> 5) * TT_WARPS) << 5) + (e & 31));
  }
}

// One Jacobi pass s over the rules [a, b) (every thread calls it): each
// dirty rule's candidates from A go through ``rule(i, out)`` into B; then
// the listed variables are copied from B to A, unclaimed, and mark the
// rules that read them dirty (the CSR v_roff / v_rule), a warp a
// variable. Returns whether a variable moved; *bot turns true when a
// moved variable is empty. Without a commit the pass has one barrier.
// The words of pass t + 2 are cleared in pass t: all threads read pass
// t - 1's before pass t's barrier, and pass t + 2 writes them after pass
// t + 1's.
template <class W, class Rule>
__device__ __forceinline__ bool pass(const PlanView& p, const W& w,
                                     Clock& ck, int s, int a, int b,
                                     bool* bot, const Rule& rule) {
  int* flag = k8_smem;
  if (TT_K8_SKIP && !(ck.pend & pass_bit(s))) return false;
  const int c = ck.t % 3, c2 = (ck.t + 2) % 3;
  const Meet<W> out{p, w, c};
  each_dirty(p, w, a, b, [&](int i) { rule(i, out); });
  __syncthreads();
  const int n = flag[c];
  if (threadIdx.x == 0) {
    flag[c2] = 0;
    flag[3 + c2] = 0;
  }
  ck.t += 1;
  if (s < 31) ck.pend &= ~(1u << s);
  if (n == 0) return false;
  const int lane = threadIdx.x & 31;
  int bb = 0;
  unsigned rd = 0;
  for (int k = threadIdx.x >> 5; k < n; k += blockDim.x >> 5) {
    const int v = w.list()[k];
    if (lane == 0) {
      const int l = w.bl()[v], u = w.bu()[v];
      w.al()[v] = l;
      w.au()[v] = u;
      bb |= l > u;
      rd |= __ldg(p.v_pass + v);
      atomicAnd(claim_bits(p) + (v >> 5), ~(1u << (v & 31)));
    }
    if (TT_K8_SKIP) {
      unsigned* dirty = dirty_bits();
      const int e1 = __ldg(p.v_roff + v + 1);
      for (int e = __ldg(p.v_roff + v) + lane; e < e1; e += 32) {
        const int r = __ldg(p.v_rule + e);
        atomicOr(dirty + (r >> 5), 1u << (r & 31));
      }
    }
  }
  rd = __reduce_or_sync(0xffffffffu, rd);
  if (lane == 0 && rd) atomicOr(flag + 3 + c, (int)rd);
  const bool empty = __syncthreads_or(bb) != 0;
  *bot = *bot || empty;
  ck.pend |= (unsigned)flag[3 + c];
  return true;
}

// The sweeps of one dive on its working set, equal A and B on entry;
// ``bot``: the store on entry is bot. As in the plain version, a sweep
// runs the op-groups while the store is not bot (the first group's first
// iteration runs on a store that was bot on entry), then, if it is
// still not bot, every row pass. Returns the sweeps run; *m_out: still
// changing at the cap.
template <class W>
__device__ __forceinline__ int sweep_loop(const PlanView& p, const W& w,
                                          bool bot, int cap, int inner_cap,
                                          bool* m_out) {
  const int P = p.P, E0 = P + p.E, M0 = E0 + p.M;  // the rows' first ids
  Clock ck{0, ~0u};
  bool m = true;
  int it = 0;
  const auto tnf = [&](int i, const Meet<W>& out) {
    const int4 r = __ldg(p.tnf4 + i);  // (op, x, y, z)
    const auto al = w.al();
    const auto au = w.au();
    int c[6];
    deduce(r.x, al[r.y], au[r.y], al[r.z], au[r.z], al[r.w], au[r.w], c);
    out(i, r.y, c[0], c[1]);
    out(P + i, r.z, c[2], c[3]);
    out(2 * P + i, r.w, c[4], c[5]);
  };
  for (; m && it < cap; ++it) {
    bool changed = false;
    // Op-groups in order, each to its local fixpoint; the first runs
    // even on a store that is bot on entry (P > 0: there is one).
    for (int g = 0; g < p.G && (g == 0 || !bot); ++g) {
      const int a = __ldg(p.g_off + g), b = __ldg(p.g_off + g + 1);
      for (int inner = 0; inner < inner_cap; ++inner) {
        const bool ch = pass(p, w, ck, g, a, b, &bot, tnf);
        changed |= ch;
        if (!ch || bot) break;
      }
    }
    // Then the rows, one pass each, in turn, all of them once the store
    // was not bot after the groups.
    const bool alive = !bot;
    if (alive && p.E > 0)
      changed |= pass(p, w, ck, p.G, P, E0, &bot,
                      [&](int i, const Meet<W>& out) {
        cand_elem(p, i - P, w.al(), w.au(), out);
      });
    if (alive && p.M > 0)
      changed |= pass(p, w, ck, p.G + 1, E0, M0, &bot,
                      [&](int i, const Meet<W>& out) {
        cand_member(p, i - E0, w.al(), w.au(), out);
      });
    // Linear buckets one after the other: a bucket reads the store the
    // buckets before it wrote.
    for (int k = 0; alive && k < p.LB; ++k)
      changed |= pass(p, w, ck, p.G + 2 + k, M0 + __ldg(p.lb_off + k),
                      M0 + __ldg(p.lb_off + k + 1), &bot,
                      [&](int i, const Meet<W>& out) {
        cand_linear(p, i - M0, w.al(), w.au(), out);
      });
    m = changed && !bot;
  }
  *m_out = m;
  return it;
}

// The int32 words of a dive's global scratch row: A and B (4 V), the
// list (V) and the worklists.
__host__ __device__ __forceinline__ long long scratch_words(
    const PlanView& p) {
  return 5LL * p.V + (long long)TT_WARPS * work_seg(p);
}

// Dynamic shared memory: the head words, and on the shared-memory path
// A and B (4 V int32), the list (V uint16) and the worklists (uint16),
// each rounded up to 16 bytes. Mirrored by kernels.wac1_smem_bytes.
static size_t smem_bytes(const PlanView& p) {
  return 4 * (size_t)head_words(p) + 16 * (size_t)p.V +
         ((size_t)p.V + 7) / 8 * 16 +
         ((size_t)TT_WARPS * work_seg(p) + 7) / 8 * 16;
}

// Loads the dive's store into A and B (``load``: returns this thread's
// OR of lb > ub over its variables), marks every rule dirty, clears the
// claims and the flag words, runs the sweeps (none without a propagator),
// writes A to the output rows, then runs ``epilogue`` (which synchronises
// first if it reads A). Returns the sweeps.
template <class W, class Load, class Epilogue>
__device__ __forceinline__ int run(const PlanView& p, const W& w,
                                   const Load& load, int* lb_out,
                                   int* ub_out, int cap, int inner_cap,
                                   bool* m, const Epilogue& epilogue) {
  const int b0 = load();
  const int R = rule_count(p);
  for (int i = threadIdx.x; i < head_words(p); i += blockDim.x) {
    const int j = i - TT_FLAG_WORDS;  // the dirty word j: rules 32 j on
    k8_smem[i] = j < 0 || j >= dirty_words(p) || 32 * j >= R ? 0
                 : 32 * j + 32 <= R ? -1
                                    : (int)((1u << (R - 32 * j)) - 1);
  }
  const bool bot = __syncthreads_or(b0) != 0;
  *m = false;
  const int sweeps = p.P > 0 ? sweep_loop(p, w, bot, cap, inner_cap, m) : 0;
  for (int v = threadIdx.x; v < p.V; v += blockDim.x) {
    lb_out[v] = w.al()[v];
    ub_out[v] = w.au()[v];
  }
  epilogue();
  return sweeps;
}

// The working set of dive d: the block's shared memory, or the dive's
// row of ``scratch`` ((D, scratch_words(p)) int32).
template <bool SMEM>
struct WorkSet;
template <>
struct WorkSet<true> {
  static __device__ __forceinline__ SmemSet of(const PlanView& p, int*,
                                               long long) {
    return SmemSet{head_words(p), p.V};
  }
};
template <>
struct WorkSet<false> {
  static __device__ __forceinline__ GlobalSet of(const PlanView& p,
                                                 int* scratch, long long d) {
    return GlobalSet{scratch + d * scratch_words(p), p.V};
  }
};

// The kernel's body: one block a dive. SMEM: the working set in shared
// memory, else in the dive's row of ``scratch``. STEP: the step entry,
// which ends with the epilogue. STAMP: the stamped step entry, which also
// writes the block's clock stamps (epilogue.cuh) into ``stamps``.
template <bool STEP, bool SMEM, bool STAMP>
__device__ __forceinline__ void wac1_body(
    const PlanView& p, const int* lb_in, const int* ub_in, int* lb_out,
    int* ub_out, int* iters_out, unsigned char* unconv_out, int* scratch,
    int cap, int inner_cap, const int* live, const StepOut& so,
    long long* stamps) {
  if (live != nullptr && *live == 0) return;
  const int V = p.V;
  const long long d = blockIdx.x;
  if constexpr (STAMP) stamp_start(stamps, d);
  lb_in += d * V;
  ub_in += d * V;
  const auto w = WorkSet<SMEM>::of(p, scratch, d);
  const auto load = [&] {
    int b0 = 0;
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      const int l = lb_in[v], u = ub_in[v];
      w.al()[v] = l;
      w.au()[v] = u;
      w.bl()[v] = l;
      w.bu()[v] = u;
      b0 |= l > u;
    }
    return b0;
  };
  const auto epilogue = [&] {
    if constexpr (STEP) {
      __syncthreads();
      if constexpr (STAMP) stamp_epilogue(stamps, d);
      step_epilogue(p, &w.al()[0], &w.au()[0], so, d);
    }
  };
  bool m;
  const int sweeps = run(p, w, load, lb_out + d * V, ub_out + d * V, cap,
                         inner_cap, &m, epilogue);
  if (threadIdx.x == 0) {
    iters_out[d] = sweeps + 1;
    unconv_out[d] = m;
  }
  if constexpr (STAMP) stamp_end(stamps, d);
}

// The kernel (``wac1_body``). Each memory path is a kernel of its own, so
// that each gets its own registers: the shared one at most 64 (four
// blocks per SM at golomb(12)); the global one, for stores that shared
// memory cannot hold, at most 80 (three blocks).
template <bool STEP, bool SMEM>
__global__ void __launch_bounds__(TT_THREADS, SMEM ? 4 : 3)
wac1_kernel(PlanView p, const int* lb_in, const int* ub_in, int* lb_out,
            int* ub_out, int* iters_out, unsigned char* unconv_out,
            int* scratch, int cap, int inner_cap, const int* live,
            StepOut so) {
  wac1_body<STEP, SMEM, false>(p, lb_in, ub_in, lb_out, ub_out, iters_out,
                               unconv_out, scratch, cap, inner_cap, live, so,
                               nullptr);
}

// The stamped step entry on each memory path: the step entry's work and
// outputs, each block's clock stamps in ``stamps`` ((D, 2) int64) and the
// launch's span on the global timer in ``span`` (common.cuh). Only
// profiled chunks launch it.
template <bool SMEM>
__global__ void __launch_bounds__(TT_THREADS, SMEM ? 4 : 3)
wac1_step_stamped_kernel(PlanView p, const int* lb_in, const int* ub_in,
                         int* lb_out, int* ub_out, int* iters_out,
                         unsigned char* unconv_out, int* scratch, int cap,
                         int inner_cap, const int* live, StepOut so,
                         long long* stamps, long long* span) {
  span_begin(span);
  wac1_body<true, SMEM, true>(p, lb_in, ub_in, lb_out, ub_out, iters_out,
                              unconv_out, scratch, cap, inner_cap, live, so,
                              stamps);
  span_end(span);
}

// The table level entry (level.cuh): row r's parent gathered into A and
// B (by TMA into shared memory where ``bulk``), K8's sweeps, the rows
// written, then dive_level's epilogue on A. With no propagator (P == 0)
// the store is the gathered one and iters 0, as the JAX fixpoint
// returns. Registers as wac1_kernel's.
template <bool SMEM>
__global__ void __launch_bounds__(TT_THREADS, SMEM ? 4 : 3)
wac1_level_kernel(PlanView p, LevelView lv, int* scratch, int cap,
                  int inner_cap, int bulk) {
  const int V = p.V;
  const long long r = blockIdx.x;
  const auto w = WorkSet<SMEM>::of(p, scratch, r);
  const auto load = [&] {
    return gather_parent(lv, r, V, &w.al()[0], &w.au()[0], &w.bl()[0],
                         &w.bu()[0], SMEM && bulk);
  };
  const auto epilogue = [&] {
    __syncthreads();
    level_epilogue(p, &w.al()[0], &w.au()[0], lv, r);
  };
  bool m;
  const int sweeps = run(p, w, load, lv.lb + r * V, lv.ub + r * V, cap,
                         inner_cap, &m, epilogue);
  if (threadIdx.x == 0) lv.iters[r] = p.P > 0 ? sweeps + 1 : 0;
}

// K8's kernels by entry (the fixpoint, the step entry, the level entry,
// the stamped step entry) and memory path.
enum { K8_FIXPOINT = 0, K8_STEP = 1, K8_LEVEL = 2, K8_STEP_STAMPED = 3 };

static const void* entry_kernel(int entry, bool smem) {
  if (entry == K8_STEP_STAMPED)
    return smem ? (const void*)wac1_step_stamped_kernel<true>
                : (const void*)wac1_step_stamped_kernel<false>;
  if (entry == K8_LEVEL)
    return smem ? (const void*)wac1_level_kernel<true>
                : (const void*)wac1_level_kernel<false>;
  if (entry == K8_STEP)
    return smem ? (const void*)wac1_kernel<true, true>
                : (const void*)wac1_kernel<true, false>;
  return smem ? (const void*)wac1_kernel<false, true>
              : (const void*)wac1_kernel<false, false>;
}

// The memory path of a launch of ``entry`` and its dynamic shared memory
// (the head words alone on the global path, which needs the scratch),
// with that kernel's attribute raised to it on the current device (each
// kernel keeps its own on each device). Returns a CUDA error code.
static int prepare(int entry, const PlanView* p, const int* scratch,
                   int smem_limit, size_t* smem, int* use_smem) {
  static int attr_set[TT_MAX_DEVICES][8];  // [device][entry * 2 + path]
  *smem = smem_bytes(*p);
  // uint16 worklist entries: a segment of at most 65536.
  *use_smem = *smem + TT_STATIC_SMEM <= (size_t)smem_limit &&
              work_seg(*p) <= 65536;
  if (!*use_smem) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    *smem = 4 * (size_t)head_words(*p);
  }
  cudaError_t e;
  int* row = attr_slot(attr_set, &e);
  if (row == nullptr) return (int)e;
  int& set = row[entry * 2 + *use_smem];
  if ((int)*smem + 1 > set) {
    e = cudaFuncSetAttribute(entry_kernel(entry, *use_smem),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
    if (e != cudaSuccess) return (int)e;
    set = (int)*smem + 1;
  }
  return 0;
}

template <bool STEP>
static int launch(const PlanView* p, const int* lb_in, const int* ub_in,
                  int* lb_out, int* ub_out, int* iters, unsigned char* unconv,
                  int* scratch, int D, int cap, int inner_cap, int smem_limit,
                  const int* live, void* stream, const StepOut& so) {
  size_t smem;
  int use_smem;
  int rc = prepare(STEP ? K8_STEP : K8_FIXPOINT, p, scratch, smem_limit,
                   &smem, &use_smem);
  if (rc != 0) return rc;
  auto* kernel = use_smem ? wac1_kernel<STEP, true> : wac1_kernel<STEP, false>;
  kernel<<<D, TT_THREADS, smem, (cudaStream_t)stream>>>(
      *p, lb_in, ub_in, lb_out, ub_out, iters, unconv, scratch, cap,
      inner_cap, live, so);
  return (int)cudaGetLastError();
}

extern "C" int tt_wac1(const PlanView* p, const int* lb_in, const int* ub_in,
                       int* lb_out, int* ub_out, int* iters,
                       unsigned char* unconv, int* scratch, int D, int cap,
                       int inner_cap, int smem_limit, const int* live,
                       void* stream) {
  return launch<false>(p, lb_in, ub_in, lb_out, ub_out, iters, unconv,
                       scratch, D, cap, inner_cap, smem_limit, live, stream,
                       StepOut{});
}

// tt_wac1, then K2 and K3 on each dive's result in the same block: bot
// and ent as tt_classify writes them, the eight outputs of tt_select
// from the cursors strat.
extern "C" int tt_wac1_step(const PlanView* p, const int* lb_in,
                            const int* ub_in, int* lb_out, int* ub_out,
                            int* iters, unsigned char* unconv, int* scratch,
                            int D, int cap, int inner_cap, int smem_limit,
                            const int* live, void* stream, const int* strat,
                            unsigned char* bot, unsigned char* ent,
                            unsigned char* found, int* var, int* chosen,
                            int* valo, int* c0l, int* c0u, int* c1l,
                            int* c1u) {
  return launch<true>(
      p, lb_in, ub_in, lb_out, ub_out, iters, unconv, scratch, D, cap,
      inner_cap, smem_limit, live, stream,
      StepOut{strat, bot, ent,
              SelectOut{found, var, chosen, valo, c0l, c0u, c1l, c1u}});
}

// tt_wac1_step, each block's clock stamps into ``stamps`` ((D, 2)
// int64) and the launch's span into ``span`` (2 int64).
extern "C" int tt_wac1_step_stamped(
    const PlanView* p, const int* lb_in, const int* ub_in, int* lb_out,
    int* ub_out, int* iters, unsigned char* unconv, int* scratch, int D,
    int cap, int inner_cap, int smem_limit, const int* live, void* stream,
    const int* strat, unsigned char* bot, unsigned char* ent,
    unsigned char* found, int* var, int* chosen, int* valo, int* c0l,
    int* c0u, int* c1l, int* c1u, long long* stamps, long long* span) {
  size_t smem;
  int use_smem;
  int rc = prepare(K8_STEP_STAMPED, p, scratch, smem_limit, &smem, &use_smem);
  if (rc != 0) return rc;
  auto* kernel = use_smem ? wac1_step_stamped_kernel<true>
                          : wac1_step_stamped_kernel<false>;
  kernel<<<D, TT_THREADS, smem, (cudaStream_t)stream>>>(
      *p, lb_in, ub_in, lb_out, ub_out, iters, unconv, scratch, cap,
      inner_cap, live,
      StepOut{strat, bot, ent,
              SelectOut{found, var, chosen, valo, c0l, c0u, c1l, c1u}},
      stamps, span);
  return (int)cudaGetLastError();
}

// One level of the EPS table build, W rows, in one launch (level.cuh).
extern "C" int tt_wac1_level(const PlanView* p, const LevelView* lv,
                             int* scratch, int W, int cap, int inner_cap,
                             int smem_limit, void* stream) {
  size_t smem;
  int use_smem;
  int rc = prepare(K8_LEVEL, p, scratch, smem_limit, &smem, &use_smem);
  if (rc != 0) return rc;
  const int bulk = level_rows_aligned(*lv, p->V);
  auto* kernel = use_smem ? wac1_level_kernel<true> : wac1_level_kernel<false>;
  kernel<<<W, TT_THREADS, smem, (cudaStream_t)stream>>>(*p, *lv, scratch,
                                                        cap, inner_cap, bulk);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of a launch of ``entry`` (0 the fixpoint, 1 the
// step entry, 2 the level entry, 3 the stamped step entry) at the
// smem_limit the wrappers pass, into *blocks.
extern "C" int tt_wac1_blocks_per_sm(const PlanView* p, int entry,
                                     int smem_limit, int* blocks) {
  size_t smem;
  int use_smem;
  const int* scratch = blocks;  // not read: any pointer allows the global path
  int rc = prepare(entry, p, scratch, smem_limit, &smem, &use_smem);
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, entry_kernel(entry, use_smem), TT_THREADS, smem);
}

// What a first launch of each of K8's eight kernels would do, for this
// plan: the module load of each (cudaFuncGetAttributes loads a lazily
// loaded kernel), and the shared-memory attribute of each entry on the
// memory path this plan takes.
extern "C" int tt_wac1_load(const PlanView* p, int smem_limit) {
  for (int entry = K8_FIXPOINT; entry <= K8_STEP_STAMPED; ++entry) {
    for (int smem_path = 0; smem_path < 2; ++smem_path) {
      cudaFuncAttributes a;
      const cudaError_t e =
          cudaFuncGetAttributes(&a, entry_kernel(entry, smem_path));
      if (e != cudaSuccess) return (int)e;
    }
    size_t smem;
    int use_smem;
    const int* scratch = &smem_limit;  // not read
    int rc = prepare(entry, p, scratch, smem_limit, &smem, &use_smem);
    if (rc != 0) return rc;
  }
  return 0;
}
