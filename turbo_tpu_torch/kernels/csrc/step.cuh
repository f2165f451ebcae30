// The search state and step scratch as seen by the step kernels (K6
// step.cu, K7 step_tail.cu): one struct of pointers passed by value,
// and the lane copy that K6 head and K7 copy share.
// Mirror of ``StepView`` in kernels/__init__.py; built per chunk by
// solver/step_cuda.py from the SearchState and the solver's scratch.
//
// Booleans are one byte (torch.bool), deds and pscale float32, every
// other field int32; (D, V) planes and (D, MAXD) stacks are row-major.
//
// The state is S EPS shards of D lanes each, concatenated as the JAX
// mesh's global state (parallel/mesh.py): shard s owns lanes
// [s*D, (s+1)*D), table rows [s*n_pad, (s+1)*n_pad) and ring rows
// [s*R, (s+1)*R); its counters next_sub, sub_limit and sol_w are read
// from its first lane. Per-lane planes below have S*D rows.
#pragma once
#include "common.cuh"

#define TT_DIVE 0
#define TT_SOLVE 1
#define TT_IDLE 2

struct StepView {
  int D, S, V, n_active, MAXD, obj, is_opt, enumerate_all, use_table, R,
      n_pad;
  // (D, V) stores
  int* lb;
  int* ub;
  int* root_lb;
  int* root_ub;
  int* best_lb;
  int* best_ub;
  // (D,) per-lane state
  int* best_bound;
  unsigned char* has_best;
  // (D, MAXD) decision stacks
  int* dec_var;
  int* dec_l0;
  int* dec_u0;
  int* dec_l1;
  int* dec_u1;
  int* dec_rope1;
  int* dec_cur;
  int* depth;
  int* phase;
  int* remaining;
  int* subp;
  int* strat;
  int* snap_strat;
  int* next_sub;
  unsigned char* nonexh;
  int* nodes;
  int* fails;
  int* sols;
  int* fpit;
  float* deds;
  int* dmax;
  int* solved_sub;
  int* skipped_sub;
  const int* kpow;
  const int* sub_limit;
  const float* pscale;
  const int* eps_strat;
  const int* ext_bound;
  // EPS table (n_pad, V) and (n_pad,); the root box lb0/ub0 (V,)
  const int* tab_lb;
  const int* tab_ub;
  const int* tab_strat;
  const int* tab_path;
  const int* lb0;
  const int* ub0;
  // solution ring (R, V) and its write counter (D,)
  int* sol_ring;
  int* sol_w;
  // K1-K3 outputs of this step
  const int* iters;
  const unsigned char* unconv;
  const unsigned char* bot;
  const unsigned char* ent;
  const unsigned char* found;
  const int* var;
  const int* nstrat;
  const int* c0l;
  const int* c0u;
  const int* c1l;
  const int* c1u;
  // step scratch: K6 head -> K3; K6 post -> the shard scan (in K6
  // post's last block of the shard) -> the next K6 head or K7 copy
  int* strat0;
  unsigned char* want;
  unsigned char* impr;
  unsigned char* dleaf;
  int* nxt;
  int* newidx;
  unsigned char* havework;
  int* ridx;
  int* steps;      // steps run in this chunk
  // K6 post's tickets: [0] shards scanned, [1] some lane live, [2] the
  // min of the shards' best_bound (INT_MAX between launches), [3 + s]
  // the lanes of shard s that posted
  int* tail_sync;
  int* bmin;       // min of best_bound over every lane, for K6 head
  // Card groups (parallel/mesh.py): the slot arrays of every group, one
  // pointer a group (a peer pointer for a group on another card;
  // nullptr with one group), xn of them, and this group's index. Slot
  // [p][g] of an array, two words (min, live), is group g's incumbent
  // min and live flag for a step of parity p: K7 live and K6 post's
  // last block write this group's slot in every array (xpublish), and
  // K10 (xcard.cu) reduces this group's own array into live and bmin at
  // the head of each step.
  int* const* xslots;
  int xn;
  int xcard;
};

__device__ __forceinline__ int shl32(int a, int s) {
  return (int)((unsigned)a << s);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// This group's incumbent min ``m`` and live flag into slot [par][xcard]
// of every group's slot array (nothing with one group). The fence makes
// the stores, peer stores included, visible to the other cards before
// the launch ends and the other groups' streams, waiting on its event,
// run their K10.
__device__ __forceinline__ void xpublish(const StepView& s, int par, int m,
                                         int live) {
  if (s.xslots == nullptr) return;
  for (int h = 0; h < s.xn; ++h) {
    int* slot = s.xslots[h] + 2 * (par * s.xn + s.xcard);
    slot[0] = m;
    slot[1] = live;
  }
  __threadfence_system();
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((unsigned long long)p & 15) == 0;
}

// da[v] = sa[v] and db[v] = sb[v] for v < V (also into da2 and db2 when
// they are not null; no second row when sb is null), strided over ``n``
// threads from thread ``t``: 16-byte loads and stores when V % 4 == 0
// and every row is 16-byte aligned, U of each row in flight a thread.
template <int U>
__device__ __forceinline__ void copy_rows(
    int* __restrict__ da, int* __restrict__ da2, const int* __restrict__ sa,
    int* __restrict__ db, int* __restrict__ db2, const int* __restrict__ sb,
    int V, int t, int n) {
  const bool two = sb != nullptr;
  if ((V & 3) == 0 && aligned16(da) && aligned16(sa) &&
      (da2 == nullptr || aligned16(da2)) &&
      (!two || (aligned16(db) && aligned16(sb) &&
                (db2 == nullptr || aligned16(db2))))) {
    const int V4 = V >> 2;
    const int4* a4 = reinterpret_cast<const int4*>(sa);
    const int4* b4 = reinterpret_cast<const int4*>(sb);
    for (int v = t; v < V4; v += U * n) {
      int4 x[U], y[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int i = v + k * n;
        if (i < V4) {
          x[k] = a4[i];
          if (two) y[k] = b4[i];
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int i = v + k * n;
        if (i < V4) {
          reinterpret_cast<int4*>(da)[i] = x[k];
          if (da2 != nullptr) reinterpret_cast<int4*>(da2)[i] = x[k];
          if (two) {
            reinterpret_cast<int4*>(db)[i] = y[k];
            if (db2 != nullptr) reinterpret_cast<int4*>(db2)[i] = y[k];
          }
        }
      }
    }
  } else {
    for (int v = t; v < V; v += n) {
      const int x = sa[v];
      da[v] = x;
      if (da2 != nullptr) da2[v] = x;
      if (two) {
        const int y = sb[v];
        db[v] = y;
        if (db2 != nullptr) db2[v] = y;
      }
    }
  }
}

// The refill and ring rows of lane d after a step, by the 32 threads of
// one warp (``lane`` 0-31): a finishing lane with work takes its shard's
// table row clip(newidx, 0, n_pad - 1) into the store and the root
// snapshot, straight into SOLVE phase (table off: the root box, into
// DIVE phase); without work it goes IDLE; an accepted solution's
// incumbent row goes to slot ridx of its shard's ring. Lane 0 writes
// the scalars.
__device__ __forceinline__ void lane_copy(const StepView& s, long long d,
                                          int lane) {
  const bool want = s.want[d];
  const int r = s.ridx[d];
  if (!want && r < 0) return;
  const long long shard = d / s.D;
  const int V = s.V;
  if (want) {
    const bool hw = s.havework[d];
    if (hw && s.use_table) {
      const long long i = shard * s.n_pad + clampi(s.newidx[d], 0,
                                                   s.n_pad - 1);
      copy_rows<8>(s.lb + d * V, s.root_lb + d * V, s.tab_lb + i * V,
                   s.ub + d * V, s.root_ub + d * V, s.tab_ub + i * V, V,
                   lane, 32);
      if (lane == 0) {
        const int ts = s.tab_strat[i], tp = s.tab_path[i];
        s.depth[d] = 0;
        s.strat[d] = ts;
        s.snap_strat[d] = ts;
        s.remaining[d] = 0;
        s.subp[d] = tp;
      }
    } else if (hw) {
      copy_rows<8>(s.lb + d * V, nullptr, s.lb0, s.ub + d * V, nullptr,
                   s.ub0, V, lane, 32);
      if (lane == 0) {
        const int kp = s.kpow[d], ni = s.newidx[d];
        s.depth[d] = 0;
        s.strat[d] = 0;
        s.remaining[d] = kp;
        s.subp[d] = ni;
      }
    }
    if (lane == 0)
      s.phase[d] = hw ? (s.use_table ? TT_SOLVE : TT_DIVE) : TT_IDLE;
  }
  if (r >= 0)
    copy_rows<8>(s.sol_ring + (shard * s.R + r) * V, nullptr,
                 s.best_lb + d * V, nullptr, nullptr, nullptr, V, lane, 32);
}
