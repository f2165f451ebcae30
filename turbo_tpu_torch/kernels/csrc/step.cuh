// The search state and step scratch as seen by the step kernels (K6
// step.cu, K7 step_tail.cu): one struct of pointers passed by value.
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
  // step scratch: K6 pre -> K3, K6 post -> K7, K7 scan -> K7 copy
  int* strat0;
  unsigned char* want;
  unsigned char* impr;
  unsigned char* dleaf;
  int* nxt;
  int* newidx;
  unsigned char* havework;
  int* ridx;
  int* steps;      // steps run in this chunk
  int* tail_sync;  // K7 scan: [0] blocks arrived, [1] some lane live
};

__device__ __forceinline__ int shl32(int a, int s) {
  return (int)((unsigned)a << s);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
