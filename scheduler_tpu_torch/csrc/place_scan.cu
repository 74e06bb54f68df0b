// place_scan: one job pop's placement scan of the per-pop engine.
//
// Replaces scheduler_tpu/ops/placement.py:71-137 _place_scan (a lax.scan
// under jax.jit: XLA code, not a Pallas kernel).  The plain PyTorch version
// of the same function is
// scheduler_tpu_torch/ops/place_scan_kernel.py::place_scan_reference; the
// two must agree bit for bit.
//
// What it computes, per task in order until the scan stops, in float32:
// the epsilon fit of the task's init request against every node's idle and
// releasing rows, ANDed with the task's static mask row, the node range
// (columns >= n_active are pad nodes: infeasible) and, under
// enforce_pod_count, task_count < pods_limit; the score static + dynamic,
// where dynamic = ((0 + w_lr * least_requested) + w_bal * balanced) + w_bp *
// binpack (a term whose weight is 0 is skipped, not added as 0 * x) and
// static is the task's static score row or 0; the masked max and the LOWEST
// node index holding it (all -inf: nothing feasible).  Then the winner is
// allocated on idle where its idle fits (idle -= req), else pipelined onto
// releasing (releasing -= req), its task count grows by one, and the scan
// stops once the allocations reach ready_deficit (the JobReady break,
// checked after every placement).  The first task with no feasible node is
// failed and stops the scan.  Outputs: out int32 [3, t] (chosen node or -1,
// pipelined, failed); idle, releasing and task_count are updated in place.
//
// What bounds it on this card: latency.  The bytes are the node state once
// (at 10,000 nodes and 2 dims about 0.3 MB) and one mask row a task, well
// under a microsecond of the memory rate for a pop of 100 tasks; but every
// task depends on the placement before it, so the tasks form a chain, and
// each link is a pass over the nodes, a reduction across the nodes' owners
// and the placement.  The design keeps each link short (the launch plan is
// ops/place_scan_kernel.py::scan_plan):
//
// * One thread-block cluster of C CTAs, persistent for the whole pop (C =
//   1, 2, 4, 8 or 16 by the node count; 16 is a non-portable cluster
//   size, launched with cudaLaunchKernelEx and a runtime cluster
//   dimension).  The entry point checks the plan with
//   cudaOccupancyMaxActiveClusters (cudaOccupancyMaxActiveBlocksPerMultiprocessor
//   at C = 1) and refuses one that cannot run.  A CTA has 1,024 threads at
//   two resource dims (up to 16,384 nodes, one node a thread) and 512 at a
//   run-time dim count (its node pass needs more registers).
// * CTA k owns an equal contiguous slice of [0, n_active).  In the on-chip
//   arm it loads its slice into shared memory at the start (the r idle and
//   r releasing rows, the task counts, the allocatable cpu and memory
//   columns where a weight is non-zero, the pod limits under the pod-count
//   gate), keeps it there for every task and writes idle, releasing and
//   task counts back at the end.  Where the slice does not fit, the global
//   arm runs the same code on the session's tensors in place.  Only the
//   owner CTA reads or writes a node, so plain loads see its writes.
// * Per task each thread evaluates its nodes (loc = tid, tid + T, ...) in
//   the JAX operation order and keeps a (score, lowest index) pair, the
//   index packed with that node's fits on idle and on releasing (from the
//   same floats).  A warp reduces its pairs in two hardware reductions
//   (__reduce_max_sync on an order-preserving int key of the score, then
//   __reduce_min_sync on the packed indices holding it); warp 0 reduces
//   the warps' pairs the same way.  The task's mask and score entries of
//   the CTA's first 2 x 1,024 (8 x 512) nodes and its request rows were
//   loaded into registers during the task before (the rows' indices three
//   tasks ahead), and nothing tests them before they are used, so no
//   global load waits on the chain.
// * Warp 0 stores the CTA's slot (score, packed index, any-feasible) into
//   every CTA of the cluster with st.async, each store completing its
//   bytes on the receiving CTA's mbarrier; warp 0 of every CTA waits on
//   its own mbarrier for the C slots and merges them with the same rule,
//   and the winner's packed index brings its fits along.  So every CTA
//   reaches the same winner, the same stop decision and the same
//   allocation count (replicated scalar state: every CTA runs the same
//   trip count).  The owner CTA applies the placement to its slice; rank
//   0 writes the codes.  Two CTA barriers a task (the warps' pairs; the
//   decision and the applied node) and no cluster barrier in the loop.  At
//   C = 1 the slot is its own.
// * The slots and their mbarriers are double-buffered by task parity: a
//   CTA pushes task k + 2's slot only after it has every slot of task
//   k + 1, which each CTA pushes only after it has read its slots of task
//   k.  A wait of about ten seconds traps (a fault, not a hang).  A cluster
//   barrier before the loop (mbarriers set) and one after it (no CTA exits
//   while a peer may still push into it) are the only ones.
//
// Bitwise parity with the float32 reference rests on: no FMA contraction
// (built with --fmad=false), IEEE division (the default -prec-div=true),
// every expression in the JAX function's operation order (NOT
// placement_step.cu's node_score, which adds binpack first), the safe
// divisor as a select, and lowest-index tie breaking at every level of
// every reduction (thread, warp, CTA, cluster).  NaN inputs are out of
// contract (static score rows are sanitized to finite values when built).
//
// Build: with the port's other kernels, by scheduler_tpu_torch/ops/cuda_build.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define SCAN_MAX_WARPS 32  // warps a CTA (1,024 threads)
#define SCAN_MAX_R 32
#define SCAN_MAX_CTAS 16
#define SLOT_WORDS 4       // an exchange slot: score, index, flags, (pad)
#define SLOT_BYTES 12      // the words pushed
#define BIG_I32 2147483647
#define FULL 0xffffffffu
#define ERR_NO_CLUSTER 10001  // the plan's cluster cannot be scheduled

// Phase clocks: built with -DSCAN_PHASE_CLOCKS (scripts/scan_ab.py), thread
// 0 of rank 0 sums the SM clock spent in each phase of a task into
// clocks[0..SCAN_PHASES), then the loop's clocks, its nanoseconds and the
// tasks it ran.
#define SCAN_PHASES 7
#ifdef SCAN_PHASE_CLOCKS
#define TICK(k)                     \
  do {                              \
    const long long _t = clock64(); \
    ph[k] += _t - ph_at;            \
    ph_at = _t;                     \
  } while (0)
#else
#define TICK(k) \
  do {          \
  } while (0)
#endif

struct ScanArgs {
  float* idle;           // [n, r]
  float* rel;            // [n, r]
  int* tc;               // [n]
  const float* alloc;    // [n, r]
  const int* plim;       // [n]
  const float* mins;     // [r]
  const float* initq;    // [T, r]
  const float* req;      // [T, r]
  const uint8_t* smask;  // [T, stride] bool
  const float* sscore;   // [T, stride] or null (score 0)
  const int* rows;       // [t] rows of initq / req / smask / sscore
  int* out;              // [3, t]: chosen, pipelined, failed
  long long stride;      // elements between two static rows
  int t;
  int n_active;
  int r;
  int ready_deficit;
  int enforce_pod_count;
  float w_lr;
  float w_bal;
  float w_bp;
  int ctas;   // C
  int slice;  // nodes a CTA
  long long* clocks;  // [SCAN_PHASES + 3] phase clocks (SCAN_PHASE_CLOCKS builds) or null
};

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// An int whose signed order is the float order of a score (-0.0 taken as
// +0.0, as float compares take it; NaN is out of contract), and back.
__device__ __forceinline__ int order_key(float v) {
  int k = __float_as_int(v);
  if (k == (int)0x80000000) k = 0;
  return k >= 0 ? k : k ^ 0x7fffffff;
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// Every lane ends with the warp's best pair: the greatest score, and the
// lowest index holding it (two warp reductions in hardware).
__device__ __forceinline__ void warp_best(float& v, int& i) {
  const int key = order_key(v);
  const int kmax = __reduce_max_sync(FULL, key);
  i = __reduce_min_sync(FULL, key == kmax ? i : BIG_I32);
  v = key_value(kmax);
}

// jnp.clip(x, 0, 1) = minimum(maximum(x, 0), 1).
__device__ __forceinline__ float clip01(float x) {
  const float y = x < 0.0f ? 0.0f : x;
  return y > 1.0f ? 1.0f : y;
}

__device__ __forceinline__ bool eps_fit(float q, float avail, float mins) {
  return (q < avail) | (fabsf(avail - q) < mins);
}

// dynamic_score of scheduler_tpu/ops/scoring.py for one node, in its
// operation order: requested = (allocatable - idle) + req; least-requested,
// then balanced, then binpack, each added to the running sum.
__device__ __forceinline__ float dynamic_score(const ScanArgs& a, float ac, float am, float ic,
                                               float im, float qc, float qm) {
  float score = 0.0f;
  const float rc = (ac - ic) + qc;
  const float rm = (am - im) + qm;
  const float sc = ac > 0.0f ? ac : 1.0f;
  const float sm = am > 0.0f ? am : 1.0f;
  if (a.w_lr != 0.0f) {
    const float lc = clip01((ac - rc) / sc), lm = clip01((am - rm) / sm);
    score = score + a.w_lr * (((lc + lm) / 2.0f) * 10.0f);
  }
  if (a.w_bal != 0.0f) {
    const float bc = clip01(rc / sc), bm = clip01(rm / sm);
    score = score + a.w_bal * ((1.0f - fabsf(bc - bm)) * 10.0f);
  }
  if (a.w_bp != 0.0f) {
    const float fc = clip01(rc / sc), fm = clip01(rm / sm);
    score = score + a.w_bp * (((fc + fm) / 2.0f) * 10.0f);
  }
  return score;
}

// A CTA's nodes, by local index loc in [0, count): dim d of a row at
// [d * d_st + loc * n_st], a column at [loc * n_st] (on chip: rows of the
// slice; global arm: the session's [n, r] tensors from the slice's first
// node).
struct View {
  float* idle;
  float* rel;
  int* tc;
  const float* ac;
  const float* am;
  const int* plim;
  int d_st;
  int n_st;
};

// Distributed shared memory without a cluster barrier: a CTA stores its
// slot into every CTA with st.async, each store completing its bytes on the
// receiver's mbarrier, and a receiver waits on its own mbarrier.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void store_async(uint32_t remote, uint32_t v, uint32_t remote_bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(remote), "r"(v), "r"(remote_bar) : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait for phase `parity` of `bar` to complete; a wait of about ten seconds
// (a fault in the kernel) traps instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

// A task's mask bytes and score entries of the thread's first NPT
// nodes, as loaded (a byte is tested where it is used, so no instruction
// here waits on the loads; nodes past the slice read its last node).
template <int T, int NPT>
__device__ __forceinline__ void load_entries(const ScanArgs& a, int row, int base, int count,
                                             int (&mk)[NPT], float (&sk)[NPT]) {
#pragma unroll
  for (int m = 0; m < NPT; ++m) {
    mk[m] = 0;
    sk[m] = 0.0f;
  }
  if (count == 0) return;
  const int npt = (count + T - 1) / T;  // the same in the whole CTA
  const uint8_t* mrow = a.smask + (size_t)row * a.stride + base;
#pragma unroll
  for (int m = 0; m < NPT; ++m)
    if (m < npt) mk[m] = __ldg(mrow + min((int)threadIdx.x + m * T, count - 1));
  if (a.sscore != nullptr) {
    const float* srow = a.sscore + (size_t)row * a.stride + base;
#pragma unroll
    for (int m = 0; m < NPT; ++m)
      if (m < npt) sk[m] = __ldg(srow + min((int)threadIdx.x + m * T, count - 1));
  }
}

// A node's index with its fits for the task: (j << 2) | fits idle | fits
// releasing << 1.  Indices are distinct, so packed indices order as the
// indices do, and the lowest one of a reduction carries its node's fits
// (from the floats of the pass that scored it).
__device__ __forceinline__ int pack(int j, bool fi, bool fr) {
  return (j << 2) | (fi ? 1 : 0) | (fr ? 2 : 0);
}

// One node of the pass: its feasibility and score for the task, folded
// into the thread's running (score, lowest packed index) pair.
template <int RC>
__device__ __forceinline__ void eval_node(const ScanArgs& a, const View& v, int loc, int j,
                                          int r_n, const float* qi, const float* mins, float qc,
                                          float qm, bool mk, float sk, bool has_w, float& bv,
                                          int& bp, bool& any) {
  bool fi = true, fr = true;
  if (RC) {
#pragma unroll
    for (int d = 0; d < RC; ++d) {
      const int at = d * v.d_st + loc * v.n_st;
      fi = fi & eps_fit(qi[d], v.idle[at], mins[d]);
      fr = fr & eps_fit(qi[d], v.rel[at], mins[d]);
    }
  } else {
    for (int d = 0; d < r_n; ++d) {
      const int at = d * v.d_st + loc * v.n_st;
      fi = fi & eps_fit(qi[d], v.idle[at], mins[d]);
      fr = fr & eps_fit(qi[d], v.rel[at], mins[d]);
    }
  }
  bool feasible = (fi | fr) & mk;
  if (a.enforce_pod_count) feasible = feasible & (v.tc[loc] < v.plim[loc]);
  float val = -INFINITY;
  if (feasible) {
    any = true;
    const float dyn =
        has_w ? dynamic_score(a, v.ac[loc * v.n_st], v.am[loc * v.n_st], v.idle[loc * v.n_st],
                              v.idle[v.d_st + loc * v.n_st], qc, qm)
              : 0.0f;
    val = sk + dyn;
  }
  const int p = pack(j, fi, fr);
  if (better(val, p, bv, bp)) {
    bv = val;
    bp = p;
  }
}

// A node's operands of the pass at two resource dims, loaded before any is
// used (so a thread's two nodes wait on their loads together).
struct Node2 {
  float i0, i1, r0, r1, ac, am;
  int tc, pl;
};

__device__ __forceinline__ Node2 load_node2(const View& v, int loc, bool has_w, bool enforce) {
  Node2 x;
  const int at = loc * v.n_st;
  x.i0 = v.idle[at];
  x.i1 = v.idle[v.d_st + at];
  x.r0 = v.rel[at];
  x.r1 = v.rel[v.d_st + at];
  x.ac = has_w ? v.ac[at] : 0.0f;
  x.am = has_w ? v.am[at] : 0.0f;
  x.tc = enforce ? v.tc[loc] : 0;
  x.pl = enforce ? v.plim[loc] : 0;
  return x;
}

// eval_node<2> on loaded operands: the same operations in the same order.
__device__ __forceinline__ void eval_node2(const ScanArgs& a, const Node2& x, int j,
                                           const float* qi, const float* mins, float qc,
                                           float qm, bool mk, float sk, bool has_w, float& bv,
                                           int& bp, bool& any) {
  const bool fi = eps_fit(qi[0], x.i0, mins[0]) & eps_fit(qi[1], x.i1, mins[1]);
  const bool fr = eps_fit(qi[0], x.r0, mins[0]) & eps_fit(qi[1], x.r1, mins[1]);
  bool feasible = (fi | fr) & mk;
  if (a.enforce_pod_count) feasible = feasible & (x.tc < x.pl);
  float val = -INFINITY;
  if (feasible) {
    any = true;
    const float dyn = has_w ? dynamic_score(a, x.ac, x.am, x.i0, x.i1, qc, qm) : 0.0f;
    val = sk + dyn;
  }
  const int p = pack(j, fi, fr);
  if (better(val, p, bv, bp)) {
    bv = val;
    bp = p;
  }
}

// Threads a CTA: 1,024 at two resource dims (a node a thread at 16 CTAs
// up to 16,384 nodes; 64 registers, no spills), 512 at run-time dims
// (their node pass needs more registers than 1,024 threads leave); and
// the nodes a thread whose mask and score entries are prefetched.
template <int RC>
struct Shape {
  static constexpr int T = RC == 2 ? 1024 : 512;
  static constexpr int NPT = RC == 2 ? 2 : 8;
};

// ON_CHIP: the node slice in shared memory (else the global arm); RC: the
// resource dims at compile time (2), or 0 for a run-time count up to 32.
template <bool ON_CHIP, int RC>
__global__ void __launch_bounds__(Shape<RC>::T, 1) place_scan_kernel(const __grid_constant__ ScanArgs a) {
  constexpr int T = Shape<RC>::T, W = T / 32, NPT = Shape<RC>::NPT;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float slots[2][SCAN_MAX_CTAS][SLOT_WORDS];
  __shared__ __align__(8) uint64_t slot_bar[2];
  __shared__ float s_init[2][SCAN_MAX_R];
  __shared__ float s_req[2][SCAN_MAX_R];
  __shared__ float s_mins[SCAN_MAX_R];
  __shared__ float warp_v[SCAN_MAX_WARPS];
  __shared__ int warp_i[SCAN_MAX_WARPS];
  __shared__ int warp_any[SCAN_MAX_WARPS];
  __shared__ int s_stop;

  const int C = a.ctas;
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r_n = RC ? RC : a.r;
  const int t = a.t, S = a.slice;
  const int base = min(rank * S, a.n_active);
  const int count = min(S, a.n_active - base);
  const bool has_w = a.w_lr != 0.0f || a.w_bal != 0.0f || a.w_bp != 0.0f;

  View v;
  if (ON_CHIP) {
    float* f = reinterpret_cast<float*>(smem);
    float* ac = f + (2 * r_n + 1) * S;
    float* am = ac + S;
    int* plim = reinterpret_cast<int*>(has_w ? am + S : ac);
    v = View{f, f + r_n * S, reinterpret_cast<int*>(f + 2 * r_n * S), ac, am, plim, S, 1};
    const size_t g0 = (size_t)base * r_n;
    for (int e = tid; e < count * r_n; e += T) {
      const int j = e / r_n, d = e - j * r_n;
      v.idle[d * S + j] = a.idle[g0 + e];
      v.rel[d * S + j] = a.rel[g0 + e];
      if (has_w && d < 2) (d == 0 ? ac : am)[j] = a.alloc[g0 + e];
    }
    for (int j = tid; j < count; j += T) {
      v.tc[j] = a.tc[base + j];
      if (a.enforce_pod_count) plim[j] = a.plim[base + j];
    }
  } else {
    const size_t g0 = (size_t)base * r_n;
    v = View{a.idle + g0, a.rel + g0, a.tc + base, a.alloc + g0, a.alloc + g0 + 1,
             a.plim + base, 1, r_n};
  }
  if (tid < r_n) s_mins[tid] = a.mins[tid];
  if (rank == 0) {
    for (int k = tid; k < t; k += T) {
      a.out[k] = -1;
      a.out[t + k] = 0;
      a.out[2 * t + k] = 0;
    }
  }
  if (tid == 0) {
    s_stop = 0;
    if (C > 1) {
      bar_init(&slot_bar[0]);
      bar_init(&slot_bar[1]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }

  // The rows of tasks k .. k + 2 (row_a .. row_c); task 0's request rows
  // into shared memory, task 1's into the registers of the last warp's
  // first r lanes (stored during task 0), task 0's mask and score entries.
  int row_a = a.rows[0];
  int row_b = t > 1 ? a.rows[1] : 0;
  int row_c = t > 2 ? a.rows[2] : 0;
  if (tid < r_n) {
    s_init[0][tid] = a.initq[(size_t)row_a * r_n + tid];
    s_req[0][tid] = a.req[(size_t)row_a * r_n + tid];
  }
  const bool q_lane = warp == W - 1 && lane < r_n;
  float q_init = 0.0f, q_req = 0.0f;
  if (q_lane && t > 1) {
    q_init = a.initq[(size_t)row_b * r_n + lane];
    q_req = a.req[(size_t)row_b * r_n + lane];
  }
  int mk[NPT];
  float sk[NPT];
  load_entries<T, NPT>(a, row_a, base, count, mk, sk);
  __syncthreads();
  if (C > 1) cg::this_cluster().sync();  // every CTA's mbarriers are set before any push

  int n_alloc = 0;  // warp 0's copy of the allocations so far (the same in every CTA)
#ifdef SCAN_PHASE_CLOCKS
  long long ph[SCAN_PHASES] = {0, 0, 0, 0, 0, 0, 0};
  long long ph_at = clock64();
  const long long loop_clk0 = ph_at;
  unsigned long long loop_ns0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(loop_ns0));
  int tasks_run = 0;
#endif
  for (int k = 0; k < t; ++k) {
    const int par = k & 1;
    // This task's pushes, C slots, complete on slot_bar[par] (its phase
    // before this one completed two tasks ago).
    if (C > 1 && tid == 0) bar_expect(&slot_bar[par], C * SLOT_BYTES);
    // Loads for later tasks, used one task from now: task k + 1's mask and
    // score entries, task k + 2's request rows, task k + 3's row index.
    int mk_n[NPT];
    float sk_n[NPT];
    load_entries<T, NPT>(a, row_b, base, k + 1 < t ? count : 0, mk_n, sk_n);
    float q_init_n = 0.0f, q_req_n = 0.0f;
    if (q_lane && k + 2 < t) {
      q_init_n = a.initq[(size_t)row_c * r_n + lane];
      q_req_n = a.req[(size_t)row_c * r_n + lane];
    }
    const int row_d = k + 3 < t ? __ldg(a.rows + k + 3) : 0;
    if (q_lane && k + 1 < t) {  // task k + 1's request rows, loaded a task ago
      s_init[par ^ 1][lane] = q_init;
      s_req[par ^ 1][lane] = q_req;
    }
    TICK(0);  // the head: later tasks' loads issued

    // The pass over the CTA's nodes.
    const float* qi = s_init[par];
    const float* qr = s_req[par];
    const float qc = qr[0], qm = qr[1];
    float bv = -INFINITY;
    int bp = BIG_I32;
    bool any = false;
    const bool enforce = a.enforce_pod_count != 0;
#pragma unroll
    for (int m = 0; m < NPT; m += 2) {
      const int l0 = tid + m * T, l1 = l0 + T;
      if (l0 < count) {
        if (RC == 2) {
          const Node2 x0 = load_node2(v, l0, has_w, enforce);
          const Node2 x1 = load_node2(v, l1 < count ? l1 : l0, has_w, enforce);
          eval_node2(a, x0, base + l0, qi, s_mins, qc, qm, mk[m] != 0, sk[m], has_w, bv, bp, any);
          if (l1 < count)
            eval_node2(a, x1, base + l1, qi, s_mins, qc, qm, mk[m + 1] != 0, sk[m + 1], has_w, bv,
                       bp, any);
        } else {
          eval_node<RC>(a, v, l0, base + l0, r_n, qi, s_mins, qc, qm, mk[m] != 0, sk[m], has_w,
                        bv, bp, any);
          if (l1 < count)
            eval_node<RC>(a, v, l1, base + l1, r_n, qi, s_mins, qc, qm, mk[m + 1] != 0,
                          sk[m + 1], has_w, bv, bp, any);
        }
      }
    }
    if (count > NPT * T) {  // nodes past the prefetched ones
      const uint8_t* mrow = a.smask + (size_t)row_a * a.stride + base;
      const float* srow =
          a.sscore != nullptr ? a.sscore + (size_t)row_a * a.stride + base : nullptr;
      for (int loc = tid + NPT * T; loc < count; loc += T)
        eval_node<RC>(a, v, loc, base + loc, r_n, qi, s_mins, qc, qm, mrow[loc] != 0,
                      srow != nullptr ? srow[loc] : 0.0f, has_w, bv, bp, any);
    }
    TICK(1);  // the pass over the CTA's nodes
    warp_best(bv, bp);
    const bool any_w = __any_sync(FULL, any);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bp;
      warp_any[warp] = any_w;
    }
    __syncthreads();
    TICK(2);  // the warps' pairs and the first CTA barrier

    if (warp == 0) {
      float wv = lane < W ? warp_v[lane] : -INFINITY;
      int wp = lane < W ? warp_i[lane] : BIG_I32;
      bool any_c = __any_sync(FULL, lane < W && warp_any[lane] != 0);
      warp_best(wv, wp);  // the CTA's best node, its fits in the packed index
      if (C > 1) {
        // Lane p stores the CTA's slot into rank p's copy of it.
        if (lane < C) {
          const uint32_t at = cluster_addr(smem_addr(&slots[par][rank][0]), lane);
          const uint32_t bar = cluster_addr(smem_addr(&slot_bar[par]), lane);
          store_async(at, __float_as_uint(wv), bar);
          store_async(at + 4, (uint32_t)wp, bar);
          store_async(at + 8, any_c ? 1u : 0u, bar);
        }
        TICK(3);  // the CTA's pair and the push of its slot
        bar_wait(&slot_bar[par], (uint32_t)(k >> 1) & 1u);
        TICK(4);  // the wait for the C slots
        wv = lane < C ? slots[par][lane][0] : -INFINITY;
        wp = lane < C ? __float_as_int(slots[par][lane][1]) : BIG_I32;
        any_c = __any_sync(FULL, lane < C && __float_as_int(slots[par][lane][2]) != 0);
        warp_best(wv, wp);
      }
      const int wi = wp >> 2;
      const int flags = (any_c ? 1 : 0) | ((wp & 3) << 1);
      // The decision, the same in every CTA.
      bool stop = false;
      if (!(flags & 1)) {
        if (rank == 0 && lane == 0) a.out[2 * t + k] = 1;  // failed: the scan stops
        stop = true;
      } else if (flags & 6) {
        const bool alloc_here = (flags & 2) != 0;
        const int lw = wi - base;
        if (lw >= 0 && lw < count) {  // this CTA owns the winner
          if (lane < r_n) {
            const int at = lane * v.d_st + lw * v.n_st;
            if (alloc_here)
              v.idle[at] = v.idle[at] - qr[lane];
            else
              v.rel[at] = v.rel[at] - qr[lane];
          }
          if (lane == 0) v.tc[lw] += 1;
        }
        n_alloc += alloc_here ? 1 : 0;
        if (rank == 0 && lane == 0) {
          a.out[k] = wi;
          a.out[t + k] = alloc_here ? 0 : 1;
        }
        if (n_alloc >= a.ready_deficit) stop = true;
      }
      if (lane == 0) s_stop = stop ? 1 : 0;
    }
    TICK(5);  // the merge, the decision and the placement
    __syncthreads();
    TICK(6);  // the closing CTA barrier
#ifdef SCAN_PHASE_CLOCKS
    ++tasks_run;
#endif
    if (s_stop) break;  // the same in every thread of every CTA

#pragma unroll
    for (int m = 0; m < NPT; ++m) {
      mk[m] = mk_n[m];
      sk[m] = sk_n[m];
    }
    q_init = q_init_n;
    q_req = q_req_n;
    row_a = row_b;
    row_b = row_c;
    row_c = row_d;
  }

#ifdef SCAN_PHASE_CLOCKS
  if (rank == 0 && tid == 0 && a.clocks != nullptr) {
    unsigned long long loop_ns1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(loop_ns1));
    for (int x = 0; x < SCAN_PHASES; ++x) a.clocks[x] = ph[x];
    a.clocks[SCAN_PHASES] = clock64() - loop_clk0;
    a.clocks[SCAN_PHASES + 1] = (long long)(loop_ns1 - loop_ns0);
    a.clocks[SCAN_PHASES + 2] = tasks_run;
  }
#endif
  if (ON_CHIP) {
    const size_t g0 = (size_t)base * r_n;
    for (int e = tid; e < count * r_n; e += T) {
      const int j = e / r_n, d = e - j * r_n;
      a.idle[g0 + e] = v.idle[d * S + j];
      a.rel[g0 + e] = v.rel[d * S + j];
    }
    for (int j = tid; j < count; j += T) a.tc[base + j] = v.tc[j];
  }
  if (C > 1) cg::this_cluster().sync();  // no CTA exits while a peer may still push into it
}

// Words a node of an on-chip slice takes (ops/place_scan_kernel.py::slice_words).
static int slice_words(int r, bool has_w, bool enforce) {
  return 2 * r + 1 + (has_w ? 2 : 0) + (enforce ? 1 : 0);
}

template <bool ON_CHIP, int RC>
static int launch(const ScanArgs& a, int smem_bytes, cudaStream_t stream, void* ev_start,
                  void* ev_stop) {
  auto kernel = place_scan_kernel<ON_CHIP, RC>;
  constexpr int T = Shape<RC>::T;
  // The plan last checked for this instantiation on this device.
  static int ok_dev = -1, ok_ctas = 0, ok_smem = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.gridDim = dim3(a.ctas, 1, 1);
  config.blockDim = dim3(T, 1, 1);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = a.ctas > 1 ? 1 : 0;
  if (!(dev == ok_dev && a.ctas == ok_ctas && smem_bytes == ok_smem)) {
    ok_dev = -1;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    if (a.ctas > 8) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
    }
    int fits = 0;
    if (a.ctas > 1)
      err = cudaOccupancyMaxActiveClusters(&fits, (void*)kernel, &config);
    else
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fits, kernel, T,
                                                          smem_bytes);
    if (err != cudaSuccess) return (int)err;
    if (fits < 1) return ERR_NO_CLUSTER;
    ok_dev = dev;
    ok_ctas = a.ctas;
    ok_smem = smem_bytes;
  }
  if (ev_start != nullptr) cudaEventRecord((cudaEvent_t)ev_start, stream);
  err = cudaLaunchKernelEx(&config, kernel, a);
  if (err != cudaSuccess) return (int)err;
  if (ev_stop != nullptr) cudaEventRecord((cudaEvent_t)ev_stop, stream);
  return (int)cudaGetLastError();
}

// on_chip: the slice in shared memory (smem_bytes at least the slice's
// words), else the global arm.  ev_start / ev_stop (cudaEvent_t or null)
// are recorded immediately around the launch.  clocks: the phase clocks'
// output in a SCAN_PHASE_CLOCKS build (null otherwise).
extern "C" int place_scan_cluster_launch(float* idle, float* rel, int* tc, const float* alloc,
                                         const int* plim, const float* mins, const float* initq,
                                         const float* req, const uint8_t* smask,
                                         const float* sscore, const int* rows, int* out,
                                         long long stride, int t, int n_active, int r,
                                         int ready_deficit, int enforce_pod_count, float w_lr,
                                         float w_bal, float w_bp, int ctas, int threads,
                                         int slice, int on_chip, int smem_bytes, void* stream,
                                         void* ev_start, void* ev_stop, long long* clocks) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (r < 2 || r > SCAN_MAX_R || t < 0 || n_active < 0 || n_active >= (1 << 28))
    return (int)cudaErrorInvalidValue;
  if (ctas < 1 || ctas > SCAN_MAX_CTAS || slice < 0 || (long long)slice * ctas < n_active)
    return (int)cudaErrorInvalidValue;
  if (threads != (r == 2 ? Shape<2>::T : Shape<0>::T)) return (int)cudaErrorInvalidValue;
  const bool has_w = w_lr != 0.0f || w_bal != 0.0f || w_bp != 0.0f;
  if (on_chip && (long long)smem_bytes < (long long)slice * slice_words(r, has_w, enforce_pod_count) * 4)
    return (int)cudaErrorInvalidValue;
  if (t == 0) return 0;
  ScanArgs a;
  a.idle = idle;
  a.rel = rel;
  a.tc = tc;
  a.alloc = alloc;
  a.plim = plim;
  a.mins = mins;
  a.initq = initq;
  a.req = req;
  a.smask = smask;
  a.sscore = sscore;
  a.rows = rows;
  a.out = out;
  a.stride = stride;
  a.t = t;
  a.n_active = n_active;
  a.r = r;
  a.ready_deficit = ready_deficit;
  a.enforce_pod_count = enforce_pod_count;
  a.w_lr = w_lr;
  a.w_bal = w_bal;
  a.w_bp = w_bp;
  a.ctas = ctas;
  a.slice = slice;
  a.clocks = clocks;
  cudaStream_t s = (cudaStream_t)stream;
  if (on_chip)
    return r == 2 ? launch<true, 2>(a, smem_bytes, s, ev_start, ev_stop)
                  : launch<true, 0>(a, smem_bytes, s, ev_start, ev_stop);
  return r == 2 ? launch<false, 2>(a, 0, s, ev_start, ev_stop)
                : launch<false, 0>(a, 0, s, ev_start, ev_stop);
}
