// mega_allocate (K2): the whole greedy allocate action in one kernel launch.
//
// Replaces scheduler_tpu/ops/megakernel.py:181 mega_allocate (a Pallas TPU
// kernel; kernel body :259-957, pallas_call :959-987) as eight template
// instantiations mega_allocate_kernel<USE_STATIC, MQ, REL>.  USE_STATIC: a
// task's static-signature mask row is ANDed into the fit and its score row
// added after the dynamic score terms.  MQ = false is
// CURSOR MODE (one queue, jobs in init-key order, a job taken by the cursor
// while none is dirty); MQ = true is MULTI-QUEUE MODE (proportion's queue
// order and overused gate: at each pop the least-share queue not overused,
// then the job chain within it), in one of three queue chains chosen at run
// time: the delta chain (each placement grows its queue's allocated and
// re-derives that queue's share and flag), the full-recompute chain
// (queue_delta = 0: every queue's share and flag re-derived at each pop)
// and the qfair ladder (qfair_ladder: each placement counts one more for its
// queue and reads the queue's share and flag from the rung tables at that
// count).  All three give the same values bit for bit.  REL: the session
// has releasing capacity (evicted pods that have not terminated), a second
// node ledger of r_dim rows: a task fits a node on its idle OR its releasing
// capacity (:510-521), the score reads idle alone, and the winner's idle fit
// decides (:572-583): allocate on idle, or pipeline one copy onto releasing
// (code -3 - node, :829-837), debiting the releasing rows; both raise the
// node's task count, the job's drf row and (multi-queue) its queue's
// allocated (:683-731).  One chunk a step (no cohorts, :244-248).  The
// plain PyTorch version of the same function is
// scheduler_tpu_torch/ops/megakernel.py::mega_allocate_reference; the two
// must agree bit for bit on codes and stats.
//
// What bounds it on this card: per-chunk latency.  The loop is a dependent
// chain of STATS.STEPS steps (18,117 at the flagship), each of one or more
// placement chunks, and each chunk is a fit + score + masked argmax over
// every node followed by the run-batching grid on the winner.  Bytes and
// operations are small (the bound is 0.09 ms at the flagship); what costs is
// the rounds of each chunk: memory round trips, barriers, reductions.
//
// The design (the launch plan is ops/megakernel.py::mega_plan):
//
// * One thread-block cluster of C CTAs x THREADS threads, persistent for the
//   whole action.  C is 8 (the portable size) where the node slice, the
//   exchange slots and the compact job ledger fit a CTA's shared memory,
//   else 16 (non-portable, launched with cudaLaunchKernelEx and a runtime
//   cluster dimension).  The entry point checks
//   cudaOccupancyMaxActiveClusters and refuses a plan that cannot run.
// * The node ledger lives on chip from the first chunk to the last.  At the
//   start every CTA finds the last node whose gate is set (nodes past it can
//   never win) and takes an equal contiguous share of [0, last + 1).  It
//   loads its slice once into shared memory: the r_dim idle rows, the task
//   count, the pod limit, the allocatable cpu and memory rows and the gate
//   (and its slice of the static rows where they fit; with REL the r_dim
//   releasing rows too).  Only the thread
//   that scores a node reads it, and only warp 0 of the CTA that owns the
//   winner writes it; nothing goes back to global memory.
// * One pass per chunk: every thread keeps a running (score, lowest index)
//   pair over its nodes, and a top-2 where the score bound is on (the merge
//   of two top-2 lists is exact, so best and second-best come out of the
//   same pass).  The node pass is compiled for each r_dim (1..8), so every
//   load of a node is issued before any is used and the fit is branch-free.
//   Warp shuffles, then warp 0, reduce a CTA's pairs.
// * No cluster barrier in the loop.  Warp 0 stores the CTA's slot (its
//   top-2 and its winner's column: idle rows, task count, pod limit,
//   allocatable cpu and memory, static score) into every CTA of the cluster
//   with st.async, each store completing its bytes on the receiving CTA's
//   mbarrier; four warps of every CTA wait on their own mbarrier for the C
//   slots.  (cluster.sync() compiles to a fence of the whole card and an
//   invalidation of L1: about 0.5 us a chunk by scripts/k2_phases.py.)
//   With REL no word is added: the slot already carries the winner's idle
//   rows, so every CTA re-evaluates the winner's idle fit from them (the
//   same compares on the same floats as the node pass) and knows whether
//   the chunk allocated or pipelined.
//   Every lane of the four warps then merges the C
//   slots from its own shared memory with the same rule (a tree in
//   registers), reads the winner's column from its owner's slot, and the
//   four warps share the 128-candidate batch grid (a candidate a lane,
//   combined through shared memory and a named barrier).  Side by side,
//   warp 1 updates the node column (owner only), warp 2 the CTA's copy of
//   the job ledger, and warp 0 publishes the outcome and prefetches into L1
//   the task-table and job lines the next step most likely reads (the head
//   of a step is a chain of dependent loads).
// * The slots and their mbarriers are double-buffered by chunk parity.  A
//   CTA pushes chunk k + 2 only after it has every slot of chunk k + 1,
//   which each CTA pushes only after it has read its slots of chunk k: so
//   no push overwrites a slot that is still read, and no push reaches an
//   mbarrier phase before the receiver is done with the one before.  A
//   wait of about ten seconds traps (a fault, not a hang).
// * The loop's scalar state is replicated: every CTA runs the selection and
//   the pop-end logic from identical values, so every CTA takes the same
//   trip count and branches (each CTA waits for every other's slot every
//   chunk).  Rank 0 alone writes codes and stats; a cluster barrier before
//   the loop (mbarriers set) and one after it (no CTA exits while a peer
//   may still push into it) are the only ones.
// * The job ledger is compact (3 + r_dim rows: consumed, allocated, left,
//   drf) and sits in shared memory where the plan finds room, in this order:
//   node slice, (queue ledger,) job ledger, request table, job operands,
//   static rows.  What does not fit is read from global memory; a job
//   ledger that does not fit is one copy a CTA in global scratch
//   ([C, 3 + r_dim, j_pad]).
// * A job pop selects the least key: each lane's key packs the reference's
//   selection order (in multi-queue mode the queue's share and index, then
//   every comparator's key, the creation/uid rank and the lane) into four
//   64-bit words.  The reference's filters, field by field, keep that
//   minimum.  In cursor mode a pop is one pass over the lanes up to the
//   cursor and one block reduction.  In multi-queue mode the queue index
//   in the key is unique to a queue, so the least key is the best job of
//   the queue of least (share, index): every queue's best job (the key
//   below the queue pop) sits in the queue ledger, a pop rescans only the
//   queue whose job was placed since the last pop (a lane's key changes
//   only when its job is placed; rank 0 sorts the lanes by queue at the
//   start, into global scratch), and one warp takes the minimum over the
//   queues.  On an H100 a pass over every job lane a pop took 577 us of a
//   589 us step at the qfair ladder flagship (131,200 lanes, the job
//   ledger in global memory; scripts/k2_phases.py), the rescan 9.6 of 14.1.
// * Multi-queue mode keeps its queue ledger per queue, not per job lane as
//   the JAX kernel does (Mosaic cannot gather by a dynamic lane): every CTA
//   holds each queue's deserved and allocated rows, share and overused flag
//   in shared memory, seeded from the lanes of the queue's jobs, and reads
//   a lane's queue through its index.  The reference's masked add x +
//   (req m) 1.0 on the queue's lanes is the per-queue add, and the refresh
//   folds the same values in the same order, so the bits are the same.
// * The qfair ladder (the ops/qfair.py rung tables qf_share / qf_over,
//   [qf_rows][128], rung on the rows and queue index on the columns, up to
//   1 MB: global memory) keeps a placement count a queue beside the ledger.
//   A placement reads its queue's share and flag at the new count straight
//   from the tables (two 4-byte loads by warp 3, in the ledger updates).
//   A failed placement leaves the count, so the reference's rewrite of the
//   same rung changes nothing, and rung 0 is the value derived at open, as
//   in the reference.
//
// Bitwise parity with the float32 reference rests on: no FMA contraction
// (built with --fmad=false), IEEE division (-prec-div=true, the default),
// every expression evaluated in the reference's operation order (the static
// score after the dynamic terms), the epsilon fit init < avail |
// |avail - init| < min, and lowest-index tie breaking at every level of
// every reduction (thread, warp, CTA, cluster).  The reference's second-best
// takes the winner's own entry as -inf; where no other node is feasible its
// index is the lowest -inf index, which the merge reproduces with one
// virtual entry for the first uncovered node and min(second, best).
//
// Registers (-Xptxas -v, sm_90a, __launch_bounds__(THREADS, 1)), a thread:
// cursor mode 114, static-row mode 118, multi-queue 114, multi-queue with
// static rows 116; with REL 107, 114, 115 and 110; no stack, no spills;
// 3,504 bytes of static shared memory.  The four instantiations without
// REL compile to the same machine code as before REL existed
// (scripts/sass_diff.py): the fields REL reads sit at the end of MegaArgs,
// so the others keep their parameter offsets.
// scripts/k2_phases.py builds it with -DMEGA_PHASE_CLOCKS to time each
// phase of the loop.
//
// Build: with the port's other kernels, by scheduler_tpu_torch/ops/cuda_build.py
// (nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define THREADS 512
#define WARPS (THREADS / 32)
#define GRID_WARPS 4  // warps that share the 128-candidate batch grid
#define MAX_CTAS 16
#define MAX_BATCH 128
#define BIG_I32 2147483647
#define UNPLACED (-1)
#define FAILED (-2)
#define PIPE_BASE (-3)  // pipelined code = PIPE_BASE - node
#define HALT (-100)
#define ERR_NO_CLUSTER 10001  // the plan's cluster cannot be scheduled

// Operand row layouts (scheduler_tpu_torch/ops/layout.py).
#define NROW_TASK_COUNT 8
#define SIG_REQ_REQ 0
#define SIG_REQ_INIT 8
#define STATS_WIDTH 8

// The compact job ledger's rows (layout.py JOB_STATE).
#define JS_CONSUMED 0
#define JS_ALLOCATED 1
#define JS_LEFT 2
#define JS_DRF 3

// Node slice arrays in shared memory, after the r_dim idle rows.
#define NS_TC 0
#define NS_PLIM 1
#define NS_AC 2
#define NS_AM 3
#define NS_FLOAT_ROWS 4

// An exchange slot: the CTA's top-2, then its winner's column.
#define SLOT_WORDS 20
#define SL_V1 0
#define SL_I1 1
#define SL_V2 2
#define SL_I2 3
#define SL_IDLE 4   // span 8
#define SL_TC 12
#define SL_PLIM 13
#define SL_AC 14
#define SL_AM 15
#define SL_SS 16
#define SL_IC 17    // idle cpu and memory again, for the score bound
#define SL_IM 18

// Phase clocks: built with -DMEGA_PHASE_CLOCKS (scripts/k2_phases.py), thread
// 0 of rank 0 sums the SM clock spent in each phase of the loop into
// phase_clocks[0..PHASES), then the whole loop's clocks and nanoseconds.
#define PHASES 10
#ifdef MEGA_PHASE_CLOCKS
#define TICK(k)                   \
  do {                            \
    const long long _t = clock64(); \
    clocks[k] += _t - clock_at;   \
    clock_at = _t;                \
  } while (0)
#else
#define TICK(k) \
  do {          \
  } while (0)
#endif

#define COMP_PRIORITY 0
#define COMP_GANG 1
#define COMP_DRF 2

// Mirrors _MegaArgs in scheduler_tpu_torch/ops/megakernel.py.
struct MegaArgs {
  const float* ns0;       // [16, nb] idle rows 0..7, task count row 8
  const float* alloc_t;   // [8, nb] allocatable
  const uint8_t* gate;    // [nb] node is ready (padding: 0)
  const float* plim;      // [nb] pods limit
  const float* sig_req;   // [16, s_pad] request rows 0..7, init rows 8..15
  const int* task_sig;    // [t_rows * 128] request signature per task
  const int* run_len;     // [t_rows * 128] run length from each task
  const int* job_off;     // [j_pad] first flat task of each job
  const int* job_num;     // [j_pad] pending tasks per job (0: padding)
  const int* job_def;     // [j_pad] ready-break deficit
  const int* job_gang;    // [j_pad] gang order deficit
  const int* job_prio;    // [j_pad] priority
  const int* job_tb;      // [j_pad] creation/uid rank (BIG: padding)
  const float* js_drf0;   // [8, j_pad] drf allocated at session open
  const float* drf_safe;  // [8] drf totals (1 where absent)
  const float* drf_mask;  // [8] 1 where the total is > 0
  const int* misc;        // [8] misc[0] = real job count
  const int* msig;        // [t_rows * 128] static signature per task (use_static)
  const float* smask;     // [static_rows, nb] static mask rows, 1.0 / 0.0 (use_static)
  const float* sscore;    // [static_rows, nb] static score rows (use_static)
  const int* jqueue;      // [j_pad] queue index (= queue rank) of each job (multi_queue)
  const float* jq_des;    // [8, j_pad] deserved of each job's queue (multi_queue)
  const float* jq_alloc0; // [8, j_pad] allocated of each job's queue at open (multi_queue)
  const float* qf_share;  // [qf_rows, 128] share at each placement count (qfair_ladder)
  const float* qf_over;   // [qf_rows, 128] overused at each count, 1.0 / 0.0 (qfair_ladder)
  int* qlanes;            // [j_pad] scratch: the job lanes by queue (multi_queue)
  int* out;               // [(t_rows + 1) * 128] result codes
  int* stats;             // [8] evidence counters
  float* js_global;       // [C, 3 + r_dim, j_pad] job ledgers where the plan keeps them off chip
  long long* phase_clocks;  // [PHASES + 2] (built with -DMEGA_PHASE_CLOCKS; else unused)
  int nb, s_pad, t_rows, t_cap, j_pad, r_dim, cpu_idx, mem_idx;
  int enforce_pod_count, cross_batch, batch_runs, score_bound, cohort, n_comp;
  int use_static, static_rows;
  int multi_queue, queue_proportion, overused_gate, n_queues;
  int queue_delta, qfair_ladder, qf_rows;
  // The launch plan (ops/megakernel.py::mega_plan): CTAs, node capacity of
  // a CTA's slice, dynamic shared memory, and each region's byte offset in
  // it (-1: the region stays in global memory).
  int ctas, slice, smem_bytes, off_queue, off_js, off_sig, off_job, off_static;
  int comp[4];
  float w_lr, w_bal, w_bp;
  float mins[8];
  // Releasing capacity, last so that the fields above keep their offsets.
  const float* rel0;      // [8, nb] releasing rows 0..r_dim-1 (has_releasing)
  int has_releasing;
};

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// binpack / least-requested / balanced terms, in the reference's order.
__device__ __forceinline__ float score_terms(const MegaArgs& a, float a_cpu, float a_mem,
                                             float s_cpu, float s_mem, float used_cpu,
                                             float used_mem) {
  float s = 0.0f;
  if (a.w_bp != 0.0f) {
    float fc = clip01(used_cpu / s_cpu);
    float fm = clip01(used_mem / s_mem);
    s = s + a.w_bp * (((fc + fm) / 2.0f) * 10.0f);
  }
  if (a.w_lr != 0.0f) {
    float lc = clip01((a_cpu - used_cpu) / s_cpu);
    float lm = clip01((a_mem - used_mem) / s_mem);
    s = s + a.w_lr * (((lc + lm) / 2.0f) * 10.0f);
  }
  if (a.w_bal != 0.0f) {
    float fc = clip01(used_cpu / s_cpu);
    float fm = clip01(used_mem / s_mem);
    s = s + a.w_bal * ((1.0f - fabsf(fc - fm)) * 10.0f);
  }
  return s;
}

// (value, index) order: larger value first, the lower index on ties.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

struct Top2 {
  float v1;
  int i1;
  float v2;
  int i2;
};

__device__ __forceinline__ Top2 top2_empty() { return {-INFINITY, BIG_I32, -INFINITY, BIG_I32}; }

// The two best of two disjoint top-2 lists: exact and associative, since
// (value, index) is a total order on distinct indices.
__device__ __forceinline__ void merge2(Top2& a, const Top2& b) {
  if (better(b.v1, b.i1, a.v1, a.i1)) {
    if (better(a.v1, a.i1, b.v2, b.i2)) {
      a.v2 = a.v1;
      a.i2 = a.i1;
    } else {
      a.v2 = b.v2;
      a.i2 = b.i2;
    }
    a.v1 = b.v1;
    a.i1 = b.i1;
  } else if (better(b.v1, b.i1, a.v2, a.i2)) {
    a.v2 = b.v1;
    a.i2 = b.i1;
  }
}

__device__ __forceinline__ Top2 shfl_xor2(const Top2& t, int off, bool both) {
  Top2 o;
  o.v1 = __shfl_xor_sync(0xffffffffu, t.v1, off);
  o.i1 = __shfl_xor_sync(0xffffffffu, t.i1, off);
  if (both) {
    o.v2 = __shfl_xor_sync(0xffffffffu, t.v2, off);
    o.i2 = __shfl_xor_sync(0xffffffffu, t.i2, off);
  } else {
    o.v2 = -INFINITY;
    o.i2 = BIG_I32;
  }
  return o;
}

// Every lane of the warp ends with the warp's top-2 (top-1 unless `both`).
__device__ __forceinline__ void warp_top2(Top2& t, bool both, int first_off) {
  for (int off = first_off; off > 0; off >>= 1) merge2(t, shfl_xor2(t, off, both));
}

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

__device__ __forceinline__ void store_async(uint32_t remote, float v, uint32_t remote_bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(remote), "r"(__float_as_uint(v)), "r"(remote_bar) : "memory");
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

struct Reduce {
  int i[WARPS];
  int out_i;
};

// Block-wide minimum of an int; every thread gets the result.
__device__ int block_min_i(int v, Reduce* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_down_sync(0xffffffffu, v, off));
  if (lane == 0) red->i[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? red->i[lane] : BIG_I32;
    for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) red->out_i = v;
  }
  __syncthreads();
  return red->out_i;
}

// The job lanes' operands, in shared memory or global memory.
struct Jobs {
  const int* off;
  const int* num;
  const int* def;
  const int* gang;
  const int* prio;
  const int* tb;
  const int* q;  // queue index (multi-queue mode)
};

// Comparator keys of job lane l.
__device__ __forceinline__ int key_priority(const Jobs& jo, int l) { return -jo.prio[l]; }

__device__ __forceinline__ int key_gang(const Jobs& jo, const float* js, int jp, int l) {
  return (((float)jo.gang[l] - js[JS_ALLOCATED * jp + l]) <= 0.0f) ? 1 : 0;
}

__device__ __forceinline__ float key_drf(const MegaArgs& a, const float* js, int l) {
  // Max over all 8 rows, padding rows contributing 0 (as the reference's
  // [8, J] fraction block does: drf_mask is 0 past r_dim).
  float key = 0.0f;
  for (int r = 0; r < 8; ++r) {
    float frac = 0.0f;
    if (r < a.r_dim && a.drf_mask[r] > 0.0f) frac = js[(JS_DRF + r) * a.j_pad + l] / a.drf_safe[r];
    key = (r == 0) ? frac : fmaxf(key, frac);
  }
  return key;
}

// Lane l can still be selected: no failed placement, tasks left.
__device__ __forceinline__ bool job_eligible(const Jobs& jo, const float* js, int jp, int l) {
  const int num = jo.num[l];
  return (js[JS_LEFT * jp + l] == 0.0f) && (js[JS_CONSUMED * jp + l] < (float)num) && (num > 0);
}

// A CTA's queue ledger in shared memory (multi-queue mode): per queue its
// deserved and live allocated (r_dim floats each), share and overused flag,
// and its placement count (qfair_ladder).
struct Queues {
  unsigned long long* best1;  // [n_queues] the queue's best job's key words 1..3
  unsigned long long* best2;  // (lane_key; best3 ~0: the queue has no job left)
  unsigned long long* best3;
  float* des;     // [n_queues][r_dim]
  float* alloc;   // [n_queues][r_dim]
  float* share;   // [n_queues]
  float* over;    // [n_queues], 1.0 = overused
  int* count;     // [n_queues] placements so far (qfair_ladder)
  int* qoff;      // [n_queues + 1] queue q's lanes: lanes[qoff[q] .. qoff[q + 1])
  int* qcur;      // [n_queues] scratch of the lanes' sort
  int* lanes;     // [j_pad] (global) the real job lanes, grouped by queue
};

// Proportion's share and overused flag of one queue, in the reference's
// float32 order (ops/megakernel.py::queue_share_overused): dims ascending,
// share = max of allocated / deserved (0/0 -> 0; cpu and memory x/0 -> 1;
// other dims with deserved 0 -> 0), overused = deserved - allocated < min
// on every dim.
__device__ __forceinline__ void share_overused(const float* d, const float* al, int r_dim,
                                               const float* mins, float* share, float* over) {
  float sh = 0.0f;
  bool ov = true;
  for (int r = 0; r < r_dim; ++r) {
    float fr = d[r] > 0.0f ? al[r] / d[r] : 0.0f;
    if (r < 2 && !(d[r] > 0.0f) && al[r] > 0.0f) fr = 1.0f;
    sh = r == 0 ? fr : fmaxf(sh, fr);
    ov = ov && (d[r] - al[r]) < mins[r];
  }
  *share = sh;
  *over = ov ? 1.0f : 0.0f;
}

// A job lane's selection key: the reference's selection as one
// lexicographic order, packed into four 64-bit words compared in turn.  In
// multi-queue mode the queue pop leads (the queue's share, then its index:
// the least share wins, then the lowest queue), then the comparator chain
// (each comparator's key in the conf's order, the least wins), the
// creation/uid rank and the lane.  Filtering the lanes field by field, as
// the reference does (the pop, then each comparator on the survivors), keeps
// the lexicographic minimum, so one pass and one block reduction select the
// same lane.
struct JobKey {
  unsigned long long w[4];
};

__device__ __forceinline__ JobKey key_none() { return {{~0ull, ~0ull, ~0ull, ~0ull}}; }

__device__ __forceinline__ bool key_less(const JobKey& x, const JobKey& y) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (x.w[k] != y.w[k]) return x.w[k] < y.w[k];
  return false;
}

// Order-preserving maps onto 32 bits: an int, and a float with -0 and +0
// equal (the reference compares the keys with ==).
__device__ __forceinline__ uint32_t ord_i(int i) { return (uint32_t)i ^ 0x80000000u; }

__device__ __forceinline__ uint32_t ord_f(float f) {
  const uint32_t u = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

struct KeyReduce {
  JobKey w[WARPS];
  JobKey out;
};

// Block-wide lexicographic minimum of the keys; every thread gets it.
__device__ JobKey block_min_key(JobKey k, KeyReduce* kr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    JobKey o;
#pragma unroll
    for (int i = 0; i < 4; ++i) o.w[i] = __shfl_down_sync(0xffffffffu, k.w[i], off);
    if (key_less(o, k)) k = o;
  }
  if (lane == 0) kr->w[warp] = k;
  __syncthreads();
  if (warp == 0) {
    k = lane < WARPS ? kr->w[lane] : key_none();
    for (int off = 16; off > 0; off >>= 1) {
      JobKey o;
#pragma unroll
      for (int i = 0; i < 4; ++i) o.w[i] = __shfl_down_sync(0xffffffffu, k.w[i], off);
      if (key_less(o, k)) k = o;
    }
    if (lane == 0) kr->out = k;
  }
  __syncthreads();
  return kr->out;
}

// Lane l's selection key below the queue pop: every comparator's key in the
// conf's order, the creation/uid rank and the lane (words 1 to 3 of the
// JobKey; word 0, the queue pop's, is left 0).
__device__ __forceinline__ JobKey lane_key(const MegaArgs& a, const Jobs& jo, const float* js,
                                           int l) {
  const int jp = a.j_pad;
  uint32_t c[3] = {0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (i >= a.n_comp) break;
    const int comp = a.comp[i];
    c[i] = comp == COMP_PRIORITY ? ord_i(key_priority(jo, l))
           : comp == COMP_GANG   ? ord_i(key_gang(jo, js, jp, l))
                                 : ord_f(key_drf(a, js, l));
  }
  return {{0ull, ((unsigned long long)c[0] << 32) | c[1],
           ((unsigned long long)c[2] << 32) | ord_i(jo.tb[l]), (unsigned long long)l}};
}

// Cursor mode's job to pop: over the eligible lanes at or before the
// cursor, the least key.  HALT when none is left.  Every CTA runs it on its
// own copy of the job ledger, with CTA barriers only.
__device__ int job_select(const MegaArgs& a, const Jobs& jo, const float* js, int cursor,
                          KeyReduce* kr) {
  const int jp = a.j_pad;
  const int last = min(cursor, jp - 1);
  JobKey best = key_none();
  for (int l = threadIdx.x; l <= last; l += THREADS) {
    if (!job_eligible(jo, js, jp, l)) continue;
    const JobKey k = lane_key(a, jo, js, l);
    if (key_less(k, best)) best = k;
  }
  best = block_min_key(best, kr);
  return best.w[3] == ~0ull ? HALT : (int)best.w[3];
}

// Multi-queue mode, queue q's best job: over the queue's eligible lanes
// (lanes[qoff[q] .. qoff[q + 1])), the least key below the queue pop, into
// the queue ledger (~0: none).  A lane's key and eligibility change only
// when its job is placed, so a pop rescans the queue of the job placed
// since the one before (all queues before the first pop).
__device__ void queue_rescan(const MegaArgs& a, const Jobs& jo, const float* js,
                             const Queues& qs, int q, KeyReduce* kr) {
  JobKey best = key_none();
  for (int i = qs.qoff[q] + threadIdx.x; i < qs.qoff[q + 1]; i += THREADS) {
    const int l = qs.lanes[i];
    if (!job_eligible(jo, js, a.j_pad, l)) continue;
    const JobKey k = lane_key(a, jo, js, l);
    if (key_less(k, best)) best = k;
  }
  best = block_min_key(best, kr);
  if (threadIdx.x == 0) {
    qs.best1[q] = best.w[1];
    qs.best2[q] = best.w[2];
    qs.best3[q] = best.w[3];
  }
}

// Multi-queue mode's pop: the reference selects the least key over the
// eligible lanes of the queues that are not overused, the queue's share and
// index leading.  That index is unique to a queue, so the least key is the
// best job of the queue with the least (share, index) among those that
// have one: warp 0 takes that minimum over the queues.  HALT when no queue
// has a job left.
__device__ int queue_select(const MegaArgs& a, const Queues& qs, int* sh_sel) {
  if (threadIdx.x < 32) {
    unsigned long long best = ~0ull;
    for (int q = threadIdx.x; q < a.n_queues; q += 32) {
      if (qs.best3[q] == ~0ull || (a.overused_gate && qs.over[q] >= 0.5f)) continue;
      const uint32_t share = a.queue_proportion ? ord_f(qs.share[q]) : 0u;
      const unsigned long long head = ((unsigned long long)share << 32) | (uint32_t)q;
      best = min(best, head);
    }
    for (int off = 16; off > 0; off >>= 1)
      best = min(best, __shfl_xor_sync(0xffffffffu, best, off));
    if (threadIdx.x == 0) *sh_sel = best == ~0ull ? HALT : (int)qs.best3[(uint32_t)best];
  }
  __syncthreads();
  return *sh_sel;
}

// A CTA's node slice in shared memory.
struct NodeSlice {
  float* idle;  // [r_dim][S]
  float* tcount;
  float* plim;
  float* acpu;
  float* amem;
  float* rel;   // [r_dim][S] (REL)
  uint8_t* gate;
  int S;
};

// One chunk's fit + score over the CTA's nodes, with r_dim = R known at
// compile time: every load of a node is issued before any is used, the fit
// is branch-free, and each thread keeps a running top-2 (top-1 unless
// `top2`) of (masked score, node index) in increasing node order.  With REL
// a node fits on its idle or its releasing rows; the score reads idle.
template <bool USE_STATIC, bool REL, int R>
__device__ __forceinline__ Top2 node_pass(const MegaArgs& a, const NodeSlice& ns, int base, int count,
                                          const float (&initqs)[8], const float (&mins)[8],
                                          float req_cpu, float req_mem, const float* mrow,
                                          const float* srow, bool any_w, bool top2) {
  const int S = ns.S;
  Top2 t = top2_empty();
  for (int l = threadIdx.x; l < count; l += THREADS) {
    float id[R], rl[R];
#pragma unroll
    for (int r = 0; r < R; ++r) id[r] = ns.idle[r * S + l];
    if (REL)
#pragma unroll
      for (int r = 0; r < R; ++r) rl[r] = ns.rel[r * S + l];
    const bool g = ns.gate[l] != 0;
    const float tc = a.enforce_pod_count ? ns.tcount[l] : 0.0f;
    const float pl = a.enforce_pod_count ? ns.plim[l] : 0.0f;
    const float ac = any_w ? ns.acpu[l] : 0.0f, am = any_w ? ns.amem[l] : 0.0f;
    const float ic = any_w ? ns.idle[a.cpu_idx * S + l] : 0.0f;
    const float im = any_w ? ns.idle[a.mem_idx * S + l] : 0.0f;
    const float mk = USE_STATIC ? mrow[l] : 1.0f;
    const float ss = USE_STATIC ? srow[l] : 0.0f;
    bool feas = g;
#pragma unroll
    for (int r = 0; r < R; ++r)
      feas = feas & ((initqs[r] < id[r]) | (fabsf(id[r] - initqs[r]) < mins[r]));
    if (REL) {
      bool feas_rel = g;
#pragma unroll
      for (int r = 0; r < R; ++r)
        feas_rel = feas_rel & ((initqs[r] < rl[r]) | (fabsf(rl[r] - initqs[r]) < mins[r]));
      feas = feas | feas_rel;
    }
    if (USE_STATIC) feas = feas & (mk > 0.0f);
    if (a.enforce_pod_count) feas = feas & (tc < pl);
    float score = 0.0f;
    if (any_w) {
      const float sc = ac > 0.0f ? ac : 1.0f, sm = am > 0.0f ? am : 1.0f;
      const float req_c = (ac - ic) + req_cpu;
      const float req_m = (am - im) + req_mem;
      score = score_terms(a, ac, am, sc, sm, req_c, req_m);
    }
    // The static score comes after every dynamic term, as in the reference.
    if (USE_STATIC) score = score + ss;
    const float masked = feas ? score : -INFINITY;
    const int n = base + l;
    if (better(masked, n, t.v1, t.i1)) {
      t.v2 = t.v1;
      t.i2 = t.i1;
      t.v1 = masked;
      t.i1 = n;
    } else if (top2 && better(masked, n, t.v2, t.i2)) {
      t.v2 = masked;
      t.i2 = n;
    }
  }
  return t;
}

// USE_STATIC selects static-row mode, MQ multi-queue mode and REL the
// releasing ledger at compile time: cursor mode keeps the register budget
// it has without them.
template <bool USE_STATIC, bool MQ, bool REL>
__global__ void __launch_bounds__(THREADS, 1) mega_allocate_kernel(const __grid_constant__ MegaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  // Every CTA's slot of the chunk, pushed here by its owner: [parity][rank][word],
  // and the mbarrier each parity's pushes complete on.
  __shared__ __align__(16) float slots[2][MAX_CTAS][SLOT_WORDS];
  __shared__ __align__(8) uint64_t slot_bar[2];
  __shared__ Top2 warp_top[WARPS];
  __shared__ Reduce red;
  __shared__ KeyReduce kred;
  __shared__ int sh_res[3];  // the chunk's winner, whether it placed, batch size
  __shared__ int sh_sel;     // multi-queue mode's pop
  __shared__ int grid_bad[GRID_WARPS];  // first k the score bound refuses, a warp
  __shared__ unsigned grid_ok[GRID_WARPS];  // k that fit and are <= hi0, a bit each

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = a.ctas;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = a.nb, jp = a.j_pad, r_dim = a.r_dim, S = a.slice;
  const int t_pad = a.t_rows * 128;
  const int out_len = (a.t_rows + 1) * 128;
  const int cohort = (a.batch_runs && !REL) ? max(1, a.cohort) : 1;
  const int max_steps = a.t_cap + 8;
  const int n_real = a.misc[0];
  const float neg_inf = -INFINITY;
  const bool any_w = a.w_lr != 0.0f || a.w_bal != 0.0f || a.w_bp != 0.0f;
  const bool top2 = a.score_bound && a.batch_runs;
  float mins[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) mins[r] = a.mins[r];

  // ---- the partition: equal contiguous shares of [0, last gated + 1) ----
  int last = -1;
  for (int n = tid; n < nb; n += THREADS)
    if (a.gate[n] != 0) last = n;
  const int n_cover = max(1, -block_min_i(-last, &red) + 1);
  const int share = (n_cover + C - 1) / C;
  const int base = min(rank * share, n_cover);
  const int count = min(share, n_cover - base);

  // ---- the CTA's state into shared memory, once ----
  float* idle = reinterpret_cast<float*>(smem);  // [r_dim][S]
  float* tcount = idle + (r_dim + NS_TC) * S;
  float* plim = idle + (r_dim + NS_PLIM) * S;
  float* acpu = idle + (r_dim + NS_AC) * S;
  float* amem = idle + (r_dim + NS_AM) * S;
  float* rel = idle + (r_dim + NS_FLOAT_ROWS) * S;  // [r_dim][S] (REL)
  uint8_t* gate =
      reinterpret_cast<uint8_t*>(idle + (r_dim + NS_FLOAT_ROWS + (REL ? r_dim : 0)) * S);
  const NodeSlice nsl = {idle, tcount, plim, acpu, amem, rel, gate, S};
  for (int l = tid; l < count; l += THREADS) {
    const int n = base + l;
    for (int r = 0; r < r_dim; ++r) idle[r * S + l] = a.ns0[r * nb + n];
    if (REL)
      for (int r = 0; r < r_dim; ++r) rel[r * S + l] = a.rel0[r * nb + n];
    tcount[l] = a.ns0[NROW_TASK_COUNT * nb + n];
    plim[l] = a.plim[n];
    acpu[l] = a.alloc_t[a.cpu_idx * nb + n];
    amem[l] = a.alloc_t[a.mem_idx * nb + n];
    gate[l] = a.gate[n];
  }
  const int js_rows = JS_DRF + r_dim;
  float* js = a.off_js >= 0 ? reinterpret_cast<float*>(smem + a.off_js)
                            : a.js_global + (size_t)rank * js_rows * jp;
  for (int x = tid; x < js_rows * jp; x += THREADS) {
    const int row = x / jp, l = x - row * jp;
    js[x] = row >= JS_DRF ? a.js_drf0[(row - JS_DRF) * jp + l] : 0.0f;
  }
  // Request table: rows r (request) and r_dim + r (init) of stride s_pad.
  const float* req_tab = a.sig_req + SIG_REQ_REQ * a.s_pad;
  const float* init_tab = a.sig_req + SIG_REQ_INIT * a.s_pad;
  if (a.off_sig >= 0) {
    float* t = reinterpret_cast<float*>(smem + a.off_sig);
    for (int x = tid; x < r_dim * a.s_pad; x += THREADS) {
      t[x] = req_tab[x];
      t[r_dim * a.s_pad + x] = init_tab[x];
    }
    req_tab = t;
    init_tab = t + r_dim * a.s_pad;
  }
  Jobs jo = {a.job_off, a.job_num, a.job_def, a.job_gang, a.job_prio, a.job_tb, a.jqueue};
  if (a.off_job >= 0) {
    int* t = reinterpret_cast<int*>(smem + a.off_job);
    for (int l = tid; l < jp; l += THREADS) {
      t[l] = a.job_off[l];
      t[jp + l] = a.job_num[l];
      t[2 * jp + l] = a.job_def[l];
      t[3 * jp + l] = a.job_gang[l];
      t[4 * jp + l] = a.job_prio[l];
      t[5 * jp + l] = a.job_tb[l];
      if (MQ) t[6 * jp + l] = a.jqueue[l];
    }
    jo = {t, t + jp, t + 2 * jp, t + 3 * jp, t + 4 * jp, t + 5 * jp, t + 6 * jp};
  }
  // Multi-queue mode: the queue ledger, one entry a queue, from the lanes of
  // the queue's jobs (the engine stages the same values on every lane of a
  // queue; padding lanes hold no job and are skipped), then each queue's
  // share and overused flag.  A queue index outside the ledger traps: the
  // ledger is sized by the caller's queue count, and nothing else bounds it.
  Queues qs = {};
  if (MQ) {
    const int nq = a.n_queues;
    unsigned long long* best = reinterpret_cast<unsigned long long*>(smem + a.off_queue);
    float* t = reinterpret_cast<float*>(best + 3 * nq);
    float* tail = t + (2 * r_dim + 2) * nq;
    int* qoff = reinterpret_cast<int*>(tail + nq);
    qs = {best, best + nq, best + 2 * nq, t, t + nq * r_dim, t + 2 * nq * r_dim,
          t + 2 * nq * r_dim + nq, reinterpret_cast<int*>(tail), qoff, qoff + nq + 1, a.qlanes};
    // Zeroes the rows, the overused flags and the placement counts.
    for (int x = tid; x < (2 * r_dim + 3) * nq; x += THREADS) t[x] = 0.0f;
    for (int q = tid; q <= nq; q += THREADS) qs.qoff[q] = 0;
    __syncthreads();
    for (int l = tid; l < jp; l += THREADS) {
      if (a.job_num[l] <= 0) continue;
      const int q = a.jqueue[l];
      if (q < 0 || q >= nq) __trap();
      for (int r = 0; r < r_dim; ++r) {
        qs.des[q * r_dim + r] = a.jq_des[r * jp + l];
        qs.alloc[q * r_dim + r] = a.jq_alloc0[r * jp + l];
      }
      atomicAdd(qs.qoff + q + 1, 1);
    }
    __syncthreads();
    // The lanes by queue: every CTA sums the counts (each queue's offset),
    // and warp 0 of rank 0 writes the real lanes in ascending order into
    // their queues' slots of the one list that all CTAs read after the
    // cluster barrier below, 32 lanes a round (the lanes of a round that
    // share a queue take consecutive slots, by their rank among them).
    if (tid == 0)
      for (int q = 0; q < nq; ++q) qs.qoff[q + 1] += qs.qoff[q];
    __syncthreads();
    if (rank == 0 && warp == 0) {
      for (int q = lane; q < nq; q += 32) qs.qcur[q] = qs.qoff[q];
      __syncwarp();
      for (int base = 0; base < jp; base += 32) {
        const int l = base + lane;
        const int q = (l < jp && a.job_num[l] > 0) ? a.jqueue[l] : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, q);
        const int slot = q >= 0 ? qs.qcur[q] + __popc(peers & ((1u << lane) - 1u)) : 0;
        __syncwarp();
        if (q >= 0) {
          qs.lanes[slot] = l;
          if (lane == 31 - __clz(peers)) qs.qcur[q] += __popc(peers);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // Rung 0 of the ladder is the value derived here.
    for (int q = tid; q < nq; q += THREADS)
      share_overused(qs.des + q * r_dim, qs.alloc + q * r_dim, r_dim, a.mins, qs.share + q,
                     qs.over + q);
  }
  // The full-recompute queue chain re-derives every queue's share and flag
  // at each pop.
  const bool full_chain = MQ && !a.queue_delta && (a.queue_proportion || a.overused_gate);
  // Static rows, indexed by the CTA's local node index.
  const float* smask_tab = nullptr;
  const float* sscore_tab = nullptr;
  int static_stride = nb;
  if (USE_STATIC && a.off_static < 0) {
    smask_tab = a.smask + base;
    sscore_tab = a.sscore + base;
  } else if (USE_STATIC) {
    float* t = reinterpret_cast<float*>(smem + a.off_static);
    for (int x = tid; x < a.static_rows * count; x += THREADS) {
      const int row = x / count, l = x - row * count;
      t[row * S + l] = a.smask[(size_t)row * nb + base + l];
      t[(a.static_rows + row) * S + l] = a.sscore[(size_t)row * nb + base + l];
    }
    smask_tab = t;
    sscore_tab = t + a.static_rows * S;
    static_stride = S;
  }
  if (rank == 0)
    for (int x = tid; x < out_len; x += THREADS) a.out[x] = UNPLACED;
  // The node row whose entry of the winner's column lane SL_IDLE + w of
  // warp 0 puts into slot word SL_IDLE + w (the static score row changes a
  // step).
  const float* col_src = nullptr;
  {
    const int w = lane - SL_IDLE;
    if (w < 0) col_src = nullptr;
    else if (w < r_dim) col_src = idle + w * S;
    else if (w == SL_TC - SL_IDLE) col_src = tcount;
    else if (w == SL_PLIM - SL_IDLE) col_src = plim;
    else if (w == SL_AC - SL_IDLE) col_src = acpu;
    else if (w == SL_AM - SL_IDLE) col_src = amem;
    else if (w == SL_IC - SL_IDLE && any_w) col_src = idle + a.cpu_idx * S;
    else if (w == SL_IM - SL_IDLE && any_w) col_src = idle + a.mem_idx * S;
  }
  if (tid == 0) {
    bar_init(&slot_bar[0]);
    bar_init(&slot_bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster.sync();  // every CTA's mbarriers are set before any push
  if (MQ)  // every queue's best job before the first pop (rank 0's list is in)
    for (int q = 0; q < a.n_queues; ++q) queue_rescan(a, jo, js, qs, q, &kred);

  int cur = -1, cursor = 0, n_dirty = 0, steps = 0, coh_steps = 0, chunk_pl = 0, qd_evt = 0;
  int dirty_q = -1;  // multi-queue mode: the queue of the job placed since the last pop
  int parity = 0;
  unsigned chunk_no = 0;  // chunks so far: parity = chunk_no & 1
#ifdef MEGA_PHASE_CLOCKS
  long long clocks[PHASES] = {};
  long long clock_at = clock64();
  const long long clock0 = clock_at;
  unsigned long long ns0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
#endif
  // Multi-queue mode has no cursor: its selection finds exhaustion (HALT).
  while (steps < max_steps &&
         (MQ ? cur != HALT : (cur >= 0 || (cur != HALT && (cursor < n_real || n_dirty > 0))))) {
    // ---- selection, in every CTA: in multi-queue mode the queue pop and
    // the chain within the winning queue at every pop (live shares move
    // with every placement), else the cursor ----
    int sel;
    if (cur == -1 && MQ) {
      if (full_chain)
        for (int q = tid; q < a.n_queues; q += THREADS)
          share_overused(qs.des + q * r_dim, qs.alloc + q * r_dim, r_dim, a.mins, qs.share + q,
                         qs.over + q);
      if (dirty_q >= 0) queue_rescan(a, jo, js, qs, dirty_q, &kred);
      __syncthreads();
      sel = queue_select(a, qs, &sh_sel);
    } else if (cur == -1) {
      if (n_dirty > 0) sel = job_select(a, jo, js, cursor, &kred);
      else sel = cursor < n_real ? cursor : HALT;
    } else {
      sel = cur;
    }
    // The cursor and the dirty count are cursor-mode state.
    const bool newly = !MQ && cur == -1 && sel >= 0;
    int cursor_r = cursor + ((newly && sel == cursor) ? 1 : 0);
    int dirty_r = n_dirty - ((newly && sel != cursor) ? 1 : 0);
    int cur_r = sel;

    int jb = min(max(sel, 0), jp - 1);
    float cons_c = js[JS_CONSUMED * jp + jb];
    float nalloc_c = js[JS_ALLOCATED * jp + jb];
    const int num_v = jo.num[jb];
    const int deficit_v = jo.def[jb];
    int t_c = min(max(jo.off[jb] + (int)cons_c, 0), t_pad - 1);
    const int sig = a.task_sig[t_c];
    int rl_c = a.run_len[t_c];
    // Static-row mode: the task's signature rows, read once per step (the
    // cohort chunks below reuse them: a run shares its rows by construction
    // of the run merge).
    const float* mrow = nullptr;
    const float* srow = nullptr;
    if (USE_STATIC) {
      const int ms = min(max(a.msig[t_c], 0), a.static_rows - 1);
      mrow = smask_tab + (size_t)ms * static_stride;
      srow = sscore_tab + (size_t)ms * static_stride;
    }
    float reqs[8], initqs[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      reqs[r] = r < r_dim ? req_tab[r * a.s_pad + sig] : 0.0f;
      initqs[r] = r < r_dim ? init_tab[r * a.s_pad + sig] : 0.0f;
    }
    const float req_cpu = req_tab[a.cpu_idx * a.s_pad + sig];
    const float req_mem = req_tab[a.mem_idx * a.s_pad + sig];
    const bool single0 = num_v == 1;
    const int q_job = MQ ? jo.q[jb] : 0;
    bool act = sel >= 0;

    TICK(0);  // the head of the step: selection, task entry, request rows
    // ---- cohort chunks ----
    for (int c = 0; c < cohort && act; ++c) {
      // This chunk's pushes, C slots of SLOT_WORDS floats, complete on
      // slot_bar[parity] (its phase before this one completed two chunks ago).
      if (tid == 0) bar_expect(&slot_bar[parity], C * SLOT_WORDS * 4);
      // fit + score over the CTA's nodes: a running top-2 (top-1 unless the
      // score bound needs the second-best).  Every load of a node is issued
      // before any is used, and the fit is branch-free.
      Top2 t;
      switch (r_dim) {
        case 1: t = node_pass<USE_STATIC, REL, 1>(a, nsl, base, count, initqs, mins, req_cpu, req_mem, mrow, srow, any_w, top2); break;
        case 2: t = node_pass<USE_STATIC, REL, 2>(a, nsl, base, count, initqs, mins, req_cpu, req_mem, mrow, srow, any_w, top2); break;
        case 3: t = node_pass<USE_STATIC, REL, 3>(a, nsl, base, count, initqs, mins, req_cpu, req_mem, mrow, srow, any_w, top2); break;
        case 4: t = node_pass<USE_STATIC, REL, 4>(a, nsl, base, count, initqs, mins, req_cpu, req_mem, mrow, srow, any_w, top2); break;
        case 5: t = node_pass<USE_STATIC, REL, 5>(a, nsl, base, count, initqs, mins, req_cpu, req_mem, mrow, srow, any_w, top2); break;
        case 6: t = node_pass<USE_STATIC, REL, 6>(a, nsl, base, count, initqs, mins, req_cpu, req_mem, mrow, srow, any_w, top2); break;
        case 7: t = node_pass<USE_STATIC, REL, 7>(a, nsl, base, count, initqs, mins, req_cpu, req_mem, mrow, srow, any_w, top2); break;
        default: t = node_pass<USE_STATIC, REL, 8>(a, nsl, base, count, initqs, mins, req_cpu, req_mem, mrow, srow, any_w, top2); break;
      }
      if (!top2) {
        t.v2 = neg_inf;
        t.i2 = BIG_I32;
      }
      TICK(1);  // the node pass
      // CTA: warps, then warp 0 pushes the CTA's slot (pairs and winner's
      // column) into every CTA of the cluster.
      warp_top2(t, top2, 16);
      if (lane == 0) warp_top[warp] = t;
      __syncthreads();
      TICK(2);  // warp reductions and the CTA barrier
      if (warp == 0) {
        t = lane < WARPS ? warp_top[lane] : top2_empty();
        warp_top2(t, top2, WARPS / 2);  // lanes 0..WARPS-1 end with the CTA's pairs
        const int win = __shfl_sync(0xffffffffu, t.i1, 0);
        const int loc = win - base;
        const bool mine = win != BIG_I32 && loc >= 0 && loc < count;
        // Lane w holds word w of the slot (lanes 0..3: the pairs; 4..19: the
        // winner's column) and stores it into every CTA's copy of this slot.
        const int w = lane - SL_IDLE;
        const float* src = (USE_STATIC && w == SL_SS - SL_IDLE) ? srow : col_src;
        float word = (w >= 0 && mine && src) ? src[loc] : 0.0f;
        if (lane == SL_V1) word = t.v1;
        if (lane == SL_I1) word = __int_as_float(t.i1);
        if (lane == SL_V2) word = t.v2;
        if (lane == SL_I2) word = __int_as_float(t.i2);
        if (lane < SLOT_WORDS) {
          const uint32_t mine_at = smem_addr(&slots[parity][rank][lane]);
          const uint32_t bar_at = smem_addr(&slot_bar[parity]);
          for (int p = 0; p < C; ++p)
            store_async(cluster_addr(mine_at, p), word, cluster_addr(bar_at, p));
        }
      }
      TICK(3);  // the CTA's pairs and the push of its slot
      // The grid warps wait until every CTA's slot of this chunk is here.
      if (warp < GRID_WARPS) bar_wait(&slot_bar[parity], (chunk_no >> 1) & 1u);
      TICK(4);  // the wait for the C slots

      // Cluster: warps 0..GRID_WARPS-1 of every CTA merge the C slots; each
      // takes 32 candidates of the batch grid, warp 0 combines them.
      if (warp < GRID_WARPS) {
        // Every lane merges the C slots' pairs itself (broadcast reads of its
        // own shared memory, a tree of merges in registers, eight slots at a
        // time): no shuffles.
        Top2 g = top2_empty();
        for (int p0 = 0; p0 < C; p0 += 8) {
          Top2 q[8];
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            if (p0 + p < C) {
              const float4 x = *reinterpret_cast<const float4*>(slots[parity][p0 + p]);
              q[p] = {x.x, __float_as_int(x.y), x.z, __float_as_int(x.w)};
            } else {
              q[p] = top2_empty();
            }
          }
#pragma unroll
          for (int step = 1; step < 8; step <<= 1)
#pragma unroll
            for (int p = 0; p + step < 8; p += 2 * step) merge2(q[p], q[p + step]);
          merge2(g, q[0]);
        }
        // The uncovered nodes [n_cover, nb) are all -inf: the first of them
        // stands for them all.
        if (n_cover < nb) merge2(g, Top2{neg_inf, n_cover, neg_inf, BIG_I32});
        const float bv = g.v1;
        const int best = min(g.i1, nb - 1);
        const bool placed = bv > neg_inf;
        const int owner = min(best / share, C - 1);
        const float* col = slots[parity][owner];  // the winner's column
        // With REL the winner's idle fit (from the idle rows of its column)
        // decides: allocate on idle, else pipeline onto releasing.
        bool alloc_here = placed;
        if (REL && placed) {
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            if (r < r_dim) {
              const float v = col[SL_IDLE + r];
              alloc_here = alloc_here & ((initqs[r] < v) | (fabsf(v - initqs[r]) < mins[r]));
            }
          }
        }
        const bool pipe_here = REL && placed && !alloc_here;
        TICK(5);  // the merge of the C slots

        // run batching on the winner (top-2 score bound unless binpack-only)
        int m = 1;
        if (a.batch_runs && alloc_here) {
          // The winner's column, from its owner's slot.
          float cidle[8];
#pragma unroll
          for (int r = 0; r < 8; ++r)
            cidle[r] = r < r_dim ? col[SL_IDLE + r] : 0.0f;
          int room = deficit_v > 0 ? deficit_v - (int)nalloc_c : 1;
          if (a.cross_batch && single0 && dirty_r == 0) room = MAX_BATCH;
          int hi0 = min(min(rl_c, MAX_BATCH), room);
          if (a.enforce_pod_count) {
            const float c_tc = col[SL_TC];
            const float c_plim = col[SL_PLIM];
            hi0 = min(hi0, (int)(c_plim - c_tc));
          }
          hi0 = max(hi0, 1);
          // Candidate k places k tasks: avail = idle - (k - 1) req must
          // still fit every row.
          auto fits = [&](float jm1) {
            bool okk = true;
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              if (r < r_dim) {
                const float avail = cidle[r] - jm1 * reqs[r];
                okk = okk & ((initqs[r] < avail) | (fabsf(avail - initqs[r]) < mins[r]));
              }
            }
            return okk;
          };
          // Four warps share the grid, a candidate a lane: k = 32 warp +
          // lane + 1 (one warp taking four candidates a lane measured
          // slower, even for the fit alone).  okm[w] bit b: k = 32 w + b + 1
          // fits and k <= hi0.
          const int k = 32 * warp + lane + 1;
          const float jm1 = (float)(k - 1);
          int bad = MAX_BATCH + 1;
          if (a.score_bound) {
            // The reference's second-best sets the winner's own entry to
            // -inf: with no other node feasible, its index is the lowest
            // -inf one.
            const float second = g.v2;
            const int second_idx = second == neg_inf ? min(g.i2, best) : g.i2;
            const float c_ac = col[SL_AC];
            const float c_am = col[SL_AM];
            const float c_ic = col[SL_IC];
            const float c_im = col[SL_IM];
            const float avail_c = c_ic - jm1 * req_cpu;
            const float avail_m = c_im - jm1 * req_mem;
            const float sc = c_ac > 0.0f ? c_ac : 1.0f, sm = c_am > 0.0f ? c_am : 1.0f;
            const float reqd_c = (c_ac - avail_c) + req_cpu;
            const float reqd_m = (c_am - avail_m) + req_mem;
            float s_js = score_terms(a, c_ac, c_am, sc, sm, reqd_c, reqd_m);
            if (USE_STATIC) s_js = s_js + col[SL_SS];
            const bool ok_s = (s_js > second) || ((s_js == second) && (best < second_idx));
            if (!ok_s) bad = k;
            for (int off = 16; off > 0; off >>= 1) bad = min(bad, __shfl_xor_sync(0xffffffffu, bad, off));
          }
          const unsigned mine = __ballot_sync(0xffffffffu, fits(jm1) && k <= hi0);
          if (lane == 0) {
            grid_bad[warp] = bad;
            grid_ok[warp] = mine;
          }
          asm volatile("bar.sync 1, %0;" ::"n"(32 * GRID_WARPS) : "memory");
          unsigned okm[GRID_WARPS];
          int first_false = MAX_BATCH + 1;
#pragma unroll
          for (int w = 0; w < GRID_WARPS; ++w) {
            first_false = min(first_false, grid_bad[w]);
            okm[w] = grid_ok[w];
          }
          // m = the largest k that fits, <= hi0, below the first k the bound
          // refuses (1 if none).
#pragma unroll
          for (int w = 0; w < GRID_WARPS; ++w) {
            const int keep = first_false - 1 - 32 * w;
            unsigned bits = okm[w];
            if (keep <= 0) bits = 0u;
            else if (keep < 32) bits &= (1u << keep) - 1u;
            if (bits) m = max(m, 32 * w + (31 - __clz(bits)) + 1);
          }
        }
        TICK(6);  // the batch grid
        // The chunk's outcome, known to all four warps; three of them apply
        // it side by side.
        const bool cross_active = a.cross_batch && single0 && alloc_here;
        const int consumed = alloc_here ? m : 1;
        const float m_alloc = alloc_here ? (float)m : 0.0f;
        const float pipe_f = pipe_here ? 1.0f : 0.0f;
        // The job's drf row and its queue's allocated grow by the tasks
        // placed on either ledger.
        const float placed_f = REL ? m_alloc + pipe_f : m_alloc;
        const int kw = cross_active ? m : 1;
        if (warp == 0) {
          if (lane == 0) {
            sh_res[0] = best;
            sh_res[1] = alloc_here ? 1 : (pipe_here ? 2 : 0);
            sh_res[2] = m;
          }
          // The next step most often reads the task table at t_c + consumed
          // and the job after this window: bring their lines into L1 now.
          const int t_next = min(t_c + consumed, t_pad - 1);
          const int j_next = min(jb + kw, jp - 1);
          const void* line = nullptr;
          if (lane == 0) line = a.task_sig + t_next;
          else if (lane == 1) line = a.run_len + t_next;
          else if (lane == 2 && USE_STATIC) line = a.msig + t_next;
          else if (a.off_job < 0 && lane == 3) line = a.job_off + j_next;
          else if (a.off_job < 0 && lane == 4) line = a.job_num + j_next;
          else if (a.off_job < 0 && lane == 5) line = a.job_def + j_next;
          if (line != nullptr) asm volatile("prefetch.global.L1 [%0];" ::"l"(line));
        } else if (warp == 1) {
          // node ledger: the winner's column, in its owner only
          if (alloc_here && owner == rank) {
            const int loc = best - base;
            float rq = 0.0f;
#pragma unroll
            for (int r = 0; r < 8; ++r)
              if (r == lane) rq = reqs[r];
            if (lane < r_dim) idle[lane * S + loc] = idle[lane * S + loc] - rq * m_alloc;
            if (lane == 31) tcount[loc] = tcount[loc] + m_alloc;
          }
          // releasing ledger: a pipelined copy, in the winner's owner only
          if (REL && pipe_here && owner == rank) {
            const int loc = best - base;
            float rq = 0.0f;
#pragma unroll
            for (int r = 0; r < 8; ++r)
              if (r == lane) rq = reqs[r];
            if (lane < r_dim) rel[lane * S + loc] = rel[lane * S + loc] - rq * pipe_f;
            if (lane == 31) tcount[loc] = tcount[loc] + pipe_f;
          }
        } else if (warp == 2) {
          // job ledger (this CTA's copy): one lane, or the window of a
          // cross-job batch
          const bool failed = !placed;
          for (int x = lane; x < kw; x += 32) {
            const int l = jb + x;
            if (l >= jp) break;
            const float drf_scale = cross_active ? 1.0f : placed_f;
            js[JS_CONSUMED * jp + l] = js[JS_CONSUMED * jp + l] + (cross_active ? 1.0f : (float)consumed);
            js[JS_ALLOCATED * jp + l] = js[JS_ALLOCATED * jp + l] + (cross_active ? 1.0f : m_alloc);
            js[JS_LEFT * jp + l] = js[JS_LEFT * jp + l] + (cross_active ? 0.0f : (failed ? 1.0f : 0.0f));
#pragma unroll
            for (int r = 0; r < 8; ++r)
              if (r < r_dim) js[(JS_DRF + r) * jp + l] = js[(JS_DRF + r) * jp + l] + reqs[r] * drf_scale;
          }
        } else if (MQ && warp == 3 && lane == 0 && placed) {
          if (a.qfair_ladder) {
            // The ladder: the queue's count grows by the placement, and its
            // share and flag are the rung tables' at the new count.  A count
            // past the tables traps, as the reference's index raises.
            const int k = qs.count[q_job] + m;
            if (k >= a.qf_rows) __trap();
            qs.count[q_job] = k;
            qs.share[q_job] = a.qf_share[(size_t)k * 128 + q_job];
            qs.over[q_job] = a.qf_over[(size_t)k * 128 + q_job];
          } else {
            // proportion's allocate handler: the job's queue grows by the
            // placement, then (delta chain) its share and overused flag are
            // re-derived from the values just written (this CTA's copy of
            // the queue ledger); the full-recompute chain waits for the pop.
            float* qa = qs.alloc + q_job * r_dim;
#pragma unroll
            for (int r = 0; r < 8; ++r)
              if (r < r_dim) qa[r] = qa[r] + reqs[r] * placed_f;
            if (!full_chain)
              share_overused(qs.des + q_job * r_dim, qa, r_dim, a.mins, qs.share + q_job,
                             qs.over + q_job);
          }
        }
      }
      TICK(7);  // the ledger updates
      __syncthreads();
      TICK(8);  // the closing CTA barrier
      parity ^= 1;
      ++chunk_no;
      const int best = sh_res[0];
      const bool alloc_here = REL ? sh_res[1] == 1 : sh_res[1] != 0;
      const bool pipe_here = REL && sh_res[1] == 2;
      const bool placed = alloc_here || pipe_here;
      const bool failed = !placed;
      const int m = sh_res[2];
      const bool cross_active = a.cross_batch && single0 && alloc_here;
      const int consumed = alloc_here ? m : 1;
      const float m_alloc = alloc_here ? (float)m : 0.0f;

      // result codes of the consumed tasks
      if (rank == 0 && tid < consumed && t_c + tid < out_len)
        a.out[t_c + tid] = alloc_here ? best : (pipe_here ? PIPE_BASE - best : FAILED);

      // pop end / running scalars (a pipelined copy counts toward
      // readiness, as the reference's `placed` does)
      const float row_after_alloc = nalloc_c + (cross_active ? 1.0f : m_alloc);
      const bool became_ready = placed && (row_after_alloc >= (float)deficit_v);
      const float cons_after = cons_c + (cross_active ? 1.0f : (float)consumed);
      const bool drained = cons_after >= (float)num_v;
      const bool end_pop = failed || became_ready || drained;
      cur_r = end_pop ? -1 : jb;
      dirty_r += (became_ready && !drained) ? 1 : 0;
      if (a.cross_batch) cursor_r += (cross_active ? m - 1 : 0) + ((c > 0 && single0) ? 1 : 0);
      if (c >= 1 && alloc_here) chunk_pl += m;
      if (MQ && placed) qd_evt += 1;
      if (c + 1 < cohort) {
        const bool cont_injob = alloc_here && !end_pop && (rl_c > consumed);
        const bool cont_cross = cross_active && (dirty_r == 0) && (rl_c > m);
        const bool act_next = cont_injob || cont_cross;
        if (c == 0 && act_next) coh_steps += 1;
        t_c = min(t_c + consumed, t_pad - 1);
        rl_c -= consumed;
        if (cont_cross) {
          jb += m;
          cons_c = 0.0f;
          nalloc_c = 0.0f;
        } else {
          cons_c = cons_c + (cross_active ? 1.0f : (float)consumed);
          nalloc_c = nalloc_c + m_alloc;
        }
        act = act_next;
      }
    }
    TICK(9);  // the scalars after the last chunk
    if (MQ && sel >= 0) dirty_q = q_job;
    cur = cur_r;
    cursor = cursor_r;
    n_dirty = dirty_r;
    steps += 1;
  }
#ifdef MEGA_PHASE_CLOCKS
  unsigned long long ns1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
  if (rank == 0 && tid == 0 && a.phase_clocks != nullptr) {
    for (int k = 0; k < PHASES; ++k) a.phase_clocks[k] = clocks[k];
    a.phase_clocks[PHASES] = clock64() - clock0;
    a.phase_clocks[PHASES + 1] = (long long)(ns1 - ns0);
  }
#endif
  if (rank == 0 && tid == 0) {
    // qd_evt counts placements: delta refreshes, or rung lookups with the
    // ladder.
    const bool chain = MQ && (a.queue_proportion || a.overused_gate);
    a.stats[0] = steps;
    a.stats[1] = coh_steps;
    a.stats[2] = chunk_pl;
    a.stats[3] = chain && a.queue_delta && !a.qfair_ladder ? qd_evt : 0;
    a.stats[4] = full_chain ? steps : 0;
    a.stats[5] = chain && a.qfair_ladder ? qd_evt : 0;
    for (int x = 6; x < STATS_WIDTH; ++x) a.stats[x] = 0;
  }
  cluster.sync();  // no CTA exits while a peer may still push into it
}

template <bool USE_STATIC, bool MQ, bool REL>
static int launch(const MegaArgs* args, void* stream) {
  auto kernel = mega_allocate_kernel<USE_STATIC, MQ, REL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         args->smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (args->ctas > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = args->ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.gridDim = dim3(args->ctas, 1, 1);
  config.blockDim = dim3(THREADS, 1, 1);
  config.dynamicSmemBytes = args->smem_bytes;
  config.stream = (cudaStream_t)stream;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &config);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return ERR_NO_CLUSTER;
  err = cudaLaunchKernelEx(&config, kernel, *args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int mega_allocate_launch(const MegaArgs* args, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (args->ctas < 1 || args->ctas > MAX_CTAS) return (int)cudaErrorInvalidValue;
  if (args->has_releasing) {
    if (args->multi_queue)
      return args->use_static ? launch<true, true, true>(args, stream)
                              : launch<false, true, true>(args, stream);
    return args->use_static ? launch<true, false, true>(args, stream)
                            : launch<false, false, true>(args, stream);
  }
  if (args->multi_queue)
    return args->use_static ? launch<true, true, false>(args, stream)
                            : launch<false, true, false>(args, stream);
  return args->use_static ? launch<true, false, false>(args, stream)
                          : launch<false, false, false>(args, stream);
}
