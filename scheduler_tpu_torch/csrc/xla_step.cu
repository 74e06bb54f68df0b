// xla_step: one step of the fused_allocate loop's XLA step arm in one launch.
//
// Replaces scheduler_tpu/ops/fused.py:704-864, the JAX loop's selection,
// batch sizing and node-row update where the placement-step kernel (K1) is
// gated off: the session has releasing capacity, the top-2 score bound is
// live (runs batch under scorers other than binpack alone), or the node
// state outgrows K1's budget.  In the JAX package it is XLA code inside the
// loop's one device program, not a Pallas kernel; as PyTorch operations it
// was about 110 launches and one readback a step, so the port gives it a
// kernel.  The plain PyTorch version is
// scheduler_tpu_torch/ops/xla_step.py::xla_step_reference; the two must
// agree bit for bit on the five results and on the node state.
//
// What it computes, in float32, for task row t and static row s over the
// node state ns [n, 2r + 1] (idle | releasing | task count, a node a row):
// the epsilon fit init < avail | |avail - init| < min on every dim, against
// idle alone or jointly against idle and releasing; the node gate, the
// static mask row and task count < pod limit; the score dynamic_score in
// ops/scoring.py's order (requested = (allocatable - idle) + req, then
// 0 + w_lr * least-requested + w_bal * balanced + w_bp * binpack, a zero
// weight skipping its term; NOT K1's order, which adds binpack first) plus
// the static score row; the masked lowest-index argmax (all -inf: node 0)
// and whether it is feasible; allocate where the winner fits idle, else
// pipeline where it fits releasing.  With batch_runs and a host cap hi0 >
// 1: the cap hi (under the pod count min(pod limit - int(task count), hi0),
// at least 1), the 128-candidate grid avail = idle - float(j - 1) * req on
// the winner, its fit a max over all j <= hi (not a prefix), and under the
// score bound the runner-up (second best, lowest index; index 0 where every
// other node is -inf) and the prefix of j whose grid score s_j beats it
// (s_j > second, or equal with best < second's index).  Then the winner's
// row: idle + (-req * (alloc * m)), releasing + (-req * pipe), task count +
// (alloc | pipe) * copies.  Results {best, feasible, alloc, pipe, m}.
//
// What bounds it on this card: latency.  A step reads each node's row,
// allocatable columns, gate, pod limit and static row once, about 38 KB at
// path i (1,024 nodes), resident in L2 across steps: about 0.01 us at the
// memory rate.  Its operations (about 80 a node) are negligible.  So the
// design keeps the launch, the rounds of loads, the reductions and the
// result's way to the host to one each:
//
// * One CTA of up to 1,024 threads, a node a thread where the node count
//   fits, and strided over the nodes past that: any node count.  The plan
//   is ops/xla_step.py::step_plan.
// * Each thread keeps a top-2 of (score, lowest index) over its nodes;
//   warps merge with shuffles and warp 0 merges the warps.  Every merge
//   breaks ties by the lowest index, so best, second and second's index
//   are the reference's at any thread count.
// * The winner's row is then read in place (dims strided over a warp's
//   lanes for its fits), the batch sized on 128 threads (warp ballots for
//   the score prefix, a max for the count) and the row added in place;
//   the next step reads it from L2.
// * The task's rows (init request, request) and the epsilons are read from
//   device memory, so any resource dim count works.  The five results go
//   to mapped pinned host memory with a system-scope fence: no copy back.
//   A loop step (xla_step_loop_step) is one launch and one wait, bracketed
//   by two events that time it.
//
// Bitwise parity with the float32 reference rests on: no FMA contraction
// (built with --fmad=false; the arithmetic below also spells out its
// round-to-nearest intrinsics), IEEE division, every expression in the
// reference's operation order, and lowest-index tie breaking in every
// reduction.  NaN inputs are out of contract, as in K1.
//
// Build: with the port's other kernels, by scheduler_tpu_torch/ops/cuda_build.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define XS_MAX_THREADS 1024
#define XS_MIN_THREADS 128   // the candidate grid's threads
#define XS_GRID 128          // ops/fused.py MAX_BATCH
#define XS_BIG_I32 2147483647

// Mirrors XlaStepParams in scheduler_tpu_torch/ops/xla_step.py.
struct XlaStepParams {
  float* ns;              // [n, 2r + 1]: idle, releasing, task count
  const float* alloc;     // [n, r]
  const int* plim;        // [n] int32
  const uint8_t* gate;    // [n] bool
  const uint8_t* smask;   // static mask row s (read under use_static)
  const float* sscore;    // static score row s (read under use_static)
  const float* initq;     // init request row t [r]
  const float* req;       // request row t [r]
  const float* mins;      // epsilons [r]
  int* out;               // int32[8] in mapped host memory: best, feasible, alloc, pipe, m
  int n;
  int r;
  int cpu_idx;
  int mem_idx;
  int use_static;
  int enforce_pod_count;
  int has_releasing;
  int batch_runs;
  int score_bound;
  int hi0;
  float w_lr;
  float w_bal;
  float w_bp;
};

// Mirrors XlaLoop in scheduler_tpu_torch/ops/xla_step.py.
struct XlaLoop {
  XlaStepParams p;        // smask / sscore at static row 0, initq / req at task row 0
  int* out_host;          // mapped pinned int32[8]
  cudaEvent_t ev0;
  cudaEvent_t ev1;
  double xla_ms;          // the launches' event time, summed over the steps
  long long steps;        // launches made through the loop step
  long long s_stride;     // elements between two static rows (the node count)
  int t_rows;             // task rows
  int s_rows;             // static rows
  int threads;            // threads of the one CTA
};

struct Top2 {
  float v1;
  int i1;
  float v2;
  int i2;
};

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void top2_push(Top2& t, float v, int i) {
  if (better(v, i, t.v1, t.i1)) {
    t.v2 = t.v1;
    t.i2 = t.i1;
    t.v1 = v;
    t.i1 = i;
  } else if (better(v, i, t.v2, t.i2)) {
    t.v2 = v;
    t.i2 = i;
  }
}

__device__ __forceinline__ void top2_empty(Top2& t) {
  t.v1 = t.v2 = -INFINITY;
  t.i1 = t.i2 = XS_BIG_I32;
}

// Lane 0 ends with the warp's top-2.
__device__ __forceinline__ void warp_top2(Top2& t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v1 = __shfl_down_sync(0xffffffffu, t.v1, off);
    const int i1 = __shfl_down_sync(0xffffffffu, t.i1, off);
    const float v2 = __shfl_down_sync(0xffffffffu, t.v2, off);
    const int i2 = __shfl_down_sync(0xffffffffu, t.i2, off);
    top2_push(t, v1, i1);
    top2_push(t, v2, i2);
  }
}

// torch.clamp(x, 0, 1).
__device__ __forceinline__ float clip01(float x) {
  float y = x < 0.0f ? 0.0f : x;
  return y > 1.0f ? 1.0f : y;
}

__device__ __forceinline__ bool eps_fit(float initq, float avail, float mins) {
  return (initq < avail) | (fabsf(__fsub_rn(avail, initq)) < mins);
}

// ops/scoring.py::dynamic_score for one node (cpu / memory columns of
// allocatable, of the idle or candidate row and of the request), in its
// operation order.
__device__ __forceinline__ float dyn_score(const XlaStepParams& p, float ac, float am, float ic,
                                           float im, float qc, float qm) {
  float score = 0.0f;
  if (p.w_lr != 0.0f || p.w_bal != 0.0f || p.w_bp != 0.0f) {
    const float rc = __fadd_rn(__fsub_rn(ac, ic), qc);
    const float rm = __fadd_rn(__fsub_rn(am, im), qm);
    const float sc = ac > 0.0f ? ac : 1.0f;
    const float sm = am > 0.0f ? am : 1.0f;
    if (p.w_lr != 0.0f) {
      const float lc = clip01(__fdiv_rn(__fsub_rn(ac, rc), sc));
      const float lm = clip01(__fdiv_rn(__fsub_rn(am, rm), sm));
      score = __fadd_rn(score, __fmul_rn(p.w_lr, __fmul_rn(__fdiv_rn(__fadd_rn(lc, lm), 2.0f),
                                                           10.0f)));
    }
    if (p.w_bal != 0.0f) {
      const float bc = clip01(__fdiv_rn(rc, sc));
      const float bm = clip01(__fdiv_rn(rm, sm));
      const float diff = fabsf(__fsub_rn(bc, bm));
      score = __fadd_rn(score, __fmul_rn(p.w_bal, __fmul_rn(__fsub_rn(1.0f, diff), 10.0f)));
    }
    if (p.w_bp != 0.0f) {
      const float fc = clip01(__fdiv_rn(rc, sc));
      const float fm = clip01(__fdiv_rn(rm, sm));
      score = __fadd_rn(score, __fmul_rn(p.w_bp, __fmul_rn(__fdiv_rn(__fadd_rn(fc, fm), 2.0f),
                                                           10.0f)));
    }
  }
  return score;
}

__global__ void __launch_bounds__(XS_MAX_THREADS, 1)
    xla_step_kernel(const __grid_constant__ XlaStepParams p) {
  __shared__ Top2 warp_top[XS_MAX_THREADS / 32];
  __shared__ float s_best_vals[5];       // allocatable cpu, memory; static score; idle cpu, memory
  __shared__ int s_ints[4];              // best, second's index, pod limit, hi
  __shared__ float s_second;
  __shared__ int s_flags[3];             // feasible, alloc, pipe
  __shared__ unsigned s_cut[XS_GRID / 32];
  __shared__ int s_cap[XS_GRID / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x;
  const int r = p.r, W = 2 * r + 1, n = p.n;
  const float qc = p.req[p.cpu_idx], qm = p.req[p.mem_idx];

  // Each thread's nodes, strided; its top-2 of (masked score, lowest index).
  Top2 t;
  top2_empty(t);
  for (int j = tid; j < n; j += T) {
    const float* row = p.ns + (size_t)j * W;
    bool fit_idle = true, fit_rel = true;
    for (int d = 0; d < r; ++d) {
      const float iq = p.initq[d], mn = p.mins[d];
      fit_idle &= eps_fit(iq, row[d], mn);
      if (p.has_releasing) fit_rel &= eps_fit(iq, row[r + d], mn);
    }
    bool feasible = (p.has_releasing ? (fit_idle | fit_rel) : fit_idle) && p.gate[j] != 0;
    if (p.use_static) feasible = feasible && p.smask[j] != 0;
    if (p.enforce_pod_count) feasible = feasible && row[2 * r] < __int2float_rn(p.plim[j]);
    const float* a = p.alloc + (size_t)j * r;
    float score =
        dyn_score(p, a[p.cpu_idx], a[p.mem_idx], row[p.cpu_idx], row[p.mem_idx], qc, qm);
    if (p.use_static) score = __fadd_rn(score, p.sscore[j]);
    top2_push(t, feasible ? score : -INFINITY, j);
  }

  // The CTA's top-2: each warp's, then warp 0 merges them.
  warp_top2(t);
  if (lane == 0) warp_top[warp] = t;
  __syncthreads();
  if (warp == 0) {
    if (lane < T / 32) {
      t = warp_top[lane];
    } else {
      top2_empty(t);
    }
    warp_top2(t);
    if (lane == 0) {
      // All -inf: node 0 holds the max at the lowest index; its runner-up's
      // index is 0 wherever the second best is -inf (argmax of all -inf).
      const int best = t.i1;
      s_ints[0] = best;
      s_flags[0] = t.v1 > -INFINITY;
      s_second = t.v2;
      s_ints[1] = t.v2 > -INFINITY ? t.i2 : 0;
      const float* row = p.ns + (size_t)best * W;
      s_best_vals[0] = p.alloc[(size_t)best * r + p.cpu_idx];
      s_best_vals[1] = p.alloc[(size_t)best * r + p.mem_idx];
      s_best_vals[2] = p.use_static ? p.sscore[best] : 0.0f;
      s_best_vals[3] = row[p.cpu_idx];
      s_best_vals[4] = row[p.mem_idx];
      s_ints[2] = p.plim[best];
    }
    __syncwarp();
    // The winner's fits against idle and releasing, dims strided over the lanes.
    const float* row = p.ns + (size_t)s_ints[0] * W;
    bool fi = true, fr = true;
    for (int d = lane; d < r; d += 32) {
      fi &= eps_fit(p.initq[d], row[d], p.mins[d]);
      fr &= eps_fit(p.initq[d], row[r + d], p.mins[d]);
    }
    fi = __all_sync(0xffffffffu, fi);
    fr = __all_sync(0xffffffffu, fr);
    if (lane == 0) {
      const bool any = s_flags[0] != 0;
      const bool al = p.has_releasing ? (any && fi) : any;
      const bool pi = p.has_releasing && any && !fi && fr;
      s_flags[1] = al;
      s_flags[2] = pi;
      int hi = p.hi0 > 1 ? p.hi0 : 1;
      if (p.enforce_pod_count) {
        const int room = s_ints[2] - (int)row[2 * r];
        hi = min(room, p.hi0);
        hi = hi > 1 ? hi : 1;
      }
      s_ints[3] = hi;
    }
  }
  __syncthreads();
  const int best = s_ints[0];
  float* brow = p.ns + (size_t)best * W;
  const bool alloc_here = s_flags[1] != 0, pipe_here = s_flags[2] != 0;
  int m = 1;
  if (p.batch_runs && p.hi0 > 1 && alloc_here) {
    // The candidate grid on the winner: thread tid is j = tid + 1.
    if (tid < XS_GRID) {
      const float jf = (float)tid;
      bool fits = true;
      for (int d = 0; d < r; ++d) {
        const float avail = __fsub_rn(brow[d], __fmul_rn(jf, p.req[d]));
        fits &= eps_fit(p.initq[d], avail, p.mins[d]);
      }
      bool cut = false;
      if (p.score_bound) {
        const float ac = __fsub_rn(s_best_vals[3], __fmul_rn(jf, qc));
        const float am = __fsub_rn(s_best_vals[4], __fmul_rn(jf, qm));
        float s = dyn_score(p, s_best_vals[0], s_best_vals[1], ac, am, qc, qm);
        if (p.use_static) s = __fadd_rn(s, s_best_vals[2]);
        const float second = s_second;
        const bool ok_s = s > second || (s == second && best < s_ints[1]);
        cut = !ok_s;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, cut);
      if (lane == 0) s_cut[warp] = ballot;
      asm volatile("bar.sync 1, %0;" ::"n"(XS_GRID) : "memory");  // warps 0..3
      // The score's prefix (the reference's cumprod): j keeps it while no
      // candidate up to j was cut.
      int first_cut = XS_GRID;
      for (int w = XS_GRID / 32 - 1; w >= 0; --w) {
        if (s_cut[w] != 0u) first_cut = 32 * w + __ffs(s_cut[w]) - 1;
      }
      const int j = tid + 1;
      int c = (fits && tid < first_cut && j <= s_ints[3]) ? j : 1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) c = max(c, __shfl_down_sync(0xffffffffu, c, off));
      if (lane == 0) s_cap[warp] = c;
    }
    __syncthreads();
    for (int w = 0; w < XS_GRID / 32; ++w) m = max(m, s_cap[w]);
  }
  // The winner's row, added in place as the reference's index_add_ (every
  // read of it above is behind the last barrier).
  for (int k = tid; k < W; k += T) {
    float delta;
    if (k < r) {
      delta = __fmul_rn(-p.req[k], alloc_here ? (float)m : 0.0f);
    } else if (k < 2 * r) {
      delta = __fmul_rn(-p.req[k - r], pipe_here ? 1.0f : 0.0f);
    } else {
      delta = (alloc_here || pipe_here) ? (float)(alloc_here ? m : 1) : 0.0f;
    }
    brow[k] = __fadd_rn(brow[k], delta);
  }
  if (tid == 0) {
    *reinterpret_cast<int4*>(p.out) = make_int4(best, s_flags[0], alloc_here, pipe_here);
    p.out[4] = m;
    __threadfence_system();
  }
}

// The launch parameters of one step: task row t_idx, static row s_idx, host cap hi0.
static void step_params(const XlaLoop* L, int t_idx, int s_idx, int hi0, XlaStepParams* p) {
  *p = L->p;
  p->initq += (size_t)t_idx * p->r;
  p->req += (size_t)t_idx * p->r;
  p->hi0 = hi0;
  if (p->use_static) {
    p->smask += (size_t)s_idx * L->s_stride;
    p->sscore += (size_t)s_idx * L->s_stride;
  }
}

extern "C" int xla_step_loop_size() { return (int)sizeof(XlaLoop); }

// Checks the plan, sets up the events and the mapped pinned result
// (L->out_host, its device address in L->p.out).
extern "C" int xla_step_loop_begin(XlaLoop* L) {
  const XlaStepParams& p = L->p;
  L->xla_ms = 0.0;
  L->steps = 0;
  L->ev0 = L->ev1 = nullptr;
  L->out_host = nullptr;
  cudaGetLastError();
  if (p.r < 2 || p.n < 1 || L->t_rows < 1 || (p.use_static && L->s_rows < 1) ||
      L->threads < XS_MIN_THREADS || L->threads > XS_MAX_THREADS || L->threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  int rc = (int)cudaHostAlloc((void**)&L->out_host, 8 * sizeof(int), cudaHostAllocMapped);
  if (rc == 0) rc = (int)cudaHostGetDevicePointer((void**)&L->p.out, L->out_host, 0);
  if (rc == 0) rc = (int)cudaEventCreate(&L->ev0);
  if (rc == 0) rc = (int)cudaEventCreate(&L->ev1);
  if (rc == 0) {
    for (int i = 0; i < 8; ++i) L->out_host[i] = 0;
  }
  return rc;
}

extern "C" int xla_step_loop_end(XlaLoop* L) {
  if (L->ev0) cudaEventDestroy(L->ev0);
  if (L->ev1) cudaEventDestroy(L->ev1);
  if (L->out_host) cudaFreeHost(L->out_host);
  L->ev0 = L->ev1 = nullptr;
  L->out_host = nullptr;
  return (int)cudaGetLastError();
}

// One loop step: launch, bracketed by the loop's events, and wait; the
// five results are in L->out_host.
extern "C" int xla_step_loop_step(XlaLoop* L, int t_idx, int s_idx, int hi0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaGetLastError();  // clear a stale error so the return value is this step's
  if (t_idx < 0 || t_idx >= L->t_rows || (L->p.use_static && (s_idx < 0 || s_idx >= L->s_rows)))
    return (int)cudaErrorInvalidValue;
  XlaStepParams p;
  step_params(L, t_idx, s_idx, hi0, &p);
  cudaEventRecord(L->ev0, s);
  xla_step_kernel<<<1, L->threads, 0, s>>>(p);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  cudaEventRecord(L->ev1, s);
  rc = (int)cudaStreamSynchronize(s);
  if (rc != 0) return rc;
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, L->ev0, L->ev1);
  L->xla_ms += ms;
  L->steps += 1;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Shard mode: the step over one block of a node mesh (ops/mesh.py), the
// counterpart of the JAX loop's XLA arm under GSPMD over a sharded node
// ledger (scheduler_tpu/ops/fused.py:683-700).  One launch a shard a step;
// each writes a candidate and the host merges the D candidates with
// compares only (ops/xla_step.py::XlaShardStep), so the merged result and
// the node state are bitwise those of xla_step_kernel over the whole axis.
//
// A launch first adds the row the host pushes (the previous step's winner,
// when this shard owns it: the same delta expressions as xla_step_kernel's
// row add), then scans its block as xla_step_kernel does and writes, at its
// local winner: the global index, the masked score, the idle and releasing
// fits, the block's runner-up (score, global index; XS_BIG_I32 where the
// block has one node), the pod room plim - int(task count), and, where the
// batch grid applies (batch_runs, hi0 > 1 and the winner fits idle), the
// 128 candidates' fits as a bit mask and their grid scores s_j.  The host
// picks the winner, the runner-up of the union of the blocks' top-2, the
// cap hi, and the count m from the winning block's grid; its row add rides
// the next step's launch of the owning shard.

#define XS_CAND_WORDS 144

// Candidate words (ops/xla_step.py SHARD_CAND).
#define XC_BEST 0
#define XC_SCORE 1
#define XC_FIT_IDLE 2
#define XC_FIT_REL 3
#define XC_SECOND 4
#define XC_SECOND_IDX 5
#define XC_ROOM 6
#define XC_GRID 7
#define XC_FITS 8      // 4 words: bit j - 1 of the mask is candidate j's fit
#define XC_S 12        // 128 floats: candidate j's grid score at word 12 + j - 1

// Mirrors XlaShardParams in scheduler_tpu_torch/ops/xla_step.py.
struct XlaShardParams {
  XlaStepParams p;        // the block: ns, alloc, plim, gate, static rows at its rows
  const float* push_req;  // request row of the pushed task
  int push_row;           // local row the previous step placed on (-1: none)
  int push_m;
  int push_alloc;
  int push_pipe;
  int scan;               // 0: only the push
  int offset;             // global index of the block's row 0
};

// Mirrors XlaShardLoop in scheduler_tpu_torch/ops/xla_step.py.
struct XlaShardLoop {
  XlaShardParams q;       // static rows at row 0, initq / req at task row 0
  int* out_host;          // mapped pinned int32[XS_CAND_WORDS]
  cudaEvent_t ev0;
  cudaEvent_t ev1;
  double xla_ms;
  long long steps;
  long long s_stride;     // elements between two static rows (the block's node count)
  int t_rows;
  int s_rows;
  int threads;
};

__global__ void __launch_bounds__(XS_MAX_THREADS, 1)
    xla_shard_kernel(const __grid_constant__ XlaShardParams q) {
  __shared__ Top2 warp_top[XS_MAX_THREADS / 32];
  __shared__ float s_best_vals[5];       // allocatable cpu, memory; static score; idle cpu, memory
  __shared__ int s_ints[2];              // best, alloc (the grid applies)

  const XlaStepParams& p = q.p;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x;
  const int r = p.r, W = 2 * r + 1, n = p.n;

  // The pushed row, as xla_step_kernel's row add.
  if (q.push_row >= 0) {
    float* prow = p.ns + (size_t)q.push_row * W;
    const bool al = q.push_alloc != 0, pi = q.push_pipe != 0;
    for (int k = tid; k < W; k += T) {
      float delta;
      if (k < r) {
        delta = __fmul_rn(-q.push_req[k], al ? (float)q.push_m : 0.0f);
      } else if (k < 2 * r) {
        delta = __fmul_rn(-q.push_req[k - r], pi ? 1.0f : 0.0f);
      } else {
        delta = (al || pi) ? (float)(al ? q.push_m : 1) : 0.0f;
      }
      prow[k] = __fadd_rn(prow[k], delta);
    }
    __syncthreads();
  }
  if (!q.scan) return;

  const float qc = p.req[p.cpu_idx], qm = p.req[p.mem_idx];
  Top2 t;
  top2_empty(t);
  for (int j = tid; j < n; j += T) {
    const float* row = p.ns + (size_t)j * W;
    bool fit_idle = true, fit_rel = true;
    for (int d = 0; d < r; ++d) {
      const float iq = p.initq[d], mn = p.mins[d];
      fit_idle &= eps_fit(iq, row[d], mn);
      if (p.has_releasing) fit_rel &= eps_fit(iq, row[r + d], mn);
    }
    bool feasible = (p.has_releasing ? (fit_idle | fit_rel) : fit_idle) && p.gate[j] != 0;
    if (p.use_static) feasible = feasible && p.smask[j] != 0;
    if (p.enforce_pod_count) feasible = feasible && row[2 * r] < __int2float_rn(p.plim[j]);
    const float* a = p.alloc + (size_t)j * r;
    float score =
        dyn_score(p, a[p.cpu_idx], a[p.mem_idx], row[p.cpu_idx], row[p.mem_idx], qc, qm);
    if (p.use_static) score = __fadd_rn(score, p.sscore[j]);
    top2_push(t, feasible ? score : -INFINITY, j);
  }
  warp_top2(t);
  if (lane == 0) warp_top[warp] = t;
  __syncthreads();
  int* out = p.out;
  if (warp == 0) {
    if (lane < T / 32) {
      t = warp_top[lane];
    } else {
      top2_empty(t);
    }
    warp_top2(t);
    if (lane == 0) {
      const int best = t.i1;
      s_ints[0] = best;
      out[XC_BEST] = best + q.offset;
      out[XC_SCORE] = __float_as_int(t.v1);
      out[XC_SECOND] = __float_as_int(t.v2);
      out[XC_SECOND_IDX] = t.i2 < XS_BIG_I32 ? t.i2 + q.offset : XS_BIG_I32;
      const float* row = p.ns + (size_t)best * W;
      s_best_vals[0] = p.alloc[(size_t)best * r + p.cpu_idx];
      s_best_vals[1] = p.alloc[(size_t)best * r + p.mem_idx];
      s_best_vals[2] = p.use_static ? p.sscore[best] : 0.0f;
      s_best_vals[3] = row[p.cpu_idx];
      s_best_vals[4] = row[p.mem_idx];
      out[XC_ROOM] = p.plim[best] - (int)row[2 * r];
    }
    __syncwarp();
    const float* row = p.ns + (size_t)s_ints[0] * W;
    bool fi = true, fr = true;
    for (int d = lane; d < r; d += 32) {
      fi &= eps_fit(p.initq[d], row[d], p.mins[d]);
      fr &= eps_fit(p.initq[d], row[r + d], p.mins[d]);
    }
    fi = __all_sync(0xffffffffu, fi);
    fr = __all_sync(0xffffffffu, fr);
    if (lane == 0) {
      out[XC_FIT_IDLE] = fi;
      out[XC_FIT_REL] = fr;
      const bool any = t.v1 > -INFINITY;
      const bool al = p.has_releasing ? (any && fi) : any;
      const int grid = p.batch_runs && p.hi0 > 1 && al;
      s_ints[1] = grid;
      out[XC_GRID] = grid;
    }
  }
  __syncthreads();
  if (s_ints[1] && tid < XS_GRID) {
    // The candidate grid on the block's winner: thread tid is j = tid + 1.
    const float* brow = p.ns + (size_t)s_ints[0] * W;
    const float jf = (float)tid;
    bool fits = true;
    for (int d = 0; d < r; ++d) {
      const float avail = __fsub_rn(brow[d], __fmul_rn(jf, p.req[d]));
      fits &= eps_fit(p.initq[d], avail, p.mins[d]);
    }
    float s = 0.0f;
    if (p.score_bound) {
      const float ac = __fsub_rn(s_best_vals[3], __fmul_rn(jf, qc));
      const float am = __fsub_rn(s_best_vals[4], __fmul_rn(jf, qm));
      s = dyn_score(p, s_best_vals[0], s_best_vals[1], ac, am, qc, qm);
      if (p.use_static) s = __fadd_rn(s, s_best_vals[2]);
    }
    out[XC_S + tid] = __float_as_int(s);
    const unsigned ballot = __ballot_sync(0xffffffffu, fits);
    if (lane == 0) out[XC_FITS + warp] = (int)ballot;
  }
  __syncthreads();
  if (tid == 0) __threadfence_system();
}

static void shard_params(const XlaShardLoop* L, int t_idx, int s_idx, int hi0, int push_row,
                         int push_t, int push_m, int push_alloc, int push_pipe, int scan,
                         XlaShardParams* q) {
  *q = L->q;
  XlaStepParams& p = q->p;
  q->push_req = L->q.p.req + (size_t)push_t * p.r;
  p.initq += (size_t)t_idx * p.r;
  p.req += (size_t)t_idx * p.r;
  p.hi0 = hi0;
  if (p.use_static) {
    p.smask += (size_t)s_idx * L->s_stride;
    p.sscore += (size_t)s_idx * L->s_stride;
  }
  q->push_row = push_row;
  q->push_m = push_m;
  q->push_alloc = push_alloc;
  q->push_pipe = push_pipe;
  q->scan = scan;
}

extern "C" int xla_shard_loop_size() { return (int)sizeof(XlaShardLoop); }

extern "C" int xla_shard_loop_begin(XlaShardLoop* L) {
  const XlaStepParams& p = L->q.p;
  L->xla_ms = 0.0;
  L->steps = 0;
  L->ev0 = L->ev1 = nullptr;
  L->out_host = nullptr;
  cudaGetLastError();
  if (p.r < 2 || p.n < 1 || L->t_rows < 1 || (p.use_static && L->s_rows < 1) ||
      L->threads < XS_MIN_THREADS || L->threads > XS_MAX_THREADS || L->threads % 32 != 0 ||
      L->q.offset < 0)
    return (int)cudaErrorInvalidValue;
  int rc = (int)cudaHostAlloc((void**)&L->out_host, XS_CAND_WORDS * sizeof(int),
                              cudaHostAllocMapped);
  if (rc == 0) rc = (int)cudaHostGetDevicePointer((void**)&L->q.p.out, L->out_host, 0);
  if (rc == 0) rc = (int)cudaEventCreate(&L->ev0);
  if (rc == 0) rc = (int)cudaEventCreate(&L->ev1);
  if (rc == 0) {
    for (int i = 0; i < XS_CAND_WORDS; ++i) L->out_host[i] = 0;
  }
  return rc;
}

extern "C" int xla_shard_loop_end(XlaShardLoop* L) {
  if (L->ev0) cudaEventDestroy(L->ev0);
  if (L->ev1) cudaEventDestroy(L->ev1);
  if (L->out_host) cudaFreeHost(L->out_host);
  L->ev0 = L->ev1 = nullptr;
  L->out_host = nullptr;
  return (int)cudaGetLastError();
}

// One shard's launch, bracketed by its events, without a wait: a step
// launches every shard, then waits on each (xla_shard_loop_wait).
extern "C" int xla_shard_loop_launch(XlaShardLoop* L, int t_idx, int s_idx, int hi0,
                                     int push_row, int push_t, int push_m, int push_alloc,
                                     int push_pipe, int scan, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaGetLastError();
  const XlaStepParams& p = L->q.p;
  if (t_idx < 0 || t_idx >= L->t_rows || (p.use_static && (s_idx < 0 || s_idx >= L->s_rows)) ||
      push_row >= p.n || (push_row >= 0 && (push_t < 0 || push_t >= L->t_rows)))
    return (int)cudaErrorInvalidValue;
  XlaShardParams q;
  shard_params(L, t_idx, s_idx, hi0, push_row, push_row >= 0 ? push_t : 0, push_m, push_alloc,
               push_pipe, scan, &q);
  cudaEventRecord(L->ev0, s);
  xla_shard_kernel<<<1, L->threads, 0, s>>>(q);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  cudaEventRecord(L->ev1, s);
  return (int)cudaGetLastError();
}

// Wait for the shard's last launch; its candidate is in L->out_host.
extern "C" int xla_shard_loop_wait(XlaShardLoop* L, void* stream) {
  int rc = (int)cudaStreamSynchronize((cudaStream_t)stream);
  if (rc != 0) return rc;
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, L->ev0, L->ev1);
  L->xla_ms += ms;
  L->steps += 1;
  return (int)cudaGetLastError();
}
