// placement_step (K1): one micro-step's selection of the fused_allocate loop.
//
// Replaces scheduler_tpu/ops/pallas_kernels.py:117 make_placement_step (a
// Pallas TPU kernel).  For one task over every node, in float32: the epsilon
// fit over all r8 request rows (pad rows carry initq = -1 and always fit),
// ANDed with the node gate, the static mask row (use_static) and the pod-count
// gate (enforce_pod_count); the score 0 + binpack + least-requested + balanced
// terms (a term whose weight is 0 is skipped, not added as 0 * x) + the static
// score row; the masked max and the LOWEST node index holding it.  When
// nothing is feasible every node scores -inf, so best = 0 and score = -inf.
// With with_capacity, also the winner's capacity on the 128-candidate grid
// (the largest j in 1..128 whose avail = idle - float(j - 1) * req still
// epsilon-fits every row; a max over all j, as in the reference) and its
// pod room (int(plim - task_count) under the pod-count gate, else 128).
// The plain PyTorch version is
// scheduler_tpu_torch/ops/step_kernel.py::placement_step_reference; the two
// must agree bit for bit on all four outputs.
//
// What bounds it on this card: bytes.  At nb = 16384 nodes, r_dim = 2,
// r8 = 8 and binpack only, the function needs the two real idle rows, the
// cpu and memory rows of allocatable and the gate (and the task count, pod
// limit and static rows where they are on): about 0.28 MB, under 0.1 us at
// the memory rate.  The kernel reads all r8 idle rows, as the reference
// does (about 0.67 MB), mostly from L2, where the loop keeps the ledger
// between steps.  Its operations (about 60 per node) are negligible.  So a
// step costs latency: the launch, the rounds of loads, the reductions and
// the way the result reaches the host.  The design keeps each to one:
//
// * One thread-block cluster of 8 CTAs x 512 threads (the portable size)
//   for every node count the loop gives it (nb <= 65,536).  CTA `rank`
//   takes an equal contiguous share of the 4-node groups; its threads
//   stride over them, reading each row of a group with one float4 load
//   (scalar loads when n is not a multiple of 4).  A thread issues every
//   load of a group (8 idle rows, gate, static rows, task count, pod limit,
//   allocatable) before it uses any, so a group costs one round trip to
//   L2; at nb 16,384 that is one group a thread.  Each thread keeps a
//   running (score, lowest index) pair; each CTA reduces its pairs (warp
//   shuffles, then one warp) and writes its pair into CTA rank 0's shared
//   memory (distributed shared memory); after one cluster barrier, rank 0
//   reduces the eight pairs with the same rule, reads the winner's column
//   once and evaluates the capacity grid and pod room.  No per-block
//   scratch in global memory, no ticket, no fence between blocks, no
//   atomic.  With 8 SMs the ledger streams through 8 SMs' share of L2
//   bandwidth: past nb 16,384 a thread takes several groups in turn.
// * The task's rows (initq, req, mins) and the node column that the host
//   changed in the last step (push_col and its r8 + 1 floats: idle rows and
//   task count) travel in the launch parameters.  A thread scoring node
//   push_col, and rank 0 when that node wins, use the pushed values; the
//   thread that owns the column also writes them into ns, so the next step
//   and the loop's checks see the state the loop expects.  No copy to the
//   card before a launch.
// * The four results {best, score as float bits, cap, pods} are written by
//   rank 0 into mapped pinned host memory, with a system-scope fence.  No
//   copy back.  A loop step (placement_step_loop_step) is one launch and a
//   wait, bracketed by two events that time it.
//
// Bitwise parity with the float32 reference rests on: no FMA contraction
// (built with --fmad=false), IEEE division (-prec-div=true, the default),
// every expression in the reference's operation order (node_score), and
// lowest-index tie breaking in every reduction.  NaN inputs are out of
// contract (the static score rows are sanitized to finite values when they
// are built).
//
// Build: with the port's other kernels, by scheduler_tpu_torch/ops/cuda_build.py
// (nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define STEP_CTAS 8        // one cluster, portable size
#define STEP_THREADS 512
#define STEP_WARPS (STEP_THREADS / 32)
#define STEP_MAX_R8 16
#define CAP_GRID 128
#define BIG_I32 2147483647

// Mirrors StepParams in scheduler_tpu_torch/ops/step_kernel.py.
struct StepParams {
  float* ns;              // [r8 + 8, n]: idle rows 0..r8-1, task count row r8
  const float* alloc;     // [r8, n]
  const uint8_t* smask;   // [n] bool (read under use_static)
  const float* sscore;    // [n]      (read under use_static)
  const uint8_t* gate;    // [n] bool
  const float* plim;      // [n]
  int* out;               // int32[4] in mapped host memory: best, score bits, cap, pods
  int n;
  int r8;
  int cpu_idx;
  int mem_idx;
  int use_static;
  int enforce_pod_count;
  int with_capacity;
  int push_col;           // node column the host changed (-1: none)
  int vec;                // float4 / uchar4 loads: n % 4 == 0 and every row 16-byte aligned
  float w_lr;
  float w_bal;
  float w_bp;
  float initq[STEP_MAX_R8];      // the task's init request (pad rows -1)
  float req[STEP_MAX_R8];        // the task's request (pad rows 0)
  float mins[STEP_MAX_R8];       // epsilon thresholds
  float push[STEP_MAX_R8 + 1];   // column push_col: idle rows, then task count
};

// Mirrors StepLoop in scheduler_tpu_torch/ops/step_kernel.py.
struct StepLoop {
  StepParams p;           // smask / sscore point at task row 0
  const float* ns_host;   // the host's node state, same layout as ns
  const float* initq;     // [T, task_stride] host rows
  const float* req;       // [T, task_stride] host rows
  int* out_host;          // mapped pinned int32[4]
  cudaEvent_t ev0;
  cudaEvent_t ev1;
  double k1_ms;           // sum of the launches' event times over the steps
  long long steps;        // kernel launches made through the loop step
  int task_stride;        // floats between two tasks' request rows (r8)
};

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, v, off);
    int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// jnp.clip(x, 0, 1) = minimum(maximum(x, 0), 1).
__device__ __forceinline__ float clip01(float x) {
  float y = x < 0.0f ? 0.0f : x;
  return y > 1.0f ? 1.0f : y;
}

__device__ __forceinline__ bool eps_fit(float initq, float avail, float mins) {
  return (initq < avail) | (fabsf(avail - initq) < mins);
}

// One node's masked score from its loaded values, in the reference's
// operation order.
__device__ __forceinline__ float node_score(const StepParams& p, bool feasible, float ac, float am,
                                            float ic, float im, float ss) {
  float score = 0.0f;
  if (p.w_lr != 0.0f || p.w_bal != 0.0f || p.w_bp != 0.0f) {
    const float rc = (ac - ic) + p.req[p.cpu_idx];
    const float rm = (am - im) + p.req[p.mem_idx];
    const float sc = ac > 0.0f ? ac : 1.0f;
    const float sm = am > 0.0f ? am : 1.0f;
    if (p.w_bp != 0.0f) {
      const float fc = clip01(rc / sc), fm = clip01(rm / sm);
      score = score + p.w_bp * (((fc + fm) / 2.0f) * 10.0f);
    }
    if (p.w_lr != 0.0f) {
      const float lc = clip01((ac - rc) / sc), lm = clip01((am - rm) / sm);
      score = score + p.w_lr * (((lc + lm) / 2.0f) * 10.0f);
    }
    if (p.w_bal != 0.0f) {
      const float bc = clip01(rc / sc), bm = clip01(rm / sm);
      const float diff = fabsf(bc - bm);
      score = score + p.w_bal * ((1.0f - diff) * 10.0f);
    }
  }
  if (p.use_static) score = score + ss;
  return feasible ? score : -INFINITY;
}

// Nodes j0..j0+3 of a row: one float4 (uchar4) load when vec (every row
// and group aligned), else up to four scalar loads.
__device__ __forceinline__ void load4(const float* row, int j0, int n, bool vec, float v[4]) {
  if (vec) {
    const float4 x = *reinterpret_cast<const float4*>(row + j0);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = j0 + q < n ? row[j0 + q] : 0.0f;
  }
}

__device__ __forceinline__ void load4(const uint8_t* row, int j0, int n, bool vec, bool v[4]) {
  if (vec) {
    const uchar4 x = *reinterpret_cast<const uchar4*>(row + j0);
    v[0] = x.x != 0; v[1] = x.y != 0; v[2] = x.z != 0; v[3] = x.w != 0;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = j0 + q < n && row[j0 + q] != 0;
  }
}

__global__ void __cluster_dims__(STEP_CTAS, 1, 1) __launch_bounds__(STEP_THREADS)
    placement_step_kernel(const __grid_constant__ StepParams p) {
  __shared__ float warp_v[STEP_WARPS];
  __shared__ int warp_i[STEP_WARPS];
  __shared__ float cta_v[STEP_CTAS];  // read in rank 0 only
  __shared__ int cta_i[STEP_CTAS];
  __shared__ float s_col[STEP_MAX_R8 + 2];  // the winner's idle rows, task count, pod limit
  __shared__ int s_best;
  __shared__ float s_score;
  __shared__ int s_cap[CAP_GRID / 32];

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = p.n, r8 = p.r8;
  const bool vec = p.vec != 0;
  const int groups = (n + 3) >> 2;
  const int push = p.push_col;

  // Each thread walks its groups in increasing node order, so `better`
  // keeps the lowest index among equal scores; an all -inf run still
  // records its first index (-inf == -inf).
  float bv = -INFINITY;
  int bi = BIG_I32;
  // CTA `rank` takes an equal contiguous share of the 4-node groups, so
  // every CTA's SM streams its part of the ledger at any node count.
  const int share = (groups + STEP_CTAS - 1) / STEP_CTAS;
  const int g_end = min(groups, (int)(rank + 1) * share);
  for (int grp = (int)rank * share + tid; grp < g_end; grp += STEP_THREADS) {
    const int j0 = 4 * grp;
    const int pq = push - j0;  // lane of the pushed node in this group, if in [0, 4)
    // Every load of the group is issued before any of them is used, so the
    // group costs one round trip to memory (two with r8 = 16).
    float x[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) load4(p.ns + (size_t)r * n, j0, n, vec, x[r]);
    bool ok[4], sm[4] = {true, true, true, true};
    float ss[4] = {0.0f, 0.0f, 0.0f, 0.0f}, tc[4] = {0.0f, 0.0f, 0.0f, 0.0f},
          pl[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ac[4] = {0.0f, 0.0f, 0.0f, 0.0f},
          am[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    load4(p.gate, j0, n, vec, ok);
    if (p.use_static) {
      load4(p.smask, j0, n, vec, sm);
      load4(p.sscore, j0, n, vec, ss);
    }
    if (p.enforce_pod_count) {
      load4(p.ns + (size_t)r8 * n, j0, n, vec, tc);
      load4(p.plim, j0, n, vec, pl);
    }
    if (p.w_lr != 0.0f || p.w_bal != 0.0f || p.w_bp != 0.0f) {
      load4(p.alloc + (size_t)p.cpu_idx * n, j0, n, vec, ac);
      load4(p.alloc + (size_t)p.mem_idx * n, j0, n, vec, am);
    }
    // The epsilon fit over the r8 rows, eight at a time (r8 is 8 or 16).
    float ic[4] = {0.0f, 0.0f, 0.0f, 0.0f}, im[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r0 = 0; r0 < r8; r0 += 8) {
      if (r0 > 0) {
#pragma unroll
        for (int r = 0; r < 8; ++r) load4(p.ns + (size_t)(r0 + r) * n, j0, n, vec, x[r]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = r0 + r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q == pq) x[r][q] = p.push[row];
          ok[q] &= eps_fit(p.initq[row], x[r][q], p.mins[row]);
          if (row == p.cpu_idx) ic[q] = x[r][q];
          if (row == p.mem_idx) im[q] = x[r][q];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q == pq) tc[q] = p.push[r8];
      ok[q] &= sm[q];
      if (p.enforce_pod_count) ok[q] &= tc[q] < pl[q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q;
      if (j >= n) break;
      const float v = node_score(p, ok[q], ac[q], am[q], ic[q], im[q], ss[q]);
      if (better(v, j, bv, bi)) {
        bv = v;
        bi = j;
      }
    }
    if (pq >= 0 && pq < 4) {
      // This thread owns the pushed column: the card's copy catches up.
      for (int r = 0; r <= r8; ++r) p.ns[(size_t)r * n + push] = p.push[r];
    }
  }

  // CTA: warps, then one warp; its pair goes to rank 0's shared memory.
  warp_argmax(bv, bi);
  if (lane == 0) {
    warp_v[warp] = bv;
    warp_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < STEP_WARPS ? warp_v[lane] : -INFINITY;
    bi = lane < STEP_WARPS ? warp_i[lane] : BIG_I32;
    warp_argmax(bv, bi);
    if (lane == 0) {
      *cluster.map_shared_rank(&cta_v[rank], 0) = bv;
      *cluster.map_shared_rank(&cta_i[rank], 0) = bi;
    }
  }
  cluster.sync();  // release / acquire: the pairs are in rank 0
  if (rank != 0) return;

  if (warp == 0) {
    bv = lane < STEP_CTAS ? cta_v[lane] : -INFINITY;
    bi = lane < STEP_CTAS ? cta_i[lane] : BIG_I32;
    warp_argmax(bv, bi);
    const int best = __shfl_sync(0xffffffffu, bi, 0);
    if (lane == 0) {
      s_best = best;
      s_score = bv;
    }
    if (lane <= r8) s_col[lane] = best == push ? p.push[lane] : p.ns[(size_t)lane * n + best];
    if (lane == r8 + 1) s_col[lane] = p.plim[best];
  }
  if (tid >= CAP_GRID) return;
  asm volatile("bar.sync 1, %0;" ::"n"(CAP_GRID) : "memory");  // warps 0..3
  const int best = s_best;
  int cap = 0, pods = 0;
  if (p.with_capacity) {
    const float jf = (float)tid;  // j - 1 for j = tid + 1
    bool fits = true;
    for (int r = 0; r < r8; ++r) {
      const float avail = s_col[r] - jf * p.req[r];
      fits &= eps_fit(p.initq[r], avail, p.mins[r]);
    }
    int c = fits ? tid + 1 : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c = max(c, __shfl_down_sync(0xffffffffu, c, off));
    if (lane == 0) s_cap[warp] = c;
    asm volatile("bar.sync 1, %0;" ::"n"(CAP_GRID) : "memory");
    for (int w = 0; w < CAP_GRID / 32; ++w) cap = max(cap, s_cap[w]);
    pods = p.enforce_pod_count ? (int)(s_col[r8 + 1] - s_col[r8]) : CAP_GRID;
  }
  if (tid == 0) {
    *reinterpret_cast<int4*>(p.out) = make_int4(best, __float_as_int(s_score), cap, pods);
    __threadfence_system();
  }
}

// The step's launch parameters for task row t_idx after the host changed
// node column push_col (-1: none).
static void step_params(const StepLoop* L, int t_idx, int push_col, StepParams* p) {
  *p = L->p;
  const int n = p->n, r8 = p->r8;
  const float* iq = L->initq + (size_t)t_idx * L->task_stride;
  const float* rq = L->req + (size_t)t_idx * L->task_stride;
  for (int r = 0; r < r8; ++r) {
    p->initq[r] = iq[r];
    p->req[r] = rq[r];
  }
  p->push_col = push_col;
  if (push_col >= 0) {
    for (int r = 0; r <= r8; ++r) p->push[r] = L->ns_host[(size_t)r * n + push_col];
  }
  if (p->use_static) {
    p->smask += (size_t)t_idx * n;
    p->sscore += (size_t)t_idx * n;
  }
}

static int launch(const StepParams& p, cudaStream_t s) {
  placement_step_kernel<<<STEP_CTAS, STEP_THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int placement_step_max_r8() { return STEP_MAX_R8; }

// Events, and the mapped pinned result (L->out_host, its device address in
// L->p.out).
extern "C" int placement_step_loop_begin(StepLoop* L) {
  StepParams& p = L->p;
  const uintptr_t floats = (uintptr_t)p.ns | (uintptr_t)p.alloc | (uintptr_t)p.sscore |
                           (uintptr_t)p.plim;
  const uintptr_t bytes = (uintptr_t)p.gate | (uintptr_t)p.smask;
  p.vec = p.n % 4 == 0 && floats % 16 == 0 && bytes % 4 == 0;
  L->k1_ms = 0.0;
  L->steps = 0;
  L->ev0 = L->ev1 = nullptr;
  L->out_host = nullptr;
  int rc = (int)cudaHostAlloc((void**)&L->out_host, 4 * sizeof(int), cudaHostAllocMapped);
  if (rc == 0) rc = (int)cudaHostGetDevicePointer((void**)&L->p.out, L->out_host, 0);
  if (rc == 0) rc = (int)cudaEventCreate(&L->ev0);
  if (rc == 0) rc = (int)cudaEventCreate(&L->ev1);
  if (rc == 0) {
    for (int i = 0; i < 4; ++i) L->out_host[i] = 0;
  }
  return rc;
}

extern "C" int placement_step_loop_end(StepLoop* L) {
  if (L->ev0) cudaEventDestroy(L->ev0);
  if (L->ev1) cudaEventDestroy(L->ev1);
  if (L->out_host) cudaFreeHost(L->out_host);
  L->ev0 = L->ev1 = nullptr;
  L->out_host = nullptr;
  return (int)cudaGetLastError();
}

// One loop step for task row t_idx after the host changed node column
// push_col (-1: none): launch and wait; the results are in L->out_host.
extern "C" int placement_step_loop_step(StepLoop* L, int t_idx, int push_col, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaGetLastError();  // clear a stale error so the return value is this step's
  StepParams p;
  step_params(L, t_idx, push_col, &p);
  cudaEventRecord(L->ev0, s);
  int rc = launch(p, s);
  if (rc != 0) return rc;
  cudaEventRecord(L->ev1, s);
  rc = (int)cudaStreamSynchronize(s);
  if (rc != 0) return rc;
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, L->ev0, L->ev1);
  L->k1_ms += ms;
  L->steps += 1;
  return (int)cudaGetLastError();
}

// `count` launches for task row t_idx queued back to back, no push and no
// wait (for timing the kernel apart from the round trip).
// A loop step's launch, bracketed by the loop's events, without its wait:
// a step over a node mesh launches every shard's loop, then waits on each
// (placement_step_loop_wait), so the shards' launches queue back to back.
extern "C" int placement_step_loop_launch(StepLoop* L, int t_idx, int push_col, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaGetLastError();
  StepParams p;
  step_params(L, t_idx, push_col, &p);
  cudaEventRecord(L->ev0, s);
  int rc = launch(p, s);
  if (rc != 0) return rc;
  cudaEventRecord(L->ev1, s);
  return (int)cudaGetLastError();
}

// Wait for the loop's last launch; its four results are in L->out_host.
extern "C" int placement_step_loop_wait(StepLoop* L, void* stream) {
  int rc = (int)cudaStreamSynchronize((cudaStream_t)stream);
  if (rc != 0) return rc;
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, L->ev0, L->ev1);
  L->k1_ms += ms;
  L->steps += 1;
  return (int)cudaGetLastError();
}

extern "C" int placement_step_loop_queue(StepLoop* L, int t_idx, int count, void* stream) {
  cudaGetLastError();
  StepParams p;
  step_params(L, t_idx, -1, &p);
  for (int k = 0; k < count; ++k) {
    const int rc = launch(p, (cudaStream_t)stream);
    if (rc != 0) return rc;
  }
  return 0;
}
