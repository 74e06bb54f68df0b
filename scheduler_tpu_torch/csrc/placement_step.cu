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
// the memory rate.  This kernel reads all r8 idle rows, as the reference
// does (about 0.67 MB), mostly from L2, where the loop keeps the ledger
// between steps.  Its operations (about 60 per node) are negligible.  So a
// launch costs its latency, a few microseconds.  The design spreads the node axis over up to 256 blocks of
// 256 threads (4 nodes a thread at nb = 16384: 16 blocks), so no single SM
// streams the whole ledger; each block reduces to one (score, index) pair,
// and the last block to finish (a ticket counter, reset by that block for
// the next launch) reduces the pairs and evaluates the capacity grid on the
// winner's column with 128 threads.
//
// Outputs: one int32[4] buffer {best, score as float bits, cap, pods}, so a
// loop reads the step back as ONE 16-byte copy.  placement_step_loop_step
// does a whole loop step in one call: push the node column the host changed
// in the last step (one 2-D copy from a pinned host mirror), launch, copy the
// four results to pinned host memory and wait for them, timing the kernel
// with two events.
//
// Bitwise parity with the float32 reference rests on: no FMA contraction
// (built with --fmad=false), IEEE division (-prec-div=true, the default),
// every expression in the reference's operation order, and lowest-index tie
// breaking in every reduction.  NaN inputs are out of contract (the static
// score rows are sanitized to finite values when they are built).
//
// Build: with the port's other kernels, by scheduler_tpu_torch/ops/cuda_build.py
// (nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define STEP_THREADS 256
#define STEP_WARPS (STEP_THREADS / 32)
#define STEP_MAX_BLOCKS STEP_THREADS   // the last block reads one pair a thread
#define NODES_PER_THREAD 4
#define CAP_GRID 128
#define BIG_I32 2147483647

// Mirrors StepParams in scheduler_tpu_torch/ops/step_kernel.py.
struct StepParams {
  const float* ns;        // [r8 + 8, n]: idle rows 0..r8-1, task count row r8
  const float* alloc;     // [r8, n]
  const uint8_t* smask;   // [n] bool (read under use_static)
  const float* sscore;    // [n]      (read under use_static)
  const uint8_t* gate;    // [n] bool
  const float* plim;      // [n]
  const float* initq;     // [r8] init request (pad rows -1)
  const float* req;       // [r8] request (pad rows 0)
  const float* mins;      // [r8] epsilon thresholds
  int* out;               // int32[4]: best, score bits, cap, pods
  float* part_v;          // [STEP_MAX_BLOCKS] per-block best score
  int* part_i;            // [STEP_MAX_BLOCKS] per-block best index
  unsigned int* ticket;   // 0 before a launch; the last block resets it
  int n;
  int r8;
  int cpu_idx;
  int mem_idx;
  int use_static;
  int enforce_pod_count;
  int with_capacity;
  float w_lr;
  float w_bal;
  float w_bp;
};

// Mirrors StepLoop in scheduler_tpu_torch/ops/step_kernel.py.
struct StepLoop {
  StepParams p;           // initq / req / smask / sscore point at task row 0
  float* ns_dev;          // == p.ns
  const float* ns_host;   // pinned host mirror of ns, same layout
  int* out_host;          // pinned int32[4]
  cudaEvent_t ev0;
  cudaEvent_t ev1;
  double k1_ms;           // sum of the kernel's event times over the steps
  long long steps;        // kernel launches made through the loop
  int push_rows;          // rows of a node column pushed after a step (r8 + 1)
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

// Block-wide (max score, lowest index); the result lands in thread 0.
__device__ void block_argmax(float& v, int& i, float* sv, int* si) {
  warp_argmax(v, i);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < STEP_WARPS ? sv[lane] : -INFINITY;
    i = lane < STEP_WARPS ? si[lane] : BIG_I32;
    warp_argmax(v, i);
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

// One node's masked score, in the reference's operation order.
__device__ float masked_score(const StepParams& p, int j) {
  const int n = p.n;
  bool feasible = true;
  for (int r = 0; r < p.r8; ++r) {
    feasible &= eps_fit(p.initq[r], p.ns[r * n + j],
                        p.mins[r]);
  }
  feasible &= p.gate[j] != 0;
  if (p.use_static) feasible &= p.smask[j] != 0;
  if (p.enforce_pod_count) feasible &= p.ns[p.r8 * n + j] < p.plim[j];

  float score = 0.0f;
  if (p.w_lr != 0.0f || p.w_bal != 0.0f || p.w_bp != 0.0f) {
    const int c = p.cpu_idx, m = p.mem_idx;
    const float ac = p.alloc[c * n + j], am = p.alloc[m * n + j];
    const float ic = p.ns[c * n + j], im = p.ns[m * n + j];
    const float rc = (ac - ic) + p.req[c];
    const float rm = (am - im) + p.req[m];
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
  if (p.use_static) score = score + p.sscore[j];
  return feasible ? score : -INFINITY;
}

__global__ void __launch_bounds__(STEP_THREADS) placement_step_kernel(StepParams p) {
  __shared__ float sv[STEP_WARPS];
  __shared__ int si[STEP_WARPS];
  __shared__ int s_last;
  __shared__ int s_best;
  __shared__ float s_score;
  __shared__ int s_cap[STEP_WARPS];

  // Each thread walks its nodes in increasing index, so `better` keeps the
  // lowest index among equal scores; an all -inf run still records its
  // first index (-inf == -inf).
  float bv = -INFINITY;
  int bi = BIG_I32;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < p.n; j += gridDim.x * blockDim.x) {
    const float v = masked_score(p, j);
    if (better(v, j, bv, bi)) {
      bv = v;
      bi = j;
    }
  }
  block_argmax(bv, bi, sv, si);
  if (threadIdx.x == 0) {
    p.part_v[blockIdx.x] = bv;
    p.part_i[blockIdx.x] = bi;
    __threadfence();
    s_last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // The last block: reduce the per-block pairs (read past L1: other blocks
  // wrote them), then the winner's capacity and pod room.
  __threadfence();
  bv = -INFINITY;
  bi = BIG_I32;
  if (threadIdx.x < gridDim.x) {
    bv = __ldcg(p.part_v + threadIdx.x);
    bi = __ldcg(p.part_i + threadIdx.x);
  }
  __syncthreads();  // sv / si are reused
  block_argmax(bv, bi, sv, si);
  if (threadIdx.x == 0) {
    s_best = bi;
    s_score = bv;
  }
  __syncthreads();
  const int best = s_best;
  int cap = 0, pods = 0;
  if (p.with_capacity) {
    int c = 0;
    if (threadIdx.x < CAP_GRID) {
      const float jf = (float)threadIdx.x;  // j - 1 for j = threadIdx.x + 1
      bool ok = true;
      for (int r = 0; r < p.r8; ++r) {
        const float avail = p.ns[r * p.n + best] - jf * p.req[r];
        ok &= eps_fit(p.initq[r], avail, p.mins[r]);
      }
      c = ok ? (int)threadIdx.x + 1 : 0;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c = max(c, __shfl_down_sync(0xffffffffu, c, off));
    if ((threadIdx.x & 31) == 0) s_cap[threadIdx.x >> 5] = c;
    __syncthreads();
    for (int w = 0; w < STEP_WARPS; ++w) cap = max(cap, s_cap[w]);
    pods = p.enforce_pod_count ? (int)(p.plim[best] - p.ns[p.r8 * p.n + best]) : CAP_GRID;
  }
  if (threadIdx.x == 0) {
    p.out[0] = best;
    p.out[1] = __float_as_int(s_score);
    p.out[2] = cap;
    p.out[3] = pods;
    *p.ticket = 0u;
  }
}

static int grid_for(int n) {
  int blocks = (n + STEP_THREADS * NODES_PER_THREAD - 1) / (STEP_THREADS * NODES_PER_THREAD);
  if (blocks < 1) blocks = 1;
  if (blocks > STEP_MAX_BLOCKS) blocks = STEP_MAX_BLOCKS;
  return blocks;
}

extern "C" int placement_step_max_blocks() { return STEP_MAX_BLOCKS; }

extern "C" int placement_step_loop_begin(StepLoop* L) {
  L->k1_ms = 0.0;
  L->steps = 0;
  int rc = (int)cudaEventCreate(&L->ev0);
  if (rc == 0) rc = (int)cudaEventCreate(&L->ev1);
  return rc;
}

extern "C" int placement_step_loop_end(StepLoop* L) {
  cudaEventDestroy(L->ev0);
  cudaEventDestroy(L->ev1);
  L->ev0 = L->ev1 = nullptr;
  return (int)cudaGetLastError();
}

// One loop step for task row `t_idx`: push node column `push_col` of the
// host mirror (-1: none), launch, read the four results back and wait.
extern "C" int placement_step_loop_step(StepLoop* L, int t_idx, int push_col, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaGetLastError();  // clear a stale error so the return value is this step's
  const int n = L->p.n;
  if (push_col >= 0) {
    const size_t pitch = (size_t)n * sizeof(float);
    int rc = (int)cudaMemcpy2DAsync(L->ns_dev + push_col, pitch, L->ns_host + push_col, pitch,
                                    sizeof(float), L->push_rows, cudaMemcpyHostToDevice, s);
    if (rc != 0) return rc;
  }
  StepParams p = L->p;
  p.initq += (size_t)t_idx * L->task_stride;
  p.req += (size_t)t_idx * L->task_stride;
  if (p.use_static) {
    p.smask += (size_t)t_idx * n;
    p.sscore += (size_t)t_idx * n;
  }
  cudaEventRecord(L->ev0, s);
  placement_step_kernel<<<grid_for(n), STEP_THREADS, 0, s>>>(p);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  cudaEventRecord(L->ev1, s);
  rc = (int)cudaMemcpyAsync(L->out_host, p.out, 4 * sizeof(int), cudaMemcpyDeviceToHost, s);
  if (rc != 0) return rc;
  rc = (int)cudaStreamSynchronize(s);
  if (rc != 0) return rc;
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, L->ev0, L->ev1);
  L->k1_ms += ms;
  L->steps += 1;
  return (int)cudaGetLastError();
}
