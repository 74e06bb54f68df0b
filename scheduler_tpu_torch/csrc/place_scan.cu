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
// node index holding it (all -inf: node 0, nothing feasible).  Then one
// thread allocates on idle where the winner's idle fits (idle -= req), else
// pipelines onto releasing (releasing -= req), adds one to its task count,
// and stops the scan once the allocations reach ready_deficit (the JobReady
// break, checked after every placement).  The first task with no feasible
// node is failed and stops the scan.  Outputs: out int32 [3, t] (chosen
// node or -1, pipelined, failed); idle, releasing and task_count are
// updated in place.
//
// What bounds it on this card: latency.  The bytes are the node state once
// (at 10,000 nodes and 2 dims about 0.3 MB) and one mask row a task, well
// under a microsecond of the memory rate for a pop of 100 tasks; but every
// task depends on the placement before it, so the tasks run one after the
// other and each costs a pass over the nodes, two block reductions and a
// barrier.  The design keeps that pass short and everything on chip:
//
// * One block of 1,024 threads for the whole pop (one launch, no host round
//   trip per task).  Thread i takes nodes i, i + 1024, ...: neighbouring
//   threads read neighbouring nodes, and the node state stays in L1 / L2
//   between tasks.  Each thread keeps a running (score, lowest index) pair;
//   the block reduces the pairs with warp shuffles and one warp, and the
//   any-feasible flag with __syncthreads_or.
// * Thread 0 applies the placement (it re-reads the winner's idle and
//   releasing rows) and decides whether the scan stops; a barrier publishes
//   the written node to every thread for the next task.  The node state is
//   read through plain (coherent) loads, never the read-only path, since it
//   changes inside the launch.
// * The task's rows are read by index from the session's [T, R] request
//   and [T, N] static tensors: a pop gathers and copies nothing.
//
// Bitwise parity with the float32 reference rests on: no FMA contraction
// (built with --fmad=false), IEEE division (the default -prec-div=true),
// every expression in the JAX function's operation order (NOT
// placement_step.cu's node_score, which adds binpack first), and
// lowest-index tie breaking in every reduction.  NaN inputs are out of
// contract (static score rows are sanitized to finite values when built).
//
// Build: with the port's other kernels, by scheduler_tpu_torch/ops/cuda_build.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SCAN_THREADS 1024
#define SCAN_WARPS (SCAN_THREADS / 32)
#define SCAN_MAX_R 32
#define BIG_I32 2147483647

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
};

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
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
  if (a.w_lr == 0.0f && a.w_bal == 0.0f && a.w_bp == 0.0f) return score;
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

__global__ void __launch_bounds__(SCAN_THREADS, 1) place_scan_kernel(const __grid_constant__ ScanArgs a) {
  __shared__ float s_init[SCAN_MAX_R];
  __shared__ float s_req[SCAN_MAX_R];
  __shared__ float s_mins[SCAN_MAX_R];
  __shared__ float warp_v[SCAN_WARPS];
  __shared__ int warp_i[SCAN_WARPS];
  __shared__ int s_stop;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r_n = a.r, t = a.t;
  for (int k = tid; k < t; k += SCAN_THREADS) {
    a.out[k] = -1;
    a.out[t + k] = 0;
    a.out[2 * t + k] = 0;
  }
  if (tid < r_n) s_mins[tid] = a.mins[tid];
  if (tid == 0) s_stop = 0;
  int n_alloc = 0;  // thread 0's count of allocations
  __syncthreads();

  for (int k = 0; k < t; ++k) {
    const long long row = a.rows[k];
    if (tid < r_n) {
      s_init[tid] = a.initq[row * r_n + tid];
      s_req[tid] = a.req[row * r_n + tid];
    }
    __syncthreads();
    const uint8_t* mrow = a.smask + row * a.stride;
    const float* srow = a.sscore != nullptr ? a.sscore + row * a.stride : nullptr;
    const float qc = s_req[0], qm = s_req[1];

    // Each thread walks its nodes in increasing order, so `better` keeps the
    // lowest index among equal scores; an all -inf walk keeps its first.
    float bv = -INFINITY;
    int bi = BIG_I32;
    int any = 0;
    for (int j = tid; j < a.n_active; j += SCAN_THREADS) {
      const float* irow = a.idle + (size_t)j * r_n;
      const float* rrow = a.rel + (size_t)j * r_n;
      bool fi = true, fr = true;
      for (int d = 0; d < r_n; ++d) {
        fi = fi & eps_fit(s_init[d], irow[d], s_mins[d]);
        fr = fr & eps_fit(s_init[d], rrow[d], s_mins[d]);
      }
      bool feasible = (fi | fr) & (mrow[j] != 0);
      if (a.enforce_pod_count) feasible = feasible & (a.tc[j] < a.plim[j]);
      float v = -INFINITY;
      if (feasible) {
        any = 1;
        const float* arow = a.alloc + (size_t)j * r_n;
        const float dyn = dynamic_score(a, arow[0], arow[1], irow[0], irow[1], qc, qm);
        v = (srow != nullptr ? srow[j] : 0.0f) + dyn;
      }
      if (better(v, j, bv, bi)) {
        bv = v;
        bi = j;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    any = __syncthreads_or(any);
    if (warp == 0) {
      float v = warp_v[lane];
      int i = warp_i[lane];
      warp_argmax(v, i);
      if (lane == 0) {
        if (!any) {
          a.out[2 * t + k] = 1;  // failed: the scan stops
          s_stop = 1;
        } else {
          const int b = i;
          float* irow = a.idle + (size_t)b * r_n;
          float* rrow = a.rel + (size_t)b * r_n;
          bool fi = true, fr = true;
          for (int d = 0; d < r_n; ++d) {
            fi = fi & eps_fit(s_init[d], irow[d], s_mins[d]);
            fr = fr & eps_fit(s_init[d], rrow[d], s_mins[d]);
          }
          if (fi) {
            for (int d = 0; d < r_n; ++d) irow[d] = irow[d] - s_req[d];
            n_alloc += 1;
          } else if (fr) {
            for (int d = 0; d < r_n; ++d) rrow[d] = rrow[d] - s_req[d];
          }
          if (fi | fr) {
            a.tc[b] += 1;
            a.out[k] = b;
            a.out[t + k] = fi ? 0 : 1;
            if (n_alloc >= a.ready_deficit) s_stop = 1;
          }
        }
      }
    }
    __syncthreads();
    if (s_stop) break;  // the same in every thread
  }
}

extern "C" int place_scan_launch(float* idle, float* rel, int* tc, const float* alloc,
                                 const int* plim, const float* mins, const float* initq,
                                 const float* req, const uint8_t* smask, const float* sscore,
                                 const int* rows, int* out,
                                 long long stride, int t, int n_active, int r, int ready_deficit,
                                 int enforce_pod_count, float w_lr, float w_bal, float w_bp,
                                 void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (r < 2 || r > SCAN_MAX_R || t < 0 || n_active < 0) return (int)cudaErrorInvalidValue;
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
  place_scan_kernel<<<1, SCAN_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
