// qfair_solve: proportion's deserved water-fill in one kernel launch.
//
// Replaces scheduler_tpu/ops/qfair.py:93 _solve_core (called through
// qfair_solve, :199): in the JAX package an XLA program of fixed round count
// under 64-bit jax, not a Pallas kernel.  As PyTorch operations its fold
// would be some 10^5 launches at 100 queues (Q + 4 rounds of Q dependent
// steps), so the port gives it a kernel.  The plain PyTorch version of the
// same function is scheduler_tpu_torch/ops/qfair.py::qfair_solve_reference;
// the two must agree bit for bit.
//
// What it computes, in float64, round by round: the unmet-weight sum
// folded in queue order; for each queue in order that is not met, its
// grant remaining * (w / tw) + 0 added to its deserved row, the request cap
// of ResourceVec.less (strict on cpu and memory, then the scalar dims where
// the request names them, or the scalar-map presence flags), the min cap,
// the increased and decreased folds; then the pool (remaining - increased)
// + decreased, drained when every dim is under its epsilon.  Outputs:
// deserved [Q, R], met [Q], qf_raw = {rounds budget, converged round or -1}.
//
// What bounds it on this card: latency.  The work is a few operations per
// dim per queue per round.  Inside a round the queues do not depend on
// each other: a queue's grant, cap, scalar flag and delta read only the
// round's pool, tw and scalar flag and the queue's own row.  Only three
// folds must run in queue order for the float64 bits: the unmet-weight sum
// and the increased and decreased sums.  So one CTA of up to 1,024 threads
// runs a round in three parallel steps:
//
//   1. every unmet queue's grant, cap and delta at once, a warp a queue
//      (lanes over dims, the cap tests as warp votes), its deltas into a
//      [unmet queues, R] tile: shared memory where it fits (the on-chip
//      arm), else a global scratch tile the wrapper allocates;
//   2. the increased and decreased folds, one thread a dim and a fold, each
//      walking the tile in queue order; beside them, on a warp of its own,
//      one thread folds the next round's unmet weights in queue order and
//      lists the unmet queues (met is final after step 1);
//   3. the pool update, its drained test and the pool's scalar flag as
//      block votes.
//
// The serial chains left are the two folds of a round, each of (unmet)
// queue-count dependent float64 adds: that chain floor, rounds x 2 x Q x
// the add's latency, sits beside the bound in PERF.md.  The rounds after
// the fixed point are no-ops in the reference, so the kernel stops there.
//
// Bitwise parity with the reference rests on IEEE double arithmetic with no
// contraction (built with --fmad=false; every operation below is also
// written with its round-to-nearest intrinsic), the reference's operation
// order, and the folds in queue order.
//
// Build: with the port's other kernels, by scheduler_tpu_torch/ops/cuda_build.py.

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define QF_MAX_THREADS 1024
#define QF_MIN_THREADS 64

struct QfairArgs {
  const double* w;        // [Q]
  const double* req;      // [Q, R]
  const double* total;    // [R]
  const uint8_t* req_hs;  // [Q]
  const double* mins;     // [R]
  uint8_t* d_hs;          // [Q] scratch: each deserved row's scalar-map presence
  double* d;              // [Q, R] out: deserved
  uint8_t* met;           // [Q] out
  int* qf_raw;            // [2] out
  double* delta_g;        // [Q, R] scratch of the global arm (null on chip)
  int* list_g;            // [Q] scratch of the global arm (null on chip)
  int total_hs;
  int q_n;
  int r_n;
  int iters;
  int on_chip;
};

// The unmet-weight sum of the coming round, folded in queue order, and the
// unmet queues listed in order (one thread).
__device__ __forceinline__ void weight_fold(const QfairArgs& a, int* list, double* tw_out,
                                            int* u_out) {
  double tw = 0.0;
  int u = 0;
  for (int q = 0; q < a.q_n; ++q) {
    const bool m = a.met[q] != 0;
    tw = __dadd_rn(tw, m ? 0.0 : a.w[q]);
    if (!m) list[u++] = q;
  }
  *tw_out = tw;
  *u_out = u;
}

__global__ void __launch_bounds__(QF_MAX_THREADS, 1) qfair_solve_kernel(const QfairArgs a) {
  extern __shared__ double sh[];
  __shared__ double s_tw;
  __shared__ int s_u;
  const int R = a.r_n, Q = a.q_n;
  double* rem = sh;          // [R] the pool
  double* inc = sh + R;      // [R] this round's increased fold
  double* dec = sh + 2 * R;  // [R] this round's decreased fold
  double* delta = a.on_chip ? sh + 3 * R : a.delta_g;
  int* list = a.on_chip ? reinterpret_cast<int*>(sh + 3 * R + (size_t)Q * R) : a.list_g;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, warps = T / 32;
  const int folders = T - 32;     // threads of the dim folds: every warp but the last
  const int weigher = T - 32;     // lane 0 of the last warp folds the weights
  for (int r = tid; r < R; r += T) rem[r] = a.total[r];
  for (long x = tid; x < (long)Q * R; x += T) a.d[x] = 0.0;
  for (int q = tid; q < Q; q += T) {
    a.met[q] = 0;
    a.d_hs[q] = 0;
  }
  __syncthreads();
  if (tid == weigher) weight_fold(a, list, &s_tw, &s_u);
  __syncthreads();
  bool rem_hs = a.total_hs != 0;
  bool done = false;
  int rounds = 0;
  for (int it = 0; it < a.iters && !done; ++it) {
    const double tw = s_tw;
    const int U = s_u;
    if (tw == 0.0) {
      done = true;  // nothing left to share: the round changes nothing
      break;
    }
    // Step 1: each unmet queue's grant, cap and delta, a warp a queue.
    for (int k = warp; k < U; k += warps) {
      const int q = list[k];
      const double ratio = __ddiv_rn(a.w[q], tw);
      double* row = a.d + (size_t)q * R;
      const double* rq = a.req + (size_t)q * R;
      // The request cap: ResourceVec.less(request, new deserved).
      bool strict = true, scalar_ok = true, any_cap = false;
      for (int r = lane; r < R; r += 32) {
        const double nd = __dadd_rn(row[r], __dadd_rn(__dmul_rn(rem[r], ratio), 0.0));
        const double x = rq[r];
        if (r < 2) {
          strict = strict && (x < nd);
        } else {
          if (x != 0.0) scalar_ok = scalar_ok && (x < nd);
          if (fmin(nd, x) != 0.0) any_cap = true;
        }
      }
      strict = __all_sync(FULL_MASK, strict);
      scalar_ok = __all_sync(FULL_MASK, scalar_ok);
      any_cap = __any_sync(FULL_MASK, any_cap);
      const bool new_hs = a.d_hs[q] != 0 || rem_hs;
      const bool capped = (a.req_hs[q] ? scalar_ok : new_hs) && strict;
      double* dq = delta + (size_t)k * R;
      for (int r = lane; r < R; r += 32) {
        const double old = row[r];
        const double nd = __dadd_rn(old, __dadd_rn(__dmul_rn(rem[r], ratio), 0.0));
        const double fin = capped ? fmin(nd, rq[r]) : nd;
        dq[r] = __dsub_rn(fin, old);
        row[r] = fin;
      }
      if (lane == 0) {
        a.d_hs[q] = capped ? any_cap : new_hs;
        if (capped) a.met[q] = 1;
      }
    }
    __syncthreads();
    // Step 2: the increased and decreased folds in queue order, a thread a
    // dim and a fold; the next round's weight fold beside them.
    if (tid < folders) {
      for (int x = tid; x < 2 * R; x += folders) {
        const bool up = x < R;
        const int r = up ? x : x - R;
        double acc = 0.0;
        for (int k = 0; k < U; ++k) {
          const double dv = delta[(size_t)k * R + r];
          acc = __dadd_rn(acc, up ? (dv > 0.0 ? dv : 0.0) : (dv < 0.0 ? -dv : 0.0));
        }
        (up ? inc : dec)[r] = acc;
      }
    } else if (tid == weigher) {
      weight_fold(a, list, &s_tw, &s_u);
    }
    __syncthreads();
    // Step 3: the pool after the round, and whether it is drained.
    bool empty = true, dec_scalar = false;
    for (int r = tid; r < R; r += T) {
      const double r2 = __dadd_rn(__dsub_rn(rem[r], inc[r]), dec[r]);
      rem[r] = r2;
      empty = empty && (r2 < a.mins[r]);
      if (r >= 2 && dec[r] != 0.0) dec_scalar = true;
    }
    empty = __syncthreads_and(empty);
    const bool any_dec_scalar = __syncthreads_or(dec_scalar) != 0;  // every thread votes
    rem_hs = rem_hs || any_dec_scalar;
    rounds += 1;
    if (empty) done = true;
  }
  if (tid == 0) {
    a.qf_raw[0] = a.iters;
    a.qf_raw[1] = done ? rounds : -1;
  }
}

// threads: a multiple of 32 in QF_MIN_THREADS..QF_MAX_THREADS; on_chip: the
// delta tile and the queue list in shared memory (smem_bytes), else in the
// global scratch delta_g [Q, R] and list_g [Q].
extern "C" int qfair_solve_launch(const double* w, const double* req, const double* total,
                                  const uint8_t* req_hs, const double* mins, uint8_t* d_hs,
                                  int total_hs, int q_n, int r_n, int iters, double* d,
                                  uint8_t* met, int* qf_raw, double* delta_g, int* list_g,
                                  int threads, int on_chip, int smem_bytes, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (r_n < 2 || q_n < 0 || iters < 0) return (int)cudaErrorInvalidValue;
  if (threads < QF_MIN_THREADS || threads > QF_MAX_THREADS || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const long long tile = 8LL * q_n * r_n + 4LL * q_n;
  const long long need = 24LL * r_n + (on_chip ? tile : 0);
  if (smem_bytes < need) return (int)cudaErrorInvalidValue;
  if (!on_chip && q_n > 0 && (delta_g == nullptr || list_g == nullptr))
    return (int)cudaErrorInvalidValue;
  static int set_bytes = -1;
  if (smem_bytes > 40 * 1024 && smem_bytes != set_bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        qfair_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    set_bytes = smem_bytes;
  }
  QfairArgs a;
  a.w = w;
  a.req = req;
  a.total = total;
  a.req_hs = req_hs;
  a.mins = mins;
  a.d_hs = d_hs;
  a.d = d;
  a.met = met;
  a.qf_raw = qf_raw;
  a.delta_g = on_chip ? nullptr : delta_g;
  a.list_g = on_chip ? nullptr : list_g;
  a.total_hs = total_hs;
  a.q_n = q_n;
  a.r_n = r_n;
  a.iters = iters;
  a.on_chip = on_chip;
  qfair_solve_kernel<<<1, threads, smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
