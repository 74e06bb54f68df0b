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
// dim per queue per round; every queue step depends on the one before (the
// increased and decreased folds, the met flags the next round's weight sum
// reads).  So one warp does it all: a lane holds dims lane, lane + 32, ...,
// the cap tests are warp votes (__all_sync / __any_sync), and nothing needs
// a block barrier.  The pool and the two folds sit in shared memory; the
// deserved rows are written in place in the output, and the met and
// scalar-presence flags in global memory (any Q).  The rounds after the
// fixed point are no-ops in the reference, so the kernel stops there.
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

__global__ void __launch_bounds__(32, 1)
    qfair_solve_kernel(const double* __restrict__ w, const double* __restrict__ req,
                       const double* __restrict__ total, const uint8_t* __restrict__ req_hs,
                       const double* __restrict__ mins, uint8_t* d_hs, int total_hs, int q_n,
                       int r_n, int iters, double* d, uint8_t* met, int* qf_raw) {
  extern __shared__ double sh[];
  double* rem = sh;            // [r_n] the pool
  double* inc = sh + r_n;      // [r_n] this round's increased fold
  double* dec = sh + 2 * r_n;  // [r_n] this round's decreased fold
  const int lane = threadIdx.x;
  for (int r = lane; r < r_n; r += 32) rem[r] = total[r];
  for (long x = lane; x < (long)q_n * r_n; x += 32) d[x] = 0.0;
  for (int q = lane; q < q_n; q += 32) {
    met[q] = 0;
    d_hs[q] = 0;
  }
  __syncwarp();
  bool rem_hs = total_hs != 0;
  bool done = false;
  int rounds = 0;
  for (int it = 0; it < iters && !done; ++it) {
    // The unmet-weight sum, folded in queue order by one lane.
    double tw = 0.0;
    if (lane == 0)
      for (int q = 0; q < q_n; ++q) tw = __dadd_rn(tw, met[q] ? 0.0 : w[q]);
    tw = __shfl_sync(FULL_MASK, tw, 0);
    if (tw == 0.0) {
      done = true;  // nothing left to share: the round changes nothing
      break;
    }
    for (int r = lane; r < r_n; r += 32) {
      inc[r] = 0.0;
      dec[r] = 0.0;
    }
    for (int q = 0; q < q_n; ++q) {
      if (met[q]) continue;  // the same in every lane
      const double ratio = __ddiv_rn(w[q], tw);
      double* row = d + (size_t)q * r_n;
      const double* rq = req + (size_t)q * r_n;
      // The request cap: ResourceVec.less(request, new deserved).
      bool strict = true, scalar_ok = true, any_cap = false;
      for (int r = lane; r < r_n; r += 32) {
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
      const bool new_hs = d_hs[q] != 0 || rem_hs;
      const bool capped = (req_hs[q] ? scalar_ok : new_hs) && strict;
      for (int r = lane; r < r_n; r += 32) {
        const double old = row[r];
        const double nd = __dadd_rn(old, __dadd_rn(__dmul_rn(rem[r], ratio), 0.0));
        const double fin = capped ? fmin(nd, rq[r]) : nd;
        const double delta = __dsub_rn(fin, old);
        inc[r] = __dadd_rn(inc[r], delta > 0.0 ? delta : 0.0);
        dec[r] = __dadd_rn(dec[r], delta < 0.0 ? -delta : 0.0);
        row[r] = fin;
      }
      __syncwarp();
      if (lane == 0) {
        d_hs[q] = capped ? any_cap : new_hs;
        if (capped) met[q] = 1;
      }
      __syncwarp();
    }
    // The pool after the round, and whether it is drained.
    bool empty = true, dec_scalar = false;
    for (int r = lane; r < r_n; r += 32) {
      const double r2 = __dadd_rn(__dsub_rn(rem[r], inc[r]), dec[r]);
      rem[r] = r2;
      empty = empty && (r2 < mins[r]);
      if (r >= 2 && dec[r] != 0.0) dec_scalar = true;
    }
    empty = __all_sync(FULL_MASK, empty);
    rem_hs = rem_hs || __any_sync(FULL_MASK, dec_scalar);
    rounds += 1;
    if (empty) done = true;
    __syncwarp();
  }
  if (lane == 0) {
    qf_raw[0] = iters;
    qf_raw[1] = done ? rounds : -1;
  }
}

extern "C" int qfair_solve_launch(const double* w, const double* req, const double* total,
                                  const uint8_t* req_hs, const double* mins, uint8_t* d_hs,
                                  int total_hs, int q_n, int r_n, int iters, double* d,
                                  uint8_t* met, int* qf_raw, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (r_n < 2 || q_n < 0 || iters < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = 3 * (size_t)r_n * sizeof(double);
  qfair_solve_kernel<<<1, 32, smem, (cudaStream_t)stream>>>(w, req, total, req_hs, mins, d_hs,
                                                           total_hs, q_n, r_n, iters, d, met,
                                                           qf_raw);
  return (int)cudaGetLastError();
}
