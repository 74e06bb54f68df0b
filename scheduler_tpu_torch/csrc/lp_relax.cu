// lp_relax: the LP-relaxed allocator's fixed-point iteration, one C call a solve.
//
// Replaces XLA code, not a Pallas kernel: the body of _iterate_block in
// scheduler_tpu/ops/lp_place.py:212-265 (the fori_loop of row softmax, load
// product and capacity projection that lp_relax runs over the whole node
// axis on one device).  The plain PyTorch version of the same function is
// scheduler_tpu_torch/ops/lp_place.py::lp_iterate_reference; the two agree
// within a stated tolerance (their sums run in other orders), with pref and
// the evidence row equal.
//
// What it computes, for `iters` iterations, with log_v = 0 at the start:
//   1. z = logits + log_v; a row's max m, its lowest-index argmax pref and
//      s = sum exp(z - m);
//   2. mass = (m > NEG / 2); coef = (exp(m - m) * mass) / s, in that float
//      order; x = exp(z - m) * coef;
//   3. load = x^T req over the R' capacity columns;
//   4. ratio = min_r cap / max(load, 1e-9) over the columns with
//      load > 1e-9 (+inf where none); scale = clip(min(ratio, 1), 1e-6, 1);
//      log_v += log(scale);
//   5. max |log(scale)| is the next iteration's test: converged_at takes
//      i - 1 at the first iteration i > 0 whose test is under tol.
// Outputs: x and pref of the last iteration (written then only), and
// lp_raw = {iters, converged_at or -1}.
//
// What bounds it on this card: memory.  An iteration reads the [rows, N]
// logits twice (the row pass and the column pass), 8 x rows x N bytes, and
// the rest is O(rows + N); at r' (8,192 x 1,024) that is 64 MiB an
// iteration, 20 us at 3.35 TB/s.  The design is the simple one: four
// launches an iteration on the caller's stream.
//   - lp_row: one CTA a row, threads strided over the nodes; the max and
//     its lowest index, then the sum of exponentials, each reduced over the
//     block in a fixed tree order; writes the row's m and coef (and pref on
//     the last iteration).  CTA 0 also applies the converged_at rule.
//   - lp_col: a thread a node, over a chunk of CHUNK rows (blockIdx.y),
//     summing x * req in ascending row order: it recomputes x from the
//     logits, so x never goes to device memory but on the last iteration,
//     and the reads are coalesced across the warp.  Each chunk writes a
//     partial load; no atomics.
//   - lp_node: a thread a node sums the partial loads in chunk order,
//     computes the projection and updates log_v; each CTA writes its max
//     |update|.
//   - lp_max: one CTA takes the max of the CTAs' maxima (exact in any
//     order).
// Two runs on the same operands give the same bits: no float atomics, and
// every sum runs in a fixed order.  Built with --fmad=false; expf and logf
// are the accurate library functions, not the fast intrinsics.
//
// Build: with the port's other kernels, by scheduler_tpu_torch/ops/cuda_build.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define LP_MAX_COLS 16
#define LP_ROW_THREADS 256
#define LP_COL_THREADS 128
#define LP_NODE_THREADS 256
#define LP_MAX_THREADS 256
#define FULL_MASK 0xffffffffu

// NEG * 0.5 with NEG = -1e9, exact in float32.
#define LP_MASS_FLOOR (-5.0e8f)

__global__ void lp_init(float* gupd, int* lp_raw) {
  gupd[0] = INFINITY;
  lp_raw[0] = 0;
  lp_raw[1] = -1;
}

// The max of a (value, index) pair over the block, lowest index on ties;
// every thread gets the result.  Fixed reduction order.
__device__ __forceinline__ void block_argmax(float& v, int& idx, float* sv, int* si) {
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(FULL_MASK, v, off);
    int oi = __shfl_down_sync(FULL_MASK, idx, off);
    if (ov > v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = idx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bv = sv[0];
    int bi = si[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
      if (sv[w] > bv || (sv[w] == bv && si[w] < bi)) {
        bv = sv[w];
        bi = si[w];
      }
    }
    sv[0] = bv;
    si[0] = bi;
  }
  __syncthreads();
  v = sv[0];
  idx = si[0];
  __syncthreads();
}

// The sum over the block, in a fixed order; every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* sv) {
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(FULL_MASK, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sv[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = sv[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) s = __fadd_rn(s, sv[w]);
    sv[0] = s;
  }
  __syncthreads();
  float s = sv[0];
  __syncthreads();
  return s;
}

// The max over the block of non-negative values; every thread gets it.
__device__ __forceinline__ float block_max(float v, float* sv) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_down_sync(FULL_MASK, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sv[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = sv[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, sv[w]);
    sv[0] = m;
  }
  __syncthreads();
  float m = sv[0];
  __syncthreads();
  return m;
}

__global__ void __launch_bounds__(LP_ROW_THREADS)
lp_row(const float* __restrict__ logits, const float* __restrict__ log_v, int n, int it,
       int iters, float tol, const float* __restrict__ gupd, int* lp_raw, float* mrow,
       float* coef, int* pref) {
  __shared__ float sv[LP_MAX_THREADS / 32];
  __shared__ int si[LP_MAX_THREADS / 32];
  const int t = blockIdx.x;
  const int last = it == iters - 1;
  if (t == 0 && threadIdx.x == 0) {
    // gupd is the previous iteration's max |update|: that iteration is
    // the one certified (the i - 1 rule).
    if (it > 0 && gupd[0] < tol && lp_raw[1] < 0) lp_raw[1] = it - 1;
    if (last) lp_raw[0] = iters;
  }
  const float* row = logits + (size_t)t * n;
  float best = -INFINITY;
  int bi = n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float z = __fadd_rn(row[j], log_v[j]);
    if (z > best) {  // ascending j: the first of equal values stays
      best = z;
      bi = j;
    }
  }
  block_argmax(best, bi, sv, si);
  const float m = best;
  float s = 0.0f;
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    s = __fadd_rn(s, expf(__fsub_rn(__fadd_rn(row[j], log_v[j]), m)));
  s = block_sum(s, sv);
  if (threadIdx.x == 0) {
    const float mass = m > LP_MASS_FLOOR ? 1.0f : 0.0f;
    mrow[t] = m;
    coef[t] = __fdiv_rn(__fmul_rn(expf(__fsub_rn(m, m)), mass), s);
    if (last) pref[t] = bi;
  }
}

__global__ void __launch_bounds__(LP_COL_THREADS)
lp_col(const float* __restrict__ logits, const float* __restrict__ log_v,
       const float* __restrict__ mrow, const float* __restrict__ coef,
       const float* __restrict__ req, int rows, int n, int r, int chunk_rows, int last,
       float* __restrict__ partial, float* __restrict__ x) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int c = blockIdx.y;
  const int t0 = c * chunk_rows;
  const int t1 = min(rows, t0 + chunk_rows);
  const float lv = log_v[j];
  float acc[LP_MAX_COLS];
#pragma unroll
  for (int k = 0; k < LP_MAX_COLS; ++k) acc[k] = 0.0f;
  for (int t = t0; t < t1; ++t) {
    const size_t cell = (size_t)t * n + j;
    const float e = expf(__fsub_rn(__fadd_rn(logits[cell], lv), mrow[t]));
    const float xv = __fmul_rn(e, coef[t]);
    if (last) {
      x[cell] = xv;
    } else {
      const float* rq = req + (size_t)t * r;
#pragma unroll
      for (int k = 0; k < LP_MAX_COLS; ++k)
        if (k < r) acc[k] = __fadd_rn(acc[k], __fmul_rn(xv, rq[k]));
    }
  }
  if (!last) {
    float* out = partial + ((size_t)c * n + j) * r;
#pragma unroll
    for (int k = 0; k < LP_MAX_COLS; ++k)
      if (k < r) out[k] = acc[k];
  }
}

__global__ void __launch_bounds__(LP_NODE_THREADS)
lp_node(const float* __restrict__ partial, const float* __restrict__ cap, int n, int r,
        int chunks, float* __restrict__ log_v, float* __restrict__ blockmax) {
  __shared__ float sv[LP_MAX_THREADS / 32];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  float a = 0.0f;
  if (j < n) {
    float ratio = INFINITY;
    for (int k = 0; k < r; ++k) {
      float load = 0.0f;
      for (int c = 0; c < chunks; ++c)
        load = __fadd_rn(load, partial[((size_t)c * n + j) * r + k]);
      if (load > 1e-9f) ratio = fminf(ratio, __fdiv_rn(cap[(size_t)j * r + k], fmaxf(load, 1e-9f)));
    }
    const float scale = fminf(fmaxf(fminf(ratio, 1.0f), 1e-6f), 1.0f);
    const float upd = logf(scale);
    log_v[j] = __fadd_rn(log_v[j], upd);
    a = fabsf(upd);
  }
  a = block_max(a, sv);
  if (threadIdx.x == 0) blockmax[blockIdx.x] = a;
}

__global__ void __launch_bounds__(LP_MAX_THREADS)
lp_max(const float* __restrict__ blockmax, int blocks, float* gupd) {
  __shared__ float sv[LP_MAX_THREADS / 32];
  float a = 0.0f;
  for (int b = threadIdx.x; b < blocks; b += blockDim.x) a = fmaxf(a, blockmax[b]);
  a = block_max(a, sv);
  if (threadIdx.x == 0) gupd[0] = a;
}

extern "C" int lp_relax_launch(const float* logits, const float* cap, const float* req, int rows,
                               int n, int r, int iters, float tol, int chunk_rows, int chunks,
                               float* log_v, float* mrow, float* coef, float* partial,
                               float* blockmax, float* gupd, float* x, int* pref, int* lp_raw,
                               cudaStream_t stream) {
  if (rows < 1 || n < 1 || r < 1 || r > LP_MAX_COLS || iters < 1 || chunk_rows < 1 ||
      chunks != (rows + chunk_rows - 1) / chunk_rows)
    return (int)cudaErrorInvalidValue;
  const int node_blocks = (n + LP_NODE_THREADS - 1) / LP_NODE_THREADS;
  const dim3 col_grid((n + LP_COL_THREADS - 1) / LP_COL_THREADS, chunks);
  cudaError_t err = cudaMemsetAsync(log_v, 0, sizeof(float) * (size_t)n, stream);
  if (err != cudaSuccess) return (int)err;
  lp_init<<<1, 1, 0, stream>>>(gupd, lp_raw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int it = 0; it < iters; ++it) {
    const int last = it == iters - 1;
    lp_row<<<rows, LP_ROW_THREADS, 0, stream>>>(logits, log_v, n, it, iters, tol, gupd, lp_raw,
                                                mrow, coef, pref);
    lp_col<<<col_grid, LP_COL_THREADS, 0, stream>>>(logits, log_v, mrow, coef, req, rows, n, r,
                                                    chunk_rows, last, partial, x);
    if (!last) {
      lp_node<<<node_blocks, LP_NODE_THREADS, 0, stream>>>(partial, cap, n, r, chunks, log_v,
                                                           blockmax);
      lp_max<<<1, LP_MAX_THREADS, 0, stream>>>(blockmax, node_blocks, gupd);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Node blocks: the iteration over a node mesh (ops/mesh.py), the
// counterpart of _lp_iterate_1d/_2d and their signature-class twins in
// scheduler_tpu/ops/lp_place.py:359-513 with
// scheduler_tpu/ops/sharded.py::merge_row_logsumexp.  Each block k holds
// n node columns (global offset k * n); an iteration:
//   1. lp_row_block, a block at a time: a row's block max m_k, its lowest
//      argmax (as a global index), s_k = sum exp(z - m_k), and the block's
//      previous max |update|, into the block's [4, rows] LP_PACK;
//   2. lp_merge, one thread a row over the D packs in block order:
//      m = max m_k (the first block holding it gives pref), s = sum_k s_k *
//      exp(m_k - m) in block order, mass = (m > NEG / 2), and each block's
//      coef_k = (exp(m_k - m) * mass) / s; the max of the blocks' updates
//      feeds the converged_at rule;
//   3. lp_col, lp_node and lp_max a block at a time, as on one device, with
//      the block's m_k and coef_k: x = exp(z - m_k) * coef_k.
// All blocks lie on one device here: the caller gathers them there.

#define LP_PACK_ROWS 4

__global__ void lp_init_blocks(float* gupd, int d, int* lp_raw) {
  for (int k = 0; k < d; ++k) gupd[k] = INFINITY;
  lp_raw[0] = 0;
  lp_raw[1] = -1;
}

__global__ void __launch_bounds__(LP_ROW_THREADS)
lp_row_block(const float* __restrict__ logits, const float* __restrict__ log_v, int n,
             int offset, int rows, const float* __restrict__ gupd, float* __restrict__ pack) {
  __shared__ float sv[LP_MAX_THREADS / 32];
  __shared__ int si[LP_MAX_THREADS / 32];
  const int t = blockIdx.x;
  const float* row = logits + (size_t)t * n;
  float best = -INFINITY;
  int bi = n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float z = __fadd_rn(row[j], log_v[j]);
    if (z > best) {
      best = z;
      bi = j;
    }
  }
  block_argmax(best, bi, sv, si);
  const float m = best;
  float s = 0.0f;
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    s = __fadd_rn(s, expf(__fsub_rn(__fadd_rn(row[j], log_v[j]), m)));
  s = block_sum(s, sv);
  if (threadIdx.x == 0) {
    pack[0 * rows + t] = m;
    pack[1 * rows + t] = s;
    pack[2 * rows + t] = (float)(bi + offset);
    pack[3 * rows + t] = gupd[0];
  }
}

__global__ void __launch_bounds__(LP_MAX_THREADS)
lp_merge(const float* __restrict__ pack, int d, int rows, int it, int iters, float tol,
         float* __restrict__ coef, int* __restrict__ pref, int* lp_raw) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int last = it == iters - 1;
  if (t == 0) {
    float upd = pack[3 * rows];
    for (int k = 1; k < d; ++k) upd = fmaxf(upd, pack[(size_t)k * LP_PACK_ROWS * rows + 3 * rows]);
    if (it > 0 && upd < tol && lp_raw[1] < 0) lp_raw[1] = it - 1;
    if (last) lp_raw[0] = iters;
  }
  if (t >= rows) return;
  float m = pack[t];
  int star = 0;
  for (int k = 1; k < d; ++k) {
    const float mk = pack[(size_t)k * LP_PACK_ROWS * rows + t];
    if (mk > m) {
      m = mk;
      star = k;
    }
  }
  float s = 0.0f;
  for (int k = 0; k < d; ++k) {
    const float* pk = pack + (size_t)k * LP_PACK_ROWS * rows;
    s = __fadd_rn(s, __fmul_rn(pk[rows + t], expf(__fsub_rn(pk[t], m))));
  }
  const float mass = m > LP_MASS_FLOOR ? 1.0f : 0.0f;
  for (int k = 0; k < d; ++k) {
    const float mk = pack[(size_t)k * LP_PACK_ROWS * rows + t];
    coef[(size_t)k * rows + t] = __fdiv_rn(__fmul_rn(expf(__fsub_rn(mk, m)), mass), s);
  }
  if (last) pref[t] = (int)pack[(size_t)star * LP_PACK_ROWS * rows + 2 * rows + t];
}

extern "C" int lp_relax_blocks_launch(int d, const float* const* logits, const float* const* cap,
                                      const float* req, int rows, int n, int r, int iters,
                                      float tol, int chunk_rows, int chunks,
                                      float* const* log_v, float* const* partial,
                                      float* const* blockmax, float* gupd, float* pack,
                                      float* coef, float* const* x, int* pref, int* lp_raw,
                                      cudaStream_t stream) {
  if (d < 1 || rows < 1 || n < 1 || r < 1 || r > LP_MAX_COLS || iters < 1 || chunk_rows < 1 ||
      chunks != (rows + chunk_rows - 1) / chunk_rows)
    return (int)cudaErrorInvalidValue;
  const int node_blocks = (n + LP_NODE_THREADS - 1) / LP_NODE_THREADS;
  const dim3 col_grid((n + LP_COL_THREADS - 1) / LP_COL_THREADS, chunks);
  const int merge_blocks = (rows + LP_MAX_THREADS - 1) / LP_MAX_THREADS;
  cudaError_t err;
  for (int k = 0; k < d; ++k) {
    err = cudaMemsetAsync(log_v[k], 0, sizeof(float) * (size_t)n, stream);
    if (err != cudaSuccess) return (int)err;
  }
  lp_init_blocks<<<1, 1, 0, stream>>>(gupd, d, lp_raw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int it = 0; it < iters; ++it) {
    const int last = it == iters - 1;
    for (int k = 0; k < d; ++k)
      lp_row_block<<<rows, LP_ROW_THREADS, 0, stream>>>(
          logits[k], log_v[k], n, k * n, rows, gupd + k, pack + (size_t)k * LP_PACK_ROWS * rows);
    lp_merge<<<merge_blocks, LP_MAX_THREADS, 0, stream>>>(pack, d, rows, it, iters, tol, coef,
                                                          pref, lp_raw);
    for (int k = 0; k < d; ++k) {
      lp_col<<<col_grid, LP_COL_THREADS, 0, stream>>>(
          logits[k], log_v[k], pack + (size_t)k * LP_PACK_ROWS * rows, coef + (size_t)k * rows,
          req, rows, n, r, chunk_rows, last, partial[k], x[k]);
      if (!last) {
        lp_node<<<node_blocks, LP_NODE_THREADS, 0, stream>>>(partial[k], cap[k], n, r, chunks,
                                                             log_v[k], blockmax[k]);
        lp_max<<<1, LP_MAX_THREADS, 0, stream>>>(blockmax[k], node_blocks, gupd + k);
      }
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
