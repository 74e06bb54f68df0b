// lp_relax: the LP-relaxed allocator's fixed-point iteration, ONE kernel
// launch a solve, on one device or over D node blocks.
//
// Replaces XLA code, not a Pallas kernel: the body of _iterate_block in
// scheduler_tpu/ops/lp_place.py:212-265 (the fori_loop of row softmax, load
// product and capacity projection that lp_relax runs over the whole node
// axis on one device), and its node-block twins (:359-513, _lp_iterate_1d/
// _2d/_sig_1d/_sig_2d with sharded.py::merge_row_logsumexp), whose blocks
// the caller gathers onto one device.  The plain PyTorch versions of the
// same functions are scheduler_tpu_torch/ops/lp_place.py::
// lp_iterate_reference and lp_iterate_blocks_reference; the kernel agrees
// with them within a stated tolerance (its sums run in other orders), with
// pref and the evidence row equal.
//
// What it computes, for `iters` iterations, with log_v = 0 at the start:
//   1. z = logits + log_v; over each node tile of a row (a node tile never
//      crosses a block), the tile's max m_t, its lowest-index argmax and
//      s_t = sum exp(z - m_t);
//   2. the row's merge over its tiles in tile order (block, then tile):
//      m = max m_t (the first tile holding it gives pref), s = sum_t s_t *
//      exp(m_t - m), mass = (m > NEG / 2), coef_t = (exp(m_t - m) * mass) /
//      s, x = exp(z - m_t) * coef_t;
//   3. load = x^T req over the R' capacity columns, summed in float64 (each
//      float32 product exact) and rounded to float32 once: each row tile's
//      rows in ascending order, then the row tiles in four sums (row tile
//      rt into sum rt mod 4, ascending), added (0 + 1) + (2 + 3);
//   4. ratio = min_r cap / max(load, 1e-9) over the columns with
//      load > 1e-9 (+inf where none); scale = clip(min(ratio, 1), 1e-6, 1);
//      log_v += log(scale);
//   5. converged_at = the first iteration j whose max |log(scale)| is under
//      tol (the i - 1 rule: iteration i + 1 certifies iteration i), else -1.
// Outputs: x and pref of the last iteration (written then only), and
// lp_raw = {iters, converged_at}.
//
// What bounds it on this card.  The work is float32 arithmetic on every
// cell of the [rows, N] plane each iteration (an add, a compare, an
// exponential, a sum, a product and a multiply-add a capacity column), on
// operands that fit on chip: r''s 32 MiB of logits fit the 50 MB L2 and
// mostly the SMs' shared memory (132 x 227 KB).  The four-launch design it
// replaces made 799 dependent launches a solve, read the logits
// from device memory twice an iteration and ran each exponential twice;
// its block mode ran the row pass once a block.  This design:
//   - one cooperative launch (cudaLaunchKernelEx, cudaLaunchAttributeCooperative)
//     of the plan's CTAs, at most one an SM, all resident; the entry checks
//     residency by cudaOccupancyMaxActiveBlocksPerMultiprocessor and
//     returns an error for a plan that cannot run (the wrapper raises);
//   - phases meet at a grid barrier on an integer counter (release add,
//     acquire load at GPU scope); no float atomics anywhere;
//   - the plan (ops/lp_place.py::lp_plan) tiles the plane.  "rows": a CTA
//     owns whole rows over every block, so the row merge is local and an
//     iteration has two barriers (after the load partials, after the
//     projection); rows go through shared memory a batch at a time, a warp
//     a row.  "tiles": a CTA owns a row tile x node tile, the tile
//     statistics go to global memory, and an iteration has two barriers
//     (after the statistics, after the load partials); every CTA of a node
//     tile projects that tile itself, so log_v stays in its shared memory;
//   - a CTA keeps as many of its logits rows in shared memory as fit, once
//     a solve; the rest it reads from L2 each iteration;
//   - z and then e = exp(z - m_t) are written into a shared-memory buffer
//     (tiles mode: the whole tile, spilled to a global scratch past what
//     fits), so each cell's exponential runs once an iteration;
//   - the load partials go to a float64 [row tiles, R', N] scratch; the
//     projection stages them in shared memory and sums them per node;
//     At an equilibrium the prices bring two nodes' z within an ulp of
//     each other (path r' at its tight operands: row 5,181, nodes 524 and
//     939), so a float32 load summed in a tiling's order decides
//     pref by its last bit; summed in float64 and rounded once, the load is
//     the same for every plan to within that rounding;
//   - each CTA takes an integer atomicMax of its max |update|'s bits (the
//     values are non-negative, so their bits order as they do) into one
//     word an iteration; CTA 0 finds converged_at from those at the end.
// Two runs on the same operands give the same bits: every sum runs in a
// fixed order.  Built with --fmad=false; expf and logf are the accurate
// library functions, not the fast intrinsics.
//
// Phase clocks: built with -DLP_PHASE_CLOCKS (scripts/lp_ab.py), thread 0
// of CTA 0 sums the SM clocks of each phase into clocks[0..LP_PHASES), then
// the kernel's clocks and nanoseconds.
//
// Build: with the port's other kernels, by scheduler_tpu_torch/ops/cuda_build.py.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define LP_MAX_COLS 16
#define LP_MAX_BLOCKS 16
#define LP_THREADS 512
#define LP_WARPS (LP_THREADS / 32)
#define LP_SMEM_LIMIT 232448
#define FULL_MASK 0xffffffffu

// NEG * 0.5 with NEG = -1e9, exact in float32.
#define LP_MASS_FLOOR (-5.0e8f)

// The entry's own error codes (past CUDA's).
#define LP_ERR_PLAN 10001
#define LP_ERR_NOT_RESIDENT 10002

#define LP_MODE_ROWS 0
#define LP_MODE_TILES 1

// Phases of the clocks: 0 tile statistics, 1 tile merge, 2 load partials
// (or the marginals), 3 projection, 4 grid barriers, 5 log_v reload.
#define LP_PHASES 6
#ifdef LP_PHASE_CLOCKS
#define TICK(k)                                 \
  do {                                          \
    if (clk_on) {                               \
      const long long _t = clock64();           \
      ph[k] += _t - ph_at;                      \
      ph_at = _t;                               \
    }                                           \
  } while (0)
#else
#define TICK(k) \
  do {          \
  } while (0)
#endif

// Mirror: ops/lp_place.py::_LpArgs.
struct LpArgs {
  const float* logits[LP_MAX_BLOCKS];  // [rows, n] a block
  const float* cap[LP_MAX_BLOCKS];     // [n, r] a block
  float* x[LP_MAX_BLOCKS];             // [rows, n] a block (out)
  const float* req;                    // [rows, r]
  float* log_v;                        // [d * n] (rows mode)
  double* partial;                     // [row_tiles, r, d * n]
  float* stat_m;                       // [rows, d * node_tiles] (tiles mode)
  float* stat_s;                       // [rows, d * node_tiles] (tiles mode)
  int* stat_a;                         // [rows, d * node_tiles] (tiles mode)
  float* spill;                        // [ctas, (tr - e_rows) * tn] (tiles mode, where e_rows < tr)
  unsigned int* state;                 // [2 + iters]: the barrier counter, then max |update| bits
  int* pref;                           // [rows] (out)
  int* lp_raw;                         // [2] (out)
  long long* clocks;                   // [LP_PHASES + 2] (LP_PHASE_CLOCKS builds) or null
  int rows, n, r, d, iters;
  float tol;
  // The plan (ops/lp_place.py::lp_plan); offsets in floats of dynamic
  // shared memory.
  int mode, ctas, tr, row_tiles, tn, node_tiles, batch, l_rows, e_rows, stage_nodes;
  int smem_bytes, off_lv, off_acc, off_e, off_stat, off_req, off_l;
};

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(unsigned int* p, unsigned int v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The grid barrier: every CTA is resident (a cooperative launch), and the
// counter only grows: the k-th barrier of the solve waits for k * ctas
// arrivals.  The counter starts at 0 (the entry clears it).  A wait past
// LP_BARRIER_NS traps (the launch then fails) rather than spin forever.
#define LP_BARRIER_NS 20000000000ull
__device__ __forceinline__ void grid_sync(unsigned int* counter, unsigned int& target,
                                          unsigned int ctas) {
  __syncthreads();
  target += ctas;
  if (threadIdx.x == 0) {
    __threadfence();
    red_release_add(counter, 1u);
    const unsigned long long t0 = global_ns();
    unsigned int spins = 0;
    while (ld_acquire(counter) < target) {
      if ((++spins & 4095u) == 0 && global_ns() - t0 > LP_BARRIER_NS) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// The max of (value, index) over the warp, lowest index on ties; every lane
// gets it (the order is a total one, so the butterfly agrees in every lane).
__device__ __forceinline__ void warp_argmax(float& v, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL_MASK, v, off);
    const int oi = __shfl_xor_sync(FULL_MASK, idx, off);
    if (ov > v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
}

// The sum over the warp in a fixed butterfly order (a + b == b + a, so
// every lane holds the same bits).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

// One segment of one row, a warp: cells [0, w) of `lrow` (shared memory or
// device memory) plus log_v `lv`, with z and then e = exp(z - m) written to
// `e`.  Returns m, s = sum e (lane order then a butterfly) and the lowest
// argmax in every lane.
__device__ __forceinline__ void row_segment(const float* lrow, const float* lv, float* e, int w,
                                            int lane, float& m, float& s, int& am) {
  float best = -INFINITY;
  int bi = INT_MAX;
  for (int j = lane; j < w; j += 32) {
    const float z = __fadd_rn(lrow[j], lv[j]);
    e[j] = z;
    if (z > best) {  // ascending j: the first of equal values stays
      best = z;
      bi = j;
    }
  }
  warp_argmax(best, bi);
  float acc = 0.0f;
  for (int j = lane; j < w; j += 32) {
    const float v = expf(__fsub_rn(e[j], best));
    e[j] = v;
    acc = __fadd_rn(acc, v);
  }
  m = best;
  s = warp_sum(acc);
  am = bi;
}

// One row's marginal x = e * coef (float32, as the plain version rounds it)
// into a node's running load, column by column, in float64: a product of
// two floats is exact there (so a fused multiply-add rounds once, as a
// product and a sum would), and the load is the sum of the plain version's
// products rounded once, whatever the tiling.  The kernels are built for RM
// = 2, 4, 8 and 16 columns; a request row in shared memory is padded with
// zeros to RM, so no column needs a predicate (a predicated-off
// instruction still takes its issue slot).
template <int RM>
__device__ __forceinline__ void load_row(double (&acc)[RM], float e, float coef,
                                         const double* rq) {
  const double xv = (double)__fmul_rn(e, coef);
#pragma unroll
  for (int c = 0; c < RM; ++c) acc[c] = __fma_rn(xv, rq[c], acc[c]);
}

// A request row of r columns into shared memory as RM float64 columns, the
// ones past r zero.
template <int RM>
__device__ __forceinline__ void stage_req(double* dst, const float* req, int rows, int r) {
  for (int idx = threadIdx.x; idx < rows * RM; idx += LP_THREADS) {
    const int i = idx / RM, c = idx - i * RM;
    dst[idx] = c < r ? (double)req[(size_t)i * r + c] : 0.0;
  }
}

// The projection of global nodes [p0, p1): each node's load summed over the
// row tiles (staged through shared memory `stage`, `stage_nodes` nodes at a
// time) in four float64 sums, row tiles rt = q mod 4 ascending in sum q,
// then (0 + 1) + (2 + 3); its ratio, scale and update; log_v of node p0 + q
// is lv[q] (read, then written back to lv_out[q]).  Returns this thread's
// max |update|.
__device__ __forceinline__ float project(const LpArgs& a, int p0, int p1, double* stage,
                                         const float* lv, float* lv_out) {
  const int r = a.r, wtot = a.d * a.n, rt_n = a.row_tiles;
  float amax = 0.0f;
  for (int q0 = p0; q0 < p1; q0 += a.stage_nodes) {
    const int nq = min(a.stage_nodes, p1 - q0);
    const int per = r * nq;
    for (int idx = threadIdx.x; idx < rt_n * per; idx += LP_THREADS) {
      const int rt = idx / per, rem = idx - rt * per;
      const int c = rem / nq, j = rem - c * nq;
      stage[idx] = __ldcg(a.partial + ((size_t)rt * r + c) * wtot + q0 + j);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < nq; j += LP_THREADS) {
      const int g = q0 + j;
      const int k = g / a.n, jj = g - k * a.n;
      const float* cap = a.cap[k] + (size_t)jj * r;
      float ratio = INFINITY;
      for (int c = 0; c < r; ++c) {
        const double* col = stage + c * nq + j;
        double s4[4] = {0.0, 0.0, 0.0, 0.0};
        int rt = 0;
        for (; rt + 4 <= rt_n; rt += 4) {
#pragma unroll
          for (int q = 0; q < 4; ++q) s4[q] = __dadd_rn(s4[q], col[(rt + q) * per]);
        }
#pragma unroll
        for (int q = 0; q < 3; ++q)
          if (rt + q < rt_n) s4[q] = __dadd_rn(s4[q], col[(rt + q) * per]);
        const float load =
            __double2float_rn(__dadd_rn(__dadd_rn(s4[0], s4[1]), __dadd_rn(s4[2], s4[3])));
        if (load > 1e-9f) ratio = fminf(ratio, __fdiv_rn(__ldg(cap + c), fmaxf(load, 1e-9f)));
      }
      const float scale = fminf(fmaxf(fminf(ratio, 1.0f), 1e-6f), 1.0f);
      const float upd = logf(scale);
      const int q = g - p0;
      lv_out[q] = __fadd_rn(lv[q], upd);
      amax = fmaxf(amax, fabsf(upd));
    }
    __syncthreads();
  }
  return amax;
}

// The solve's end: CTA 0's first warp finds converged_at from the
// iterations' max |update| words and writes the evidence row.
__device__ __forceinline__ void finish(const LpArgs& a, int lane) {
  const unsigned int* gmax = a.state + 2;
  int first = INT_MAX;
  for (int j = lane; j < a.iters - 1; j += 32) {
    if (__uint_as_float(__ldcg(gmax + j)) < a.tol) {
      first = j;
      break;
    }
  }
  first = warp_min(first);
  if (lane == 0) {
    a.lp_raw[0] = a.iters;
    a.lp_raw[1] = first == INT_MAX ? -1 : first;
  }
}

// ---------------------------------------------------------------------------
// rows mode: CTA c owns rows [c * tr, ...) over all d * n nodes.
template <int RM>
__global__ void __launch_bounds__(LP_THREADS, 1) lp_rows_kernel(const LpArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cta = blockIdx.x;
  const int n = a.n, r = a.r, d = a.d, w = d * n;
  const int row0 = cta * a.tr;
  const int nrows = min(a.tr, a.rows - row0);
  float* s_lv = smem + a.off_lv;    // [w]
  double* s_acc = (double*)(smem + a.off_acc);  // [r, w]
  float* s_e = smem + a.off_e;      // [batch, w]; the projection's stage
  float* s_m = smem + a.off_stat;   // [batch, d]
  float* s_s = s_m + a.batch * d;
  float* s_coef = s_s + a.batch * d;
  int* s_am = (int*)(s_coef + a.batch * d);
  double* s_req = (double*)(smem + a.off_req);  // [batch, RM]
  float* s_l = smem + a.off_l;      // [l_rows, w]
  const int l_rows = min(a.l_rows, nrows);
  unsigned int target = 0;
  // This CTA's share of the projection.
  const int per = (w + a.ctas - 1) / a.ctas;
  const int p0 = min(cta * per, w), p1 = min(p0 + per, w);
#ifdef LP_PHASE_CLOCKS
  const bool clk_on = cta == 0 && tid == 0 && a.clocks != nullptr;
  long long ph[LP_PHASES] = {0, 0, 0, 0, 0, 0};
  const long long clk0 = clock64();
  long long ph_at = clk0;
  const unsigned long long ns0 = global_ns();
#endif

  // The logits rows that stay on chip, once a solve.
  for (int idx = tid; idx < l_rows * w; idx += LP_THREADS) {
    const int i = idx / w, g = idx - i * w;
    const int k = g / n, jj = g - k * n;
    s_l[idx] = a.logits[k][(size_t)(row0 + i) * n + jj];
  }
  for (int g = tid; g < w; g += LP_THREADS) s_lv[g] = 0.0f;
  __syncthreads();

  for (int it = 0; it < a.iters; ++it) {
    const bool last = it == a.iters - 1;
    if (it > 0) {
      for (int g = tid; g < w; g += LP_THREADS) s_lv[g] = __ldcg(a.log_v + g);
      __syncthreads();
      TICK(5);
    }
    for (int b0 = 0; b0 < nrows; b0 += a.batch) {
      const int nb = min(a.batch, nrows - b0);
      if (!last) stage_req<RM>(s_req, a.req + (size_t)(row0 + b0) * r, nb, r);
      // Tile statistics and the local merge: a warp a row.
      for (int ib = warp; ib < nb; ib += LP_WARPS) {
        const int i = b0 + ib, row = row0 + i;
        float* e = s_e + (size_t)ib * w;
        for (int k = 0; k < d; ++k) {
          float m, s;
          int am;
          // Separate calls, so each reads its own memory space directly.
          if (i < l_rows)
            row_segment(s_l + (size_t)i * w + k * n, s_lv + k * n, e + k * n, n, lane, m, s, am);
          else
            row_segment(a.logits[k] + (size_t)row * n, s_lv + k * n, e + k * n, n, lane, m, s,
                        am);
          if (lane == 0) {
            s_m[ib * d + k] = m;
            s_s[ib * d + k] = s;
            s_am[ib * d + k] = am + k * n;
          }
        }
        __syncwarp();
        if (lane == 0) {
          float m = s_m[ib * d];
          int star = 0;
          for (int k = 1; k < d; ++k) {
            if (s_m[ib * d + k] > m) {
              m = s_m[ib * d + k];
              star = k;
            }
          }
          float s = 0.0f;
          for (int k = 0; k < d; ++k)
            s = __fadd_rn(s, __fmul_rn(s_s[ib * d + k], expf(__fsub_rn(s_m[ib * d + k], m))));
          const float mass = m > LP_MASS_FLOOR ? 1.0f : 0.0f;
          for (int k = 0; k < d; ++k)
            s_coef[ib * d + k] = __fdiv_rn(__fmul_rn(expf(__fsub_rn(s_m[ib * d + k], m)), mass), s);
          if (last) a.pref[row] = s_am[ib * d + star];
        }
      }
      __syncthreads();
      TICK(0);
      if (!last) {
        // The batch's rows into each node's running load, ascending rows;
        // two nodes a thread at once (independent chains).
        for (int g = tid; g < w; g += 2 * LP_THREADS) {
          const int g2 = g + LP_THREADS;
          const bool two = g2 < w;
          const int k = g / n, k2 = two ? g2 / n : k;
          double acc[RM], acc2[RM];
#pragma unroll
          for (int c = 0; c < RM; ++c) {
            acc[c] = (c < r && b0 > 0) ? s_acc[c * w + g] : 0.0;
            acc2[c] = (c < r && b0 > 0 && two) ? s_acc[c * w + g2] : 0.0;
          }
#pragma unroll 4
          for (int ib = 0; ib < nb; ++ib) {
            load_row<RM>(acc, s_e[(size_t)ib * w + g], s_coef[ib * d + k], s_req + ib * RM);
            if (two)
              load_row<RM>(acc2, s_e[(size_t)ib * w + g2], s_coef[ib * d + k2], s_req + ib * RM);
          }
#pragma unroll
          for (int c = 0; c < RM; ++c) {
            if (c < r) s_acc[c * w + g] = acc[c];
            if (c < r && two) s_acc[c * w + g2] = acc2[c];
          }
        }
      } else {
        for (int ib = 0; ib < nb; ++ib) {
          const int row = row0 + b0 + ib;
          for (int g = tid; g < w; g += LP_THREADS) {
            const int k = g / n, jj = g - k * n;
            a.x[k][(size_t)row * n + jj] = __fmul_rn(s_e[(size_t)ib * w + g], s_coef[ib * d + k]);
          }
        }
      }
      __syncthreads();
      TICK(2);
    }
    if (last) break;
    for (int idx = tid; idx < r * w; idx += LP_THREADS) {
      const int c = idx / w, g = idx - c * w;
      a.partial[((size_t)cta * r + c) * w + g] = s_acc[idx];
    }
    TICK(2);
    grid_sync(a.state, target, a.ctas);
    TICK(4);
    float amax = project(a, p0, p1, (double*)s_e, s_lv + p0, a.log_v + p0);
    amax = warp_max(amax);
    if (lane == 0) atomicMax(a.state + 2 + it, __float_as_uint(amax));
    TICK(3);
    grid_sync(a.state, target, a.ctas);
    TICK(4);
  }
  if (cta == 0 && warp == 0) finish(a, lane);
#ifdef LP_PHASE_CLOCKS
  if (clk_on) {
    const unsigned long long ns1 = global_ns();
    for (int k = 0; k < LP_PHASES; ++k) a.clocks[k] = ph[k];
    a.clocks[LP_PHASES] = clock64() - clk0;
    a.clocks[LP_PHASES + 1] = (long long)(ns1 - ns0);
  }
#endif
}

// ---------------------------------------------------------------------------
// tiles mode: CTA c owns row tile c / NT and node tile c % NT (NT = d *
// node_tiles; tile t is block t / node_tiles, nodes [(t % node_tiles) * tn,
// ...) of it).
template <int RM>
__global__ void __launch_bounds__(LP_THREADS, 1) lp_tiles_kernel(const LpArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cta = blockIdx.x;
  const int n = a.n, r = a.r, tn = a.tn, wtot = a.d * n;
  const int nt = a.d * a.node_tiles;
  const int rt = cta / nt, t = cta - rt * nt;
  const int k = t / a.node_tiles, j0 = (t - k * a.node_tiles) * tn;
  const int nw = min(tn, n - j0);
  const int g0 = k * n + j0;
  const int row0 = rt * a.tr;
  const int nrows = min(a.tr, a.rows - row0);
  float* s_lv = smem + a.off_lv;     // [tn]
  float* s_e = smem + a.off_e;       // [e_rows, tn]; the projection's stage
  float* s_mt = smem + a.off_stat;   // [tr] this tile's row maxima
  float* s_coef = s_mt + a.tr;       // [tr]
  float* s_term = s_coef + a.tr;     // [WARPS, nt]
  double* s_req = (double*)(smem + a.off_req);  // [tr, RM]
  float* s_l = smem + a.off_l;       // [l_rows, tn]
  const float* logits = a.logits[k];
  const int l_rows = min(a.l_rows, nrows);
  float* spill = a.spill + (size_t)cta * (a.tr - a.e_rows) * tn;
  unsigned int target = 0;
#ifdef LP_PHASE_CLOCKS
  const bool clk_on = cta == 0 && tid == 0 && a.clocks != nullptr;
  long long ph[LP_PHASES] = {0, 0, 0, 0, 0, 0};
  const long long clk0 = clock64();
  long long ph_at = clk0;
  const unsigned long long ns0 = global_ns();
#endif

  for (int idx = tid; idx < l_rows * tn; idx += LP_THREADS) {
    const int i = idx / tn, j = idx - i * tn;
    if (j < nw) s_l[idx] = logits[(size_t)(row0 + i) * n + j0 + j];
  }
  for (int j = tid; j < tn; j += LP_THREADS) s_lv[j] = 0.0f;
  stage_req<RM>(s_req, a.req + (size_t)row0 * r, nrows, r);
  __syncthreads();

  for (int it = 0; it < a.iters; ++it) {
    const bool last = it == a.iters - 1;
    // Tile statistics: a warp a row.
    for (int i = warp; i < nrows; i += LP_WARPS) {
      const int row = row0 + i;
      const float* gl = logits + (size_t)row * n + j0;
      float m, s;
      int am;
      // Separate calls, so each reads and writes its own memory space directly.
      if (i < a.e_rows) {
        float* e = s_e + (size_t)i * tn;
        if (i < l_rows)
          row_segment(s_l + (size_t)i * tn, s_lv, e, nw, lane, m, s, am);
        else
          row_segment(gl, s_lv, e, nw, lane, m, s, am);
      } else {
        float* e = spill + (size_t)(i - a.e_rows) * tn;
        if (i < l_rows)
          row_segment(s_l + (size_t)i * tn, s_lv, e, nw, lane, m, s, am);
        else
          row_segment(gl, s_lv, e, nw, lane, m, s, am);
      }
      if (lane == 0) {
        s_mt[i] = m;
        a.stat_m[(size_t)row * nt + t] = m;
        a.stat_s[(size_t)row * nt + t] = s;
        a.stat_a[(size_t)row * nt + t] = g0 + am;
      }
    }
    TICK(0);
    grid_sync(a.state, target, a.ctas);
    TICK(4);
    // The row merge over the tiles in tile order: a warp a row.
    for (int i = warp; i < nrows; i += LP_WARPS) {
      const int row = row0 + i;
      const float* sm = a.stat_m + (size_t)row * nt;
      const float* ss = a.stat_s + (size_t)row * nt;
      float m = -INFINITY;
      int pr = INT_MAX;
      for (int u = lane; u < nt; u += 32) {
        const float v = __ldcg(sm + u);
        const int ai = __ldcg(a.stat_a + (size_t)row * nt + u);
        if (v > m || (v == m && ai < pr)) {
          m = v;
          pr = ai;
        }
      }
      warp_argmax(m, pr);
      float* term = s_term + warp * nt;
      for (int u = lane; u < nt; u += 32)
        term[u] = __fmul_rn(__ldcg(ss + u), expf(__fsub_rn(__ldcg(sm + u), m)));
      __syncwarp();
      if (lane == 0) {
        float s = 0.0f;
        for (int u = 0; u < nt; ++u) s = __fadd_rn(s, term[u]);
        const float mass = m > LP_MASS_FLOOR ? 1.0f : 0.0f;
        s_coef[i] = __fdiv_rn(__fmul_rn(expf(__fsub_rn(s_mt[i], m)), mass), s);
        if (last && t == 0) a.pref[row] = pr;
      }
      __syncwarp();
    }
    __syncthreads();
    TICK(1);
    if (!last) {
      // The tile's load partials, ascending rows: a thread a node.
      for (int j = tid; j < nw; j += LP_THREADS) {
        double acc[RM];
#pragma unroll
        for (int c = 0; c < RM; ++c) acc[c] = 0.0;
        const int on = min(nrows, a.e_rows);
#pragma unroll 4
        for (int i = 0; i < on; ++i)
          load_row<RM>(acc, s_e[(size_t)i * tn + j], s_coef[i], s_req + i * RM);
        for (int i = on; i < nrows; ++i)
          load_row<RM>(acc, spill[(size_t)(i - a.e_rows) * tn + j], s_coef[i], s_req + i * RM);
#pragma unroll
        for (int c = 0; c < RM; ++c)
          if (c < r) a.partial[((size_t)rt * r + c) * wtot + g0 + j] = acc[c];
      }
    } else {
      for (int i = 0; i < nrows; ++i) {
        const size_t row = (size_t)(row0 + i);
        const float* e = i < a.e_rows ? s_e + (size_t)i * tn : spill + (size_t)(i - a.e_rows) * tn;
        for (int j = tid; j < nw; j += LP_THREADS)
          a.x[k][row * n + j0 + j] = __fmul_rn(e[j], s_coef[i]);
      }
    }
    TICK(2);
    if (last) break;
    grid_sync(a.state, target, a.ctas);
    TICK(4);
    // Every CTA of this node tile projects it: log_v stays on chip.
    float amax = project(a, g0, g0 + nw, (double*)s_e, s_lv, s_lv);
    amax = warp_max(amax);
    if (lane == 0) atomicMax(a.state + 2 + it, __float_as_uint(amax));
    __syncthreads();
    TICK(3);
  }
  if (cta == 0 && warp == 0) finish(a, lane);
#ifdef LP_PHASE_CLOCKS
  if (clk_on) {
    const unsigned long long ns1 = global_ns();
    for (int q = 0; q < LP_PHASES; ++q) a.clocks[q] = ph[q];
    a.clocks[LP_PHASES] = clock64() - clk0;
    a.clocks[LP_PHASES + 1] = (long long)(ns1 - ns0);
  }
#endif
}

template <int RM>
static int launch_rm(const LpArgs* a, cudaStream_t stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  const int nt = a->d * a->node_tiles;
  const bool tiles = a->mode == LP_MODE_TILES;
  if (a->rows < 1 || a->n < 1 || a->r < 1 || a->r > LP_MAX_COLS || a->d < 1 ||
      a->d > LP_MAX_BLOCKS || a->iters < 1)
    return (int)cudaErrorInvalidValue;
  if ((a->mode != LP_MODE_ROWS && !tiles) || a->tr < 1 || a->batch < 1 || a->stage_nodes < 1 ||
      a->row_tiles != (a->rows + a->tr - 1) / a->tr || a->smem_bytes > LP_SMEM_LIMIT ||
      a->ctas != a->row_tiles * (tiles ? nt : 1) ||
      (tiles && (a->tn < 1 || a->node_tiles != (a->n + a->tn - 1) / a->tn)))
    return LP_ERR_PLAN;
  const void* kernel =
      tiles ? (const void*)lp_tiles_kernel<RM> : (const void*)lp_rows_kernel<RM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, LP_THREADS,
                                                      (size_t)a->smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if ((long long)per_sm * sms < a->ctas) return LP_ERR_NOT_RESIDENT;
  err = cudaMemsetAsync(a->state, 0, sizeof(unsigned int) * (size_t)(2 + a->iters), stream);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  config.gridDim = dim3(a->ctas, 1, 1);
  config.blockDim = dim3(LP_THREADS, 1, 1);
  config.dynamicSmemBytes = a->smem_bytes;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  err = tiles ? cudaLaunchKernelEx(&config, lp_tiles_kernel<RM>, *a)
              : cudaLaunchKernelEx(&config, lp_rows_kernel<RM>, *a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

static int launch(const LpArgs* a, cudaStream_t stream) {
  if (a->r <= 2) return launch_rm<2>(a, stream);
  if (a->r <= 4) return launch_rm<4>(a, stream);
  if (a->r <= 8) return launch_rm<8>(a, stream);
  return launch_rm<16>(a, stream);
}

// One device: d must be 1.
extern "C" int lp_relax_launch(const LpArgs* args, void* stream) {
  if (args->d != 1) return (int)cudaErrorInvalidValue;
  return launch(args, (cudaStream_t)stream);
}

// D node blocks on one device (block k's first global node is k * n).
extern "C" int lp_relax_blocks_launch(const LpArgs* args, void* stream) {
  return launch(args, (cudaStream_t)stream);
}
