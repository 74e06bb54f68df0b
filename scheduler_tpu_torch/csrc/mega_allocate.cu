// mega_allocate: the whole greedy allocate action in one kernel launch.
//
// Replaces scheduler_tpu/ops/megakernel.py::mega_allocate (a Pallas TPU
// kernel) in CURSOR MODE: one queue, jobs in init-key order, no releasing
// capacity, no static [T, N] rows.  The plain PyTorch version of the same
// function is scheduler_tpu_torch/ops/megakernel.py::mega_allocate_reference;
// the two must agree bit for bit on codes and stats.
//
// What bounds it on this card: the loop is a dependent chain of about
// STATS.STEPS steps, and every step needs block-wide reductions over the
// node axis (fit, score, masked argmax) and over the job lanes — per-step
// barrier latency, not bytes or FLOPs.  The design keeps it simple and
// right: ONE persistent block of 1024 threads runs the whole loop, with
// __syncthreads() between the phases of a step.  The node ledger (16 rows
// x nb floats, 1 MiB at nb = 16384) lives in a global scratch buffer that
// stays in L2; the job ledger lives in shared memory when it fits (else in
// global scratch).  Loop scalars are replicated in every thread's registers
// and advance identically from block-reduced values.  Faster designs for a
// later change: a thread-block cluster with the node ledger in distributed
// shared memory, or a cooperative grid over the node axis.
//
// Bitwise parity with the float32 reference rests on: no FMA contraction
// (built with --fmad=false), IEEE division (-prec-div=true, the default),
// every expression evaluated in the reference's operation order, and
// lowest-index tie breaking in every argmax / argmin.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC -o libmega.so mega_allocate.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 1024
#define WARPS (THREADS / 32)
#define MAX_BATCH 128
#define BIG_I32 2147483647
#define UNPLACED (-1)
#define FAILED (-2)
#define HALT (-100)

// Row layouts (scheduler_tpu_torch/ops/layout.py).
#define NROW_IDLE 0
#define NROW_TASK_COUNT 8
#define NROW_ROWS 16
#define JROW_CONSUMED 0
#define JROW_ALLOCATED 1
#define JROW_LEFT 2
#define JROW_DRF 8
#define SIG_REQ_REQ 0
#define SIG_REQ_INIT 8
#define STATS_WIDTH 8

#define COMP_PRIORITY 0
#define COMP_GANG 1
#define COMP_DRF 2

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
  int* out;               // [(t_rows + 1) * 128] result codes
  int* stats;             // [8] evidence counters
  float* ns;              // [16, nb] live node ledger (scratch)
  float* msk;             // [nb] masked scores of the current chunk (scratch)
  float* js_global;       // [js_rows, j_pad] job ledger when it does not fit shared memory
  int nb, s_pad, t_rows, t_cap, j_pad, js_rows, r_dim, cpu_idx, mem_idx;
  int enforce_pod_count, cross_batch, batch_runs, score_bound, cohort, n_comp;
  int smem_bytes;
  int comp[4];
  float w_lr, w_bal, w_bp;
  float mins[8];
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

// (value, index) pairs: larger value wins, the lower index on ties.
__device__ __forceinline__ void argmax_merge(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

struct Reduce {
  float v[WARPS];
  int i[WARPS];
  float out_v;
  int out_i;
};

// Block-wide argmax of per-thread (value, index) pairs; every thread gets
// the result.
__device__ void block_argmax(float& v, int& i, Reduce* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    float v2 = __shfl_down_sync(0xffffffffu, v, off);
    int i2 = __shfl_down_sync(0xffffffffu, i, off);
    argmax_merge(v, i, v2, i2);
  }
  if (lane == 0) {
    red->v[warp] = v;
    red->i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = red->v[lane];
    i = red->i[lane];
    for (int off = 16; off > 0; off >>= 1) {
      float v2 = __shfl_down_sync(0xffffffffu, v, off);
      int i2 = __shfl_down_sync(0xffffffffu, i, off);
      argmax_merge(v, i, v2, i2);
    }
    if (lane == 0) {
      red->out_v = v;
      red->out_i = i;
    }
  }
  __syncthreads();
  v = red->out_v;
  i = red->out_i;
}

// Block-wide minimum of a float; every thread gets the result.
__device__ float block_min_f(float v, Reduce* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_down_sync(0xffffffffu, v, off));
  if (lane == 0) red->v[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = red->v[lane];
    for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) red->out_v = v;
  }
  __syncthreads();
  return red->out_v;
}

__device__ int block_min_i(int v, Reduce* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_down_sync(0xffffffffu, v, off));
  if (lane == 0) red->i[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = red->i[lane];
    for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) red->out_i = v;
  }
  __syncthreads();
  return red->out_i;
}

// Comparator keys of job lane l.
__device__ __forceinline__ int key_priority(const MegaArgs& a, int l) { return -a.job_prio[l]; }

__device__ __forceinline__ int key_gang(const MegaArgs& a, const float* js, int l) {
  return (((float)a.job_gang[l] - js[JROW_ALLOCATED * a.j_pad + l]) <= 0.0f) ? 1 : 0;
}

__device__ __forceinline__ float key_drf(const MegaArgs& a, const float* js, int l) {
  // Max over all 8 rows, padding rows contributing 0 (as the reference's
  // [8, J] fraction block does).
  float key = 0.0f;
  for (int r = 0; r < 8; ++r) {
    float frac = 0.0f;
    if (r < a.r_dim && a.drf_mask[r] > 0.0f) frac = js[(JROW_DRF + r) * a.j_pad + l] / a.drf_safe[r];
    key = (r == 0) ? frac : fmaxf(key, frac);
  }
  return key;
}

// Lane l survives the base filter and every comparator before `upto`.
__device__ bool job_candidate(const MegaArgs& a, const float* js, int l, int cursor, int upto,
                              const int* thr_i, const float* thr_f) {
  const int jp = a.j_pad;
  bool cand = (js[JROW_LEFT * jp + l] == 0.0f) && (js[JROW_CONSUMED * jp + l] < (float)a.job_num[l]) &&
              (a.job_num[l] > 0) && (l <= cursor);
  for (int c = 0; c < upto && cand; ++c) {
    int comp = a.comp[c];
    if (comp == COMP_PRIORITY) cand = key_priority(a, l) == thr_i[c];
    else if (comp == COMP_GANG) cand = key_gang(a, js, l) == thr_i[c];
    else cand = key_drf(a, js, l) == thr_f[c];
  }
  return cand;
}

// The comparator chain (priority -> gang -> drf, then creation/uid rank,
// lowest lane on ties) over the job lanes <= cursor; HALT when none is left.
__device__ int chain_select(const MegaArgs& a, const float* js, int cursor, Reduce* red) {
  int thr_i[4];
  float thr_f[4];
  for (int c = 0; c < a.n_comp; ++c) {
    int comp = a.comp[c];
    if (comp == COMP_DRF) {
      float v = INFINITY;
      for (int l = threadIdx.x; l < a.j_pad; l += THREADS)
        if (job_candidate(a, js, l, cursor, c, thr_i, thr_f)) v = fminf(v, key_drf(a, js, l));
      thr_f[c] = block_min_f(v, red);
      thr_i[c] = 0;
    } else {
      int v = BIG_I32;
      for (int l = threadIdx.x; l < a.j_pad; l += THREADS)
        if (job_candidate(a, js, l, cursor, c, thr_i, thr_f))
          v = min(v, comp == COMP_PRIORITY ? key_priority(a, l) : key_gang(a, js, l));
      thr_i[c] = block_min_i(v, red);
      thr_f[c] = 0.0f;
    }
  }
  int v = BIG_I32;
  for (int l = threadIdx.x; l < a.j_pad; l += THREADS)
    if (job_candidate(a, js, l, cursor, a.n_comp, thr_i, thr_f)) v = min(v, a.job_tb[l]);
  const int low = block_min_i(v, red);
  if (low >= BIG_I32) return HALT;
  int lane = a.j_pad;
  for (int l = threadIdx.x; l < a.j_pad; l += THREADS)
    if (job_candidate(a, js, l, cursor, a.n_comp, thr_i, thr_f) && a.job_tb[l] == low) lane = min(lane, l);
  return block_min_i(lane, red);
}

__global__ void __launch_bounds__(THREADS, 1) mega_allocate_kernel(const MegaArgs a) {
  extern __shared__ float smem_js[];
  __shared__ Reduce red;
  __shared__ int sh_fit;
  float* js = a.smem_bytes > 0 ? smem_js : a.js_global;
  const int tid = threadIdx.x;
  const int nb = a.nb, jp = a.j_pad, r_dim = a.r_dim;
  const int t_pad = a.t_rows * 128;
  const int out_len = (a.t_rows + 1) * 128;
  const int cohort = a.batch_runs ? max(1, a.cohort) : 1;
  const int max_steps = a.t_cap + 8;
  const int n_real = a.misc[0];
  const float neg_inf = -INFINITY;
  float* idle = a.ns + NROW_IDLE * nb;
  float* tcount = a.ns + NROW_TASK_COUNT * nb;
  const float* a_cpu_row = a.alloc_t + a.cpu_idx * nb;
  const float* a_mem_row = a.alloc_t + a.mem_idx * nb;
  const bool any_w = a.w_lr != 0.0f || a.w_bal != 0.0f || a.w_bp != 0.0f;

  // State into scratch; result initialized to UNPLACED.
  for (int x = tid; x < NROW_ROWS * nb; x += THREADS) a.ns[x] = a.ns0[x];
  for (int x = tid; x < a.js_rows * jp; x += THREADS) {
    const int row = x / jp, l = x - row * jp;
    js[x] = row >= JROW_DRF ? a.js_drf0[(row - JROW_DRF) * jp + l] : 0.0f;
  }
  for (int x = tid; x < out_len; x += THREADS) a.out[x] = UNPLACED;
  __syncthreads();

  int cur = -1, cursor = 0, n_dirty = 0, steps = 0, coh_steps = 0, chunk_pl = 0;
  while (steps < max_steps && (cur >= 0 || (cur != HALT && (cursor < n_real || n_dirty > 0)))) {
    // ---- selection (cursor mode) ----
    int sel;
    if (cur == -1) {
      if (n_dirty > 0) sel = chain_select(a, js, cursor, &red);
      else sel = cursor < n_real ? cursor : HALT;
    } else {
      sel = cur;
    }
    const bool newly = cur == -1 && sel >= 0;
    int cursor_r = cursor + ((newly && sel == cursor) ? 1 : 0);
    int dirty_r = n_dirty - ((newly && sel != cursor) ? 1 : 0);
    int cur_r = sel;

    int jb = min(max(sel, 0), jp - 1);
    float cons_c = js[JROW_CONSUMED * jp + jb];
    float nalloc_c = js[JROW_ALLOCATED * jp + jb];
    const int num_v = a.job_num[jb];
    const int deficit_v = a.job_def[jb];
    int t_c = min(max(a.job_off[jb] + (int)cons_c, 0), t_pad - 1);
    const int sig = a.task_sig[t_c];
    int rl_c = a.run_len[t_c];
    float reqs[8], initqs[8];
    for (int r = 0; r < 8; ++r) {
      reqs[r] = r < r_dim ? a.sig_req[(SIG_REQ_REQ + r) * a.s_pad + sig] : 0.0f;
      initqs[r] = r < r_dim ? a.sig_req[(SIG_REQ_INIT + r) * a.s_pad + sig] : 0.0f;
    }
    const bool single0 = num_v == 1;
    bool act = sel >= 0;

    // ---- cohort chunks ----
    for (int c = 0; c < cohort && act; ++c) {
      // fit + score + masked argmax over every node
      float bv = neg_inf;
      int bi = BIG_I32;
      for (int n = tid; n < nb; n += THREADS) {
        bool feas = a.gate[n] != 0;
        for (int r = 0; r < r_dim; ++r) {
          const float id = idle[r * nb + n];
          feas = feas && ((initqs[r] < id) || (fabsf(id - initqs[r]) < a.mins[r]));
        }
        if (a.enforce_pod_count) feas = feas && (tcount[n] < a.plim[n]);
        float score = 0.0f;
        if (any_w) {
          const float ac = a_cpu_row[n], am = a_mem_row[n];
          const float sc = ac > 0.0f ? ac : 1.0f, sm = am > 0.0f ? am : 1.0f;
          const float req_c = (ac - idle[a.cpu_idx * nb + n]) + reqs[a.cpu_idx];
          const float req_m = (am - idle[a.mem_idx * nb + n]) + reqs[a.mem_idx];
          score = score_terms(a, ac, am, sc, sm, req_c, req_m);
        }
        const float masked = feas ? score : neg_inf;
        a.msk[n] = masked;
        argmax_merge(bv, bi, masked, n);
      }
      block_argmax(bv, bi, &red);
      const int best = min(bi, nb - 1);
      const bool alloc_here = bv > neg_inf;
      const bool failed = !alloc_here;

      // run batching on the winner (top-2 score bound unless binpack-only)
      int m = 1;
      if (a.batch_runs && alloc_here) {
        float second = neg_inf;
        int second_idx = BIG_I32;
        if (a.score_bound) {
          for (int n = tid; n < nb; n += THREADS) argmax_merge(second, second_idx, n == best ? neg_inf : a.msk[n], n);
          block_argmax(second, second_idx, &red);
        }
        int room = deficit_v > 0 ? deficit_v - (int)nalloc_c : 1;
        if (a.cross_batch && single0 && dirty_r == 0) room = MAX_BATCH;
        int hi0 = min(min(rl_c, MAX_BATCH), room);
        if (a.enforce_pod_count) hi0 = min(hi0, (int)(a.plim[best] - tcount[best]));
        hi0 = max(hi0, 1);
        if (tid < 32) {
          // One warp: lane handles k = lane + 1 + 32 q of the 128-wide grid.
          bool ok[4];
          int first_false = MAX_BATCH + 1;
          for (int q = 0; q < 4; ++q) {
            const int k = tid + 1 + 32 * q;
            const float jm1 = (float)(k - 1);
            bool okk = true;
            for (int r = 0; r < r_dim; ++r) {
              const float avail = idle[r * nb + best] - jm1 * reqs[r];
              okk = okk && ((initqs[r] < avail) || (fabsf(avail - initqs[r]) < a.mins[r]));
            }
            ok[q] = okk;
            if (a.score_bound) {
              const float ac = a_cpu_row[best], am = a_mem_row[best];
              const float avail_c = idle[a.cpu_idx * nb + best] - jm1 * reqs[a.cpu_idx];
              const float avail_m = idle[a.mem_idx * nb + best] - jm1 * reqs[a.mem_idx];
              const float sc = ac > 0.0f ? ac : 1.0f, sm = am > 0.0f ? am : 1.0f;
              const float reqd_c = (ac - avail_c) + reqs[a.cpu_idx];
              const float reqd_m = (am - avail_m) + reqs[a.mem_idx];
              const float s_js = score_terms(a, ac, am, sc, sm, reqd_c, reqd_m);
              const bool ok_s = (s_js > second) || ((s_js == second) && (best < second_idx));
              if (!ok_s) first_false = min(first_false, k);
            }
          }
          for (int off = 16; off > 0; off >>= 1)
            first_false = min(first_false, __shfl_xor_sync(0xffffffffu, first_false, off));
          int fit = 1;
          for (int q = 0; q < 4; ++q) {
            const int k = tid + 1 + 32 * q;
            if (ok[q] && k < first_false && k <= hi0) fit = max(fit, k);
          }
          for (int off = 16; off > 0; off >>= 1) fit = max(fit, __shfl_xor_sync(0xffffffffu, fit, off));
          if (tid == 0) sh_fit = fit;
        }
        __syncthreads();
        m = sh_fit;
      }
      const bool cross_active = a.cross_batch && single0 && alloc_here;
      const int consumed = alloc_here ? m : (failed ? 1 : 0);
      const float m_alloc = alloc_here ? (float)m : 0.0f;

      // node ledger: the winner's column
      if (tid == 0 && alloc_here) {
        for (int r = 0; r < r_dim; ++r) idle[r * nb + best] = idle[r * nb + best] - reqs[r] * m_alloc;
        tcount[best] = tcount[best] + m_alloc;
      }
      // job ledger: one lane, or the window of a cross-job batch
      const int k = cross_active ? m : 1;
      if (tid < k && jb + tid < jp) {
        const int l = jb + tid;
        const float drf_scale = cross_active ? 1.0f : m_alloc;
        js[JROW_CONSUMED * jp + l] = js[JROW_CONSUMED * jp + l] + (cross_active ? 1.0f : (float)consumed);
        js[JROW_ALLOCATED * jp + l] = js[JROW_ALLOCATED * jp + l] + (cross_active ? 1.0f : m_alloc);
        js[JROW_LEFT * jp + l] = js[JROW_LEFT * jp + l] + (cross_active ? 0.0f : (failed ? 1.0f : 0.0f));
        for (int r = 0; r < r_dim; ++r)
          js[(JROW_DRF + r) * jp + l] = js[(JROW_DRF + r) * jp + l] + reqs[r] * drf_scale;
      }
      // result codes of the consumed tasks
      const int code = alloc_here ? best : FAILED;
      if (tid < consumed && t_c + tid < out_len) a.out[t_c + tid] = code;

      // pop end / running scalars
      const float row_after_alloc = nalloc_c + (cross_active ? 1.0f : m_alloc);
      const bool became_ready = alloc_here && (row_after_alloc >= (float)deficit_v);
      const float cons_after = cons_c + (cross_active ? 1.0f : (float)consumed);
      const bool drained = cons_after >= (float)num_v;
      const bool end_pop = failed || became_ready || drained;
      cur_r = end_pop ? -1 : jb;
      dirty_r += (became_ready && !drained) ? 1 : 0;
      if (a.cross_batch) cursor_r += (cross_active ? m - 1 : 0) + ((c > 0 && single0) ? 1 : 0);
      if (c >= 1 && alloc_here) chunk_pl += m;
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
      __syncthreads();
    }
    cur = cur_r;
    cursor = cursor_r;
    n_dirty = dirty_r;
    steps += 1;
  }
  if (tid == 0) {
    a.stats[0] = steps;
    a.stats[1] = coh_steps;
    a.stats[2] = chunk_pl;
    for (int x = 3; x < STATS_WIDTH; ++x) a.stats[x] = 0;
  }
}

extern "C" int mega_allocate_launch(const MegaArgs* args, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (args->smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(mega_allocate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           args->smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  mega_allocate_kernel<<<1, THREADS, args->smem_bytes, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
