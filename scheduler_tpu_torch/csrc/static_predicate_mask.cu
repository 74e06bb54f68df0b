// static_predicate_mask: the predicates plugin's selector / taint / gate mask.
//
// Replaces scheduler_tpu/ops/pallas_kernels.py::static_predicate_mask (a
// Pallas TPU kernel: f32 MXU products of 0/1 operands in 128x128 tiles).  The
// plain PyTorch version of the same function is
// scheduler_tpu_torch/ops/predicate_kernel.py::static_predicate_mask_reference;
// the two must agree exactly (a bool mask).
//
//   mask[s, n] = (sum_l sel[s,l] * !labels[n,l] + sum_k !tol[s,k] * taints[n,k]) == 0
//                & !unknown[s] & !unsched[n]
//
// Every operand is 0/1, and only whether the sum is zero matters, so the
// contraction is a bitwise one: with the vocabulary packed 32 entries a
// word, a cell is violated iff OR_w (a[s][w] & b[n][w]) != 0, where over the
// label words a = sel and b = !labels, and over the taint words a = !tol and
// b = taints.  One LOP3 a word and output cell.  Padding entries (past L in
// the last label word, past K in the last taint word) are staged as 0 bytes,
// so sel = 0 there (label words) and taints = 0 there (taint words): one side
// of every padding bit is 0 whatever the other holds after the negation.
//
// Packing happens in the kernel, from the bool tensors the plugin builds:
// a thread reads the 32 bytes of one (row, word) pair (two 16-byte loads when
// rows are 16-byte aligned, eight 4-byte loads when 4-byte aligned, else
// bytes) and folds them into one word: byte k of 4-byte group j goes to bit
// 8k + j.  That order permutes the 32 entries of a word, identically on
// both sides, so the AND / OR over the word is unchanged.
//
// What bounds it on this card: at the wide shape (4,096 signatures x 10,000
// nodes, L 512, K 16) the function needs about 48 MB of bytes (mostly the
// 41 MB mask it writes, 0.015 ms at the memory rate) and 2*S*N*(L+K) = 43 G
// operations of 0/1 products (0.022 ms at the int8 tensor-core rate); the
// packed form does 17 LOP3 a cell, 0.70 G, about 0.05 ms at the 64 logic
// operations a clock of an SM, and each block packs its rows from L2 again.
// At the signature width that config 2 calls it with (3 signatures x 1,000
// nodes, L 1,004, K 0) it is a launch and the latency of its loads.
//
// Design, two kernels behind one entry point:
// * Many signatures (S > 8): one block of 256 threads a 64-signature x
//   128-node output tile; each thread holds a 4 x 8 register tile of
//   accumulators (4 signatures; nodes 4tx..4tx+3 and 64+4tx..64+4tx+3, so
//   a warp's 16-byte shared loads are conflict-free and its 4-byte stores
//   coalesce).  The packed words are staged in chunks of 32 words (1,024
//   vocabulary entries), word-major in shared memory ([word][row], rows
//   fastest, so the stores are conflict-free): the wide shape takes one
//   chunk.
// * Few signatures (S <= 8, the plugin's usual case): one warp a node,
//   lane w on word w of a chunk: 125 blocks of 8 nodes at config 2, where
//   the tiled kernel would put 8 blocks on 8 SMs and make each thread pack
//   16 words one after another.  The signatures' words of a chunk are
//   staged once a block; each lane packs its own node word, ANDs it with
//   every signature's word, and the warp ORs its lanes (__reduce_or_sync).
//
// Build: with the port's other kernels, by scheduler_tpu_torch/ops/cuda_build.py.

#include <cuda_runtime.h>
#include <stdint.h>

#define TS 64        // signatures a block
#define TN 128       // nodes a block
#define CW 32        // packed words a staged chunk
#define THREADS 256
#define NARROW_S 8   // at most this many signatures: the narrow kernel

// The 32 entries [0, valid) of a row at p (valid <= 32; 0 past it) as
// eight 4-byte words, one entry a byte.  vec is the row's alignment in
// bytes (16, 4 or 1).
__device__ __forceinline__ void load32(const uint8_t* __restrict__ p, int valid, int vec,
                                       uint32_t w[8]) {
  if (valid >= 32 && vec == 16) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else if (valid >= 32 && vec == 4) {
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = __ldg(reinterpret_cast<const uint32_t*>(p) + j);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = 4 * j + k;
        if (e < valid && __ldg(p + e) != 0) v |= 1u << (8 * k);
      }
      w[j] = v;
    }
  }
}

// Eight words of 0/1 bytes folded into one: byte k of word j -> bit 8k + j.
__device__ __forceinline__ uint32_t fold32(const uint32_t w[8]) {
  uint32_t x = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) x |= (w[j] & 0x01010101u) << j;
  return x;
}

// One side of the contraction: its label matrix and taint matrix ([rows,
// L] and [rows, K] bytes) and what each vocabulary's packed words are XORed
// with (~0 negates).
struct Side {
  const uint8_t* lab;
  const uint8_t* tnt;
  uint32_t lab_flip;
  uint32_t tnt_flip;
};

struct Vocab {
  int L, K, wl;      // entries, and label words (ceil(L / 32))
  int vec_l, vec_k;  // row alignment of each vocabulary's matrices (16, 4 or 1)
};

// Packed word g of the concatenated vocabulary (label words, then taint
// words) of one row of one side.
__device__ __forceinline__ uint32_t side_word(const Side& sd, const Vocab& v, int row, int g) {
  uint32_t w[8];
  if (g < v.wl) {
    load32(sd.lab + (size_t)row * v.L + 32 * g, v.L - 32 * g, v.vec_l, w);
    return fold32(w) ^ sd.lab_flip;
  }
  const int k = g - v.wl;
  load32(sd.tnt + (size_t)row * v.K + 32 * k, v.K - 32 * k, v.vec_k, w);
  return fold32(w) ^ sd.tnt_flip;
}

__global__ void __launch_bounds__(THREADS)
    static_predicate_mask_kernel(const Side sig, const Side node, const Vocab v,
                                 const uint8_t* __restrict__ unknown,
                                 const uint8_t* __restrict__ unsched, uint8_t* __restrict__ out,
                                 int S, int N) {
  __shared__ __align__(16) uint32_t a_s[CW][TS];  // signature side, [word][signature]
  __shared__ __align__(16) uint32_t b_s[CW][TN];  // node side, [word][node]
  const int s0 = blockIdx.y * TS, n0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // nodes 4tx.. and 64+4tx..; signatures 4ty..
  const int words = v.wl + ((v.K + 31) >> 5);

  uint32_t acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0u;

  for (int g0 = 0; g0 < words; g0 += CW) {
    const int cw = min(CW, words - g0);
    if (g0 > 0) __syncthreads();  // the last chunk's words are read
    // Rows vary fastest, so the shared stores are conflict-free; 0 past S / N.
    for (int idx = tid; idx < cw * TS; idx += THREADS) {
      const int r = idx % TS, s = s0 + r;
      a_s[idx / TS][r] = s < S ? side_word(sig, v, s, g0 + idx / TS) : 0u;
    }
    for (int idx = tid; idx < cw * TN; idx += THREADS) {
      const int r = idx % TN, n = n0 + r;
      b_s[idx / TN][r] = n < N ? side_word(node, v, n, g0 + idx / TN) : 0u;
    }
    __syncthreads();
#pragma unroll 4
    for (int w = 0; w < cw; ++w) {
      const uint4 a = *reinterpret_cast<const uint4*>(&a_s[w][4 * ty]);
      const uint4 b0 = *reinterpret_cast<const uint4*>(&b_s[w][4 * tx]);
      const uint4 b1 = *reinterpret_cast<const uint4*>(&b_s[w][64 + 4 * tx]);
      const uint32_t av[4] = {a.x, a.y, a.z, a.w};
      const uint32_t bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] |= av[i] & bv[j];
    }
  }

  // Gates and stores: two groups of 4 consecutive nodes a signature row.
  bool node_ok[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
    node_ok[j] = n < N && !unsched[n];
  }
  const bool vec_out = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + 4 * ty + i;
    if (s >= S) break;
    const bool sig_ok = !unknown[s];
    uint8_t* row = out + (size_t)s * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nb = n0 + 64 * h + 4 * tx;
      if (nb >= N) continue;
      uint32_t bytes = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * h + k;
        if (sig_ok && node_ok[j] && acc[i][j] == 0u) bytes |= 1u << (8 * k);
      }
      if (vec_out && nb + 4 <= N) {
        *reinterpret_cast<uint32_t*>(row + nb) = bytes;
      } else {
        for (int k = 0; k < 4 && nb + k < N; ++k) row[nb + k] = (uint8_t)((bytes >> (8 * k)) & 1u);
      }
    }
  }
}

// Few signatures (S <= NARROW_S, as the plugin's signature rows usually
// are): one warp a node, lane w on word g0 + w.  The signatures' words of a
// chunk are staged once a block; each lane packs its node word itself (its
// loads issued before the barrier), ANDs it with every signature's word,
// and the warp ORs its lanes together (__reduce_or_sync).
__global__ void __launch_bounds__(THREADS)
    static_predicate_mask_narrow(const Side sig, const Side node, const Vocab v,
                                 const uint8_t* __restrict__ unknown,
                                 const uint8_t* __restrict__ unsched, uint8_t* __restrict__ out,
                                 int S, int N) {
  __shared__ uint32_t a_s[NARROW_S][CW];  // [signature][word]
  const int tid = threadIdx.x, lane = tid & 31;
  const int n = blockIdx.x * (THREADS / 32) + (tid >> 5);
  const int words = v.wl + ((v.K + 31) >> 5);
  uint32_t acc[NARROW_S];
#pragma unroll
  for (int s = 0; s < NARROW_S; ++s) acc[s] = 0u;
  for (int g0 = 0; g0 < words; g0 += CW) {
    const int cw = min(CW, words - g0);
    if (g0 > 0) __syncthreads();  // the last chunk's words are read
    for (int idx = tid; idx < S * cw; idx += THREADS)
      a_s[idx / cw][idx % cw] = side_word(sig, v, idx / cw, g0 + idx % cw);
    const uint32_t b = n < N && lane < cw ? side_word(node, v, n, g0 + lane) : 0u;
    __syncthreads();
#pragma unroll
    for (int s = 0; s < NARROW_S; ++s)
      if (s < S && lane < cw) acc[s] |= a_s[s][lane] & b;
  }
  const bool node_ok = n < N && !unsched[n];
#pragma unroll
  for (int s = 0; s < NARROW_S; ++s) {
    if (s >= S) break;
    const uint32_t any = __reduce_or_sync(0xffffffffu, acc[s]);
    if (lane == s && n < N) out[(size_t)s * N + n] = node_ok && any == 0u && !unknown[s];
  }
}

// The row alignment of a [rows, len] byte matrix at p: 16, 4 or 1.
static int row_vec(const void* p, int len) {
  const uintptr_t a = (uintptr_t)p;
  if (len % 16 == 0 && a % 16 == 0) return 16;
  if (len % 4 == 0 && a % 4 == 0) return 4;
  return 1;
}

extern "C" int static_predicate_mask_launch(const void* sel, const void* unknown, const void* labels,
                                            const void* unsched, const void* taints,
                                            const void* tolerated, void* out, int S, int N, int L,
                                            int K, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  // Both matrices of a vocabulary must share the alignment class used.
  const int vl_a = row_vec(sel, L), vl_b = row_vec(labels, L);
  const int vk_a = row_vec(taints, K), vk_b = row_vec(tolerated, K);
  const int vec_l = vl_a < vl_b ? vl_a : vl_b, vec_k = vk_a < vk_b ? vk_a : vk_b;
  const Vocab v = {L, K, (L + 31) >> 5, vec_l, vec_k};
  // Signature side: sel, and !tol.  Node side: !labels, and taints.
  const Side sig = {(const uint8_t*)sel, (const uint8_t*)tolerated, 0u, ~0u};
  const Side node = {(const uint8_t*)labels, (const uint8_t*)taints, ~0u, 0u};
  cudaStream_t s = (cudaStream_t)stream;
  if (S <= NARROW_S) {
    static_predicate_mask_narrow<<<(N + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, s>>>(
        sig, node, v, (const uint8_t*)unknown, (const uint8_t*)unsched, (uint8_t*)out, S, N);
  } else {
    const dim3 grid((N + TN - 1) / TN, (S + TS - 1) / TS);
    static_predicate_mask_kernel<<<grid, THREADS, 0, s>>>(
        sig, node, v, (const uint8_t*)unknown, (const uint8_t*)unsched, (uint8_t*)out, S, N);
  }
  return (int)cudaGetLastError();
}
