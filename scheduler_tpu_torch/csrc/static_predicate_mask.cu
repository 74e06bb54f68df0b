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
// Every operand is 0/1 (torch bool, one byte each), so the counts are
// integers: one 32-bit word holds four vocabulary entries, and
// __popc(a & ~b) counts the violations of four entries at once (a byte is
// 0x01 or 0x00, so a & ~b is 0x01 exactly where a = 1 and b = 0).  Padding
// bytes are 0 on the selector / taint side and contribute nothing.
//
// What bounds it on this card: at the signature width the plugin calls it
// with (a few signatures x every node, a vocabulary of one label per node
// plus the zones) it reads and writes a few MB at most, so bytes bound it and
// the launch dominates.  At wide shapes (thousands of signatures x 10k nodes
// x hundreds of vocabulary entries) it is bound by integer operations.  The
// design is simple: one block of 32 x 32 threads per 32 x 32 output tile;
// the tile's selector / toleration rows and label / taint rows are staged in
// shared memory in chunks of 64 vocabulary entries (rows padded to 17 words,
// so that a warp's 32 node rows fall in 32 banks); each thread counts the
// violations of its (s, n) cell and writes one byte.  A later redesign: rows
// bit-packed on the host (64 entries a word, __popcll), or int8 mma.sync /
// wgmma on the 0/1 operands with int32 accumulation.
//
// Build: with the port's other kernels, by scheduler_tpu_torch/ops/cuda_build.py.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 32
#define CHUNK 64                 // vocabulary entries staged per pass
#define WORDS (CHUNK / 4)        // 32-bit words per staged row
#define ROW_WORDS (WORDS + 1)    // padded: conflict-free column reads

// Stage rows [r0, r0 + TILE) x entries [c0, c0 + CHUNK) of a row-major
// [rows, cols] byte matrix into tile[TILE][ROW_WORDS]; 0 outside the matrix.
__device__ __forceinline__ void stage(uint32_t (*tile)[ROW_WORDS], const uint8_t* src, int rows,
                                      int cols, int r0, int c0) {
  uint8_t* bytes = reinterpret_cast<uint8_t*>(tile);
  const int tid = threadIdx.y * TILE + threadIdx.x;
  for (int idx = tid; idx < TILE * CHUNK; idx += TILE * TILE) {
    const int r = idx / CHUNK, c = idx - r * CHUNK;
    const int gr = r0 + r, gc = c0 + c;
    bytes[r * ROW_WORDS * 4 + c] = (gr < rows && gc < cols) ? src[(size_t)gr * cols + gc] : 0;
  }
}

__global__ void __launch_bounds__(TILE * TILE)
    static_predicate_mask_kernel(const uint8_t* __restrict__ sel, const uint8_t* __restrict__ unknown,
                                 const uint8_t* __restrict__ labels, const uint8_t* __restrict__ unsched,
                                 const uint8_t* __restrict__ taints, const uint8_t* __restrict__ tolerated,
                                 uint8_t* __restrict__ out, int S, int N, int L, int K) {
  __shared__ uint32_t task_rows[TILE][ROW_WORDS];
  __shared__ uint32_t node_rows[TILE][ROW_WORDS];
  const int s0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  const int ty = threadIdx.y, tx = threadIdx.x;
  int count = 0;

  // Selector pairs the node lacks: sel & ~labels.
  for (int c0 = 0; c0 < L; c0 += CHUNK) {
    stage(task_rows, sel, S, L, s0, c0);
    stage(node_rows, labels, N, L, n0, c0);
    __syncthreads();
#pragma unroll
    for (int w = 0; w < WORDS; ++w) count += __popc(task_rows[ty][w] & ~node_rows[tx][w]);
    __syncthreads();
  }
  // Taints the task does not tolerate: taints & ~tolerated.  The staged
  // taint bytes are 0 past K, so ~tolerated there contributes nothing.
  for (int c0 = 0; c0 < K; c0 += CHUNK) {
    stage(task_rows, tolerated, S, K, s0, c0);
    stage(node_rows, taints, N, K, n0, c0);
    __syncthreads();
#pragma unroll
    for (int w = 0; w < WORDS; ++w) count += __popc(node_rows[tx][w] & ~task_rows[ty][w]);
    __syncthreads();
  }

  const int s = s0 + ty, n = n0 + tx;
  if (s < S && n < N) out[(size_t)s * N + n] = (count == 0 && !unknown[s] && !unsched[n]) ? 1 : 0;
}

extern "C" int static_predicate_mask_launch(const void* sel, const void* unknown, const void* labels,
                                            const void* unsched, const void* taints,
                                            const void* tolerated, void* out, int S, int N, int L,
                                            int K, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  const dim3 grid((N + TILE - 1) / TILE, (S + TILE - 1) / TILE);
  const dim3 block(TILE, TILE);
  static_predicate_mask_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)sel, (const uint8_t*)unknown, (const uint8_t*)labels, (const uint8_t*)unsched,
      (const uint8_t*)taints, (const uint8_t*)tolerated, (uint8_t*)out, S, N, L, K);
  return (int)cudaGetLastError();
}
