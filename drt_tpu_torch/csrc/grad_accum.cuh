// Gradient accumulation of the adjoint kernels (fused_adjoint.cu,
// dyn_adjoint.cu) without float atomics.
//
// The TPU kernels add a tile's partial sums to SMEM accumulators over a
// grid that runs in order (megakernel.py:_accumulate_grad_smem). Blocks
// here run in no order, and a float atomic would make the sum depend on
// the order of arrival. So every thread owns one column of an
// [entries][DRT_BLOCK] accumulator in dynamic shared memory (entries =
// real albedo rows x 3 + real emission rows x 3) and adds its own
// contributions there (sweep_bounce in drt_common.cuh), chunk after chunk
// and bounce after bounce, with no other thread involved; at the end the
// block sums each entry over its columns in a fixed order (4 columns per
// lane, then a shuffle tree) and writes one row of partials; a second
// kernel sums the partials of all blocks per entry, again in a fixed
// order, and writes the gradient tables with their sentinel rows zero.
// Kernels that share the block size, the ray -> block map, the chunk order
// and these routines give, for equal residuals, gradients that are equal
// bit for bit, and two runs give the same bits. The queue adjoints of
// fused_adjoint.cu keep a column per ray slot in device memory and sum
// each 128 slots with block_reduce_write (slot_reduce_kernel there).

#pragma once

#include "drt_common.cuh"

#define DRT_REDUCE_THREADS 256

// Accumulator entries: albedo rows first, then emission rows, 3 each.
static __host__ __device__ __forceinline__ int n_entries(int n_alb,
                                                         int n_emi) {
  return (n_alb - 1 + n_emi - 1) * 3;
}

static __device__ __forceinline__ void zero_column(int n_alb, int n_emi,
                                                   float* s_acc) {
  const int E = n_entries(n_alb, n_emi);
  for (int e = 0; e < E; ++e) s_acc[e * DRT_BLOCK + threadIdx.x] = 0.0f;
}

// Sum every entry over the block's columns in a fixed order and write row
// `row` of partials: the row of the block's 128 ray slots. Every thread of
// the block calls this.
static __device__ __forceinline__ void block_reduce_row(
    int n_alb, int n_emi, const float* s_acc, float* __restrict__ partials,
    unsigned row) {
  __syncthreads();
  const int E = n_entries(n_alb, n_emi);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e = warp; e < E; e += DRT_BLOCK / 32) {
    const float* col = s_acc + e * DRT_BLOCK;
    float v = col[lane];
#pragma unroll
    for (int k = 1; k < DRT_BLOCK / 32; ++k) v = v + col[lane + 32 * k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = v + __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) partials[(size_t)row * E + e] = v;
  }
}

// block_reduce_row into the block's own row, blockIdx.x.
static __device__ __forceinline__ void block_reduce_write(
    int n_alb, int n_emi, const float* s_acc, float* __restrict__ partials) {
  block_reduce_row(n_alb, n_emi, s_acc, partials, blockIdx.x);
}

// One block per entry of the padded gradient tables: a sentinel row gets
// 0, a real row the sum of its partials over the blocks, each thread
// taking every 256th block in ascending order, then a fixed tree.
__global__ void __launch_bounds__(DRT_REDUCE_THREADS)
reduce_partials_kernel(int n_alb, int n_emi,
                       const float* __restrict__ partials, int n_blocks,
                       float* __restrict__ da, float* __restrict__ de) {
  __shared__ float s[DRT_REDUCE_THREADS];
  const int na3 = n_alb * 3;
  const int t = blockIdx.x;  // entry of [da | de], sentinel rows included
  const bool is_alb = t < na3;
  const int row = (is_alb ? t : t - na3) / 3;
  const int ch = (is_alb ? t : t - na3) % 3;
  float* dst = is_alb ? da + t : de + (t - na3);
  if (row >= (is_alb ? n_alb : n_emi) - 1) {
    if (threadIdx.x == 0) *dst = 0.0f;
    return;
  }
  const int E = n_entries(n_alb, n_emi);
  const int e = (is_alb ? 0 : (n_alb - 1) * 3) + row * 3 + ch;
  float v = 0.0f;
  for (int j = threadIdx.x; j < n_blocks; j += DRT_REDUCE_THREADS)
    v = v + partials[(size_t)j * E + e];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int w = DRT_REDUCE_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] = s[threadIdx.x] + s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *dst = s[0];
}

// Bytes of dynamic shared memory of one block's accumulator.
static int acc_bytes(int n_alb, int n_emi) {
  return n_entries(n_alb, n_emi) * DRT_BLOCK * (int)sizeof(float);
}

// Launch the second pass over the partials of ceil(n_rays / DRT_BLOCK)
// blocks; returns cudaGetLastError().
static int reduce_partials(int n_rays, int n_alb, int n_emi,
                           const float* partials, float* da, float* de,
                           cudaStream_t s) {
  const int grid = (n_rays + DRT_BLOCK - 1) / DRT_BLOCK;
  reduce_partials_kernel<<<(n_alb + n_emi) * 3, DRT_REDUCE_THREADS, 0, s>>>(
      n_alb, n_emi, partials, grid, da, de);
  return (int)cudaGetLastError();
}

template <class Kernel>
static int allow_shared(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}
