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

// The deep forms of the adjoint kernels: instances that the launch takes
// only where the in-thread and shared-memory forms end, paths of more than
// DEEP_WINDOW bounces (rows, or a segment's rows) and accumulators of more
// than DEEP_MAX_ACC_ROWS real table rows. They keep what does not fit in a
// scratch buffer in device memory that the caller passes (deep_bytes says
// how large):
//  - a thread's rows DEEP_WINDOW, DEEP_WINDOW + 1, ... (rows below stay in
//    the thread, as in the in-thread forms): row b of the grid's thread t
//    at psc[(b - DEEP_WINDOW) * threads + t] (P and sc, 16 bytes) and
//    word[...] (the row's word), so a warp's row is one coalesced line;
//  - with more rows, each block's accumulator columns, E x DRT_BLOCK floats
//    at acc + blockIdx.x * E * DRT_BLOCK: the layout of the shared-memory
//    accumulator, so zero_column, sweep_bounce and block_reduce_row run on
//    it unchanged and give its bits (each column is still one thread's,
//    summed in the same order; no float atomics).
// The grid of a deep form is at most deep_blocks(n) blocks, the threads
// an SM can hold on every SM, and walks its 128-item groups in turn, so
// the scratch grows with the card and the depth, not with the items.
#define DEEP_WINDOW 32
#define DEEP_MAX_ACC_ROWS 144

struct DeepRows {
  float4* psc;
  int* word;
  int threads;
  __device__ __forceinline__ size_t at(int b) const {
    return (size_t)(b - DEEP_WINDOW) * threads + blockIdx.x * DRT_BLOCK +
           threadIdx.x;
  }
  __device__ __forceinline__ void put(int b, float4 v, int w) const {
    const size_t k = at(b);
    psc[k] = v;
    word[k] = w;
  }
};

struct DeepScratch {
  float* acc;  // null: the accumulator is in shared memory
  DeepRows rows;
  // The block's accumulator: its columns in acc, else s_acc.
  __device__ __forceinline__ float* block_acc(int E, float* s_acc) const {
    return acc ? acc + (size_t)blockIdx.x * E * DRT_BLOCK : s_acc;
  }
};

// Whether a launch over these tables and rows per path takes a deep form.
static inline bool deep_acc(int n_alb, int n_emi) {
  return n_alb - 1 + n_emi - 1 > DEEP_MAX_ACC_ROWS;
}
static inline bool takes_deep(int depth, int n_alb, int n_emi) {
  return depth > DEEP_WINDOW || deep_acc(n_alb, n_emi);
}

// Blocks of a deep form's grid over n items: at most as many as the card
// holds at once (its threads per SM in blocks of DRT_BLOCK on every SM).
static cudaError_t deep_blocks(int n, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  const int need = (n + DRT_BLOCK - 1) / DRT_BLOCK;
  const int most = sms * (per_sm / DRT_BLOCK);
  *blocks = need < most ? need : most;
  if (*blocks < 1) *blocks = 1;
  return e;
}

// Bytes of a deep form's scratch over n items, `depth` rows a path: the
// accumulator where the tables' rows take it out of shared memory, then
// the rows past DEEP_WINDOW, for deep_blocks(n) blocks. 0: no deep form.
static cudaError_t deep_bytes(int n, int depth, int n_alb, int n_emi,
                              size_t* bytes) {
  *bytes = 0;
  if (!takes_deep(depth, n_alb, n_emi)) return cudaSuccess;
  int blocks = 0;
  const cudaError_t e = deep_blocks(n, &blocks);
  const size_t threads = (size_t)blocks * DRT_BLOCK;
  if (deep_acc(n_alb, n_emi))
    *bytes += threads * n_entries(n_alb, n_emi) * sizeof(float);
  if (depth > DEEP_WINDOW)
    *bytes += threads * (depth - DEEP_WINDOW) * (sizeof(float4) + sizeof(int));
  return e;
}

// The deep form's view of `scratch` (deep_bytes of it) and its grid.
static cudaError_t deep_scratch(void* scratch, int n, int depth, int n_alb,
                                int n_emi, DeepScratch* d, int* blocks) {
  const cudaError_t e = deep_blocks(n, blocks);
  const size_t threads = (size_t)*blocks * DRT_BLOCK;
  char* p = (char*)scratch;
  d->acc = nullptr;
  if (deep_acc(n_alb, n_emi)) {
    d->acc = (float*)p;
    p += threads * n_entries(n_alb, n_emi) * sizeof(float);
  }
  const size_t rows = depth > DEEP_WINDOW ? depth - DEEP_WINDOW : 0;
  d->rows.psc = (float4*)p;
  d->rows.word = (int*)(p + threads * rows * sizeof(float4));
  d->rows.threads = (int)threads;
  return e;
}

// The dynamic shared memory of a deep form: its accumulator, where the
// accumulator is not in device memory.
static int deep_shared_bytes(int n_alb, int n_emi) {
  return deep_acc(n_alb, n_emi) ? 0 : acc_bytes(n_alb, n_emi);
}

// The launch of every deep form: its view of `scratch` (deep_bytes(n,
// depth, n_alb, n_emi) of it), `bytes` of dynamic shared memory allowed
// for `kernel` (-1: deep_shared_bytes), a grid of at most deep_blocks(n)
// blocks, and of at most queue_grid(kernel, items) where items > 0 (a
// persistent grid); then launch(grid, bytes, view) makes the launch.
// Returns the first CUDA error.
template <class Kernel, class Launch>
static int launch_deep(Kernel kernel, void* scratch, int n, int depth,
                       int n_alb, int n_emi, int bytes, int items,
                       Launch launch) {
  if (!scratch) return (int)cudaErrorInvalidValue;
  DeepScratch view;
  int grid = 0;
  int rc = (int)deep_scratch(scratch, n, depth, n_alb, n_emi, &view, &grid);
  if (rc) return rc;
  if (bytes < 0) bytes = deep_shared_bytes(n_alb, n_emi);
  rc = allow_shared(kernel, bytes);
  if (rc) return rc;
  if (items > 0) {
    int most = 0;
    rc = (int)queue_grid(kernel, items, &most, bytes);
    if (rc) return rc;
    if (most < grid) grid = most;
  }
  launch(grid, bytes, view);
  return (int)cudaGetLastError();
}

// The group walk of a deep form that is not a persistent queue: block k
// takes the 128-item groups k, k + gridDim.x, ...; for each, every thread
// runs body(item) on its item (which may lie past the last, n - 1), then
// the block writes the group's row of partials from its accumulator
// s_acc, as block k of the in-thread form's grid does, and zeroes it.
template <class Body>
static __device__ __forceinline__ void deep_groups(
    int n_alb, int n_emi, int n, float* s_acc, float* __restrict__ partials,
    Body body) {
  zero_column(n_alb, n_emi, s_acc);
  const int groups = (n + DRT_BLOCK - 1) / DRT_BLOCK;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    body(grp * DRT_BLOCK + (int)threadIdx.x);
    block_reduce_row(n_alb, n_emi, s_acc, partials, (unsigned)grp);
    __syncthreads();
    zero_column(n_alb, n_emi, s_acc);
  }
}

// Every library with a deep form exports its scratch size under this name
// (each library is its own module).
#define DRT_DEEP_BYTES_ENTRY                                                \
  extern "C" int drt_deep_bytes(int n, int depth, int n_alb, int n_emi,   \
                                unsigned long long* bytes) {              \
    size_t b = 0;                                                         \
    const int rc = (int)deep_bytes(n, depth, n_alb, n_emi, &b);           \
    *bytes = b;                                                           \
    return rc;                                                            \
  }
