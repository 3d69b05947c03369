// Walsh-Hadamard transform of each row for Hopper (sm_90a): the
// unnormalized WHT over the last axis of a (rows, block) matrix, block a
// power of two, log2(block) butterfly stages in f32, the result in x's type.
//
// Replaces the TPU kernel repro/kernels/fwt.py::fwt_block (body
// _fwt_block_kernel; the two-pass Kronecker driver is ops.fwt, kept as it
// is in kernels/fwt.py).  The TPU kernel transforms a tile of rows in VMEM,
// the grid streaming over row tiles.  Here one block owns one row: the row
// goes into shared memory as f32, the stages run there with a __syncthreads
// between them, and the row is written back once.  Stage h pairs element
// a = (p / h) * 2h + p % h with a + h and writes (x[a] + x[b], x[a] - x[b]),
// the order of the reference's reshape (rows, block / 2h, 2, h), so the sums
// are the same f32 operations as the plain version's.  256 threads; a row
// of 4096 (the paper path's second pass) gives each thread 8 pairs a stage.
//
//   x, out (rows, block): f32 or bf16, contiguous (out may alias x)
//
// A row above 48 KB of f32 (block > 12288) needs the dynamic shared-memory
// opt-in, which allow_smem sets; the wrapper raises above 2^15 (128 KB, the
// largest power of two that fits the 227 KB a block may use).
//
// What bounds it at the paper path's shapes ((4096, 1024) and (1024, 4096)
// f32, 16 MB each): bytes, 32 MB read and written per pass, ~0.010 ms at
// 3.35 TB/s; the 10-12 adds per element are far below the card's rate.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) fwt_kernel(const T* __restrict__ x,
                                                       T* __restrict__ out, int block) {
  extern __shared__ float row[];
  const size_t base = static_cast<size_t>(blockIdx.x) * block;
  for (int e = threadIdx.x; e < block; e += kThreads) row[e] = to_f32(x[base + e]);
  __syncthreads();
  const int pairs = block / 2;
  for (int h = 1; h < block; h *= 2) {
    for (int p = threadIdx.x; p < pairs; p += kThreads) {
      const int a = (p / h) * 2 * h + (p % h);
      const float u = row[a];
      const float v = row[a + h];
      row[a] = u + v;
      row[a + h] = u - v;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < block; e += kThreads) out[base + e] = from_f32<T>(row[e]);
}

template <typename T>
cudaError_t launch(const void* x, void* out, int rows, int block, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(block) * sizeof(float);
  cudaError_t err = allow_smem(fwt_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  fwt_kernel<T><<<rows, kThreads, smem, stream>>>(static_cast<const T*>(x),
                                                  static_cast<T*>(out), block);
  return cudaGetLastError();
}

}  // namespace

// dtype: DTYPE_F32 or DTYPE_BF16.  Returns cudaGetLastError() after the
// launch.
extern "C" int fwt_block(int dtype, const void* x, void* out, int rows, int block,
                         void* stream) {
  if (rows <= 0 || block <= 0 || (block & (block - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return static_cast<int>(launch<float>(x, out, rows, block, s));
  if (dtype == DTYPE_BF16)
    return static_cast<int>(launch<__nv_bfloat16>(x, out, rows, block, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
