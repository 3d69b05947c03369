// Tiled matmul for Hopper (sm_90a): out = x @ y with an f32 accumulator,
// out in result_type(x, y).
//
// Replaces the TPU kernel repro/kernels/streamed_matmul.py::streamed_matmul
// (body _mm_kernel, reached through ops.matmul).  There the (i, j, k) grid is
// sequential on one core and the k axis streams HBM->VMEM blocks into a VMEM
// f32 accumulator; the block sizes are VMEM sizes and every dimension must
// divide by them.  Here the k stream is a loop inside the block (blocks run
// in parallel, in no order): a 128 x 128 output tile per block, k tiles of 8
// staged through shared memory as f32, and an 8 x 8 register micro-tile of
// f32 accumulators per thread.  Edges are masked, so any (m, k) @ (k, n)
// works.
//
//   x (m, k), y (k, n): f32 or bf16, row-major, contiguous
//   out (m, n): f32 unless both inputs are bf16
//
// 256 threads as a 16 x 16 grid; thread (tx, ty) owns rows ty + 16 r and
// columns tx + 16 c (r, c < 8) of the tile, so a warp's shared reads are
// broadcasts (x) and 16 consecutive words (y), free of bank conflicts.
//
// What bounds it at the paper path's shape (2048^3, f32): operations.
// 2 * 2048^3 = 17.2 GFLOP over the card's 67 TFLOP/s of f32 FMA outside the
// tensor cores is 0.256 ms; the 48 MB read and written take 0.014 ms at
// 3.35 TB/s.  This simple kernel issues two shared loads per 8 FMAs per k
// step and no tensor-core instruction (TF32 would change the numbers:
// f32 means f32 here); a wgmma pipeline fed by TMA is the later fast path.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kMicro = 8;

template <typename TX, typename TY, typename TO>
__global__ void __launch_bounds__(kThreads) matmul_kernel(
    const TX* __restrict__ x, const TY* __restrict__ y, TO* __restrict__ out,
    int m, int n, int k) {
  __shared__ float xs[kBK][kBM];  // transposed: xs[kk][row]
  __shared__ float ys[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int c = 0; c < kMicro; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // x tile (kBM x kBK): consecutive threads read consecutive k of a row.
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK;
      const int c = e - r * kBK;
      const int gr = row0 + r;
      const int gc = k0 + c;
      xs[c][r] = (gr < m && gc < k) ? to_f32(x[static_cast<size_t>(gr) * k + gc]) : 0.f;
    }
    // y tile (kBK x kBN): consecutive threads read consecutive columns.
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int r = e / kBN;
      const int c = e - r * kBN;
      const int gr = k0 + r;
      const int gc = col0 + c;
      ys[r][c] = (gr < k && gc < n) ? to_f32(y[static_cast<size_t>(gr) * n + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kMicro], b[kMicro];
#pragma unroll
      for (int r = 0; r < kMicro; ++r) a[r] = xs[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < kMicro; ++c) b[c] = ys[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int c = 0; c < kMicro; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    const int gr = row0 + ty + 16 * r;
    if (gr >= m) continue;
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      const int gc = col0 + tx + 16 * c;
      if (gc < n) out[static_cast<size_t>(gr) * n + gc] = from_f32<TO>(acc[r][c]);
    }
  }
}

template <typename TX, typename TY, typename TO>
cudaError_t launch(const void* x, const void* y, void* out, int m, int n, int k,
                   cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  matmul_kernel<TX, TY, TO><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TY*>(y), static_cast<TO*>(out), m, n, k);
  return cudaGetLastError();
}

}  // namespace

// x_dtype / y_dtype: DTYPE_F32 or DTYPE_BF16; the output is bf16 only when
// both are.  Returns cudaGetLastError() after the launch.
extern "C" int streamed_matmul(int x_dtype, int y_dtype, const void* x, const void* y,
                               void* out, int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool xb = x_dtype == DTYPE_BF16, yb = y_dtype == DTYPE_BF16;
  if ((x_dtype != DTYPE_F32 && !xb) || (y_dtype != DTYPE_F32 && !yb))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (xb && yb) {
    err = launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(x, y, out, m, n, k, s);
  } else if (xb) {
    err = launch<__nv_bfloat16, float, float>(x, y, out, m, n, k, s);
  } else if (yb) {
    err = launch<float, __nv_bfloat16, float>(x, y, out, m, n, k, s);
  } else {
    err = launch<float, float, float>(x, y, out, m, n, k, s);
  }
  return static_cast<int>(err);
}
