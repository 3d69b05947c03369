// Needleman-Wunsch DP tiles for Hopper (sm_90a): every (B, B) tile of one
// anti-diagonal of the tile grid, in one launch.
//
// Replaces the TPU kernel repro/kernels/nw_tile.py::nw_tile (body
// _nw_kernel, ladder _row_chain_max; driven by ops.nw_wavefront through
// core/wavefront.wavefront_scan).  The TPU kernel computes one tile from a
// north row, a west column and a corner gathered for it, and the scheduler
// vmaps it over a diagonal.  Here one launch runs a whole diagonal, one
// block per tile, and each block reads its boundary from the wavefront's
// state on the card and writes its tile's back:
//
//   north  = south[i][j + 1][:]       west = east[i + 1][j][:]
//   corner = corners[i][j]
//   writes south[i + 1][j + 1][:] = last row, east[i + 1][j + 1][:] = last
//          column, corners[i + 1][j + 1] = the last row's last value,
//          and the tile into out (n, m) at rows i*B.., columns j*B..
//
// with state indices tile indices + 1 (fringe row / column 0 hold the
// initial boundary, see core/wavefront.py::WavefrontState).  The tile's
// substitution scores are read in place from the (n, m) score matrix: no
// per-tile gather.
//
// In-tile recurrence (linear gap g), rows in order, B threads, one per
// column c:
//   tmp[c] = max(H[i-1][c-1] + sub[i][c], H[i-1][c] - g)
//   tmp[0] = max(tmp[0], west[i] - g)
//   H[i][c] = max_{c' <= c}(tmp[c'] - (c - c') g)     -- the shift-max ladder:
//   for shift = 1, 2, 4, ..: x[c] = max(x[c], x[c - shift] - g * shift)
// (columns c < shift take the reference's NEG = -1e9, which never wins).
// For B <= 32 the ladder is warp shuffles; above, shared-memory ping-pong
// buffers with a __syncthreads per step.  Every value is the same f32
// operation as in the plain version (g * shift is exact for a power-of-two
// shift), so kernel and plain agree bit for bit.
//
//   scores, out (n, m) f32 contiguous, n = rows * B, m = cols * B
//   south, east (rows + 1, cols + 1, B) f32; corners (rows + 1, cols + 1) f32
//   B a power of two, 1 <= B <= 1024
//
// What bounds it at the paper path's shape (2048 x 2048, B = 32, 127
// diagonals of up to 64 tiles): bytes, the scores read and the tiles
// written once (2 x 16 MB, ~0.010 ms at 3.35 TB/s over the 127 launches)
// -- far below what the design costs: each diagonal is a chain of B rows of
// log2(B) dependent steps on at most 64 blocks of B threads, so a launch is
// latency-bound, and the 127 launches are serialized by the RAW chain.

#include "common.cuh"

namespace {

constexpr float kNeg = -1e9f;
constexpr int kMaxBlock = 1024;

template <bool kWarp>
__global__ void __launch_bounds__(kMaxBlock) nw_kernel(
    const float* __restrict__ scores, float* __restrict__ out, float* __restrict__ south,
    float* __restrict__ east, float* __restrict__ corners, int m, int cols, int block,
    int i0, int d, float gap) {
  extern __shared__ float sm[];
  float* west = sm;              // block: the tile's west column
  float* buf = sm + block;       // 2 * block: ladder ping-pong (B > 32)
  const int c = threadIdx.x;
  const int i = i0 + blockIdx.x;
  const int j = d - i;
  const int sc = cols + 1;       // state row stride, in tiles
  const unsigned mask = block >= 32 ? 0xffffffffu : ((1u << block) - 1u);

  west[c] = east[(static_cast<size_t>(i + 1) * sc + j) * block + c];
  float up = south[(static_cast<size_t>(i) * sc + j + 1) * block + c];  // H[-1][c]
  const float corner = corners[static_cast<size_t>(i) * sc + j];
  // H[-1][c - 1]: the corner for column 0, else the north row's left value.
  float diag;
  if (kWarp) {
    diag = __shfl_up_sync(mask, up, 1, block);
  } else {
    buf[c] = up;
    __syncthreads();
    diag = c > 0 ? buf[c - 1] : 0.f;
  }
  if (c == 0) diag = corner;
  __syncthreads();  // west is staged; buf is free

  const float* srow = scores + static_cast<size_t>(i) * block * m + static_cast<size_t>(j) * block;
  float* orow = out + static_cast<size_t>(i) * block * m + static_cast<size_t>(j) * block;
  float x = 0.f;
  for (int r = 0; r < block; ++r) {
    x = fmaxf(diag + srow[static_cast<size_t>(r) * m + c], up - gap);
    if (c == 0) x = fmaxf(x, west[r] - gap);
    if (kWarp) {
      for (int shift = 1; shift < block; shift *= 2) {
        const float left = __shfl_up_sync(mask, x, shift, block);
        x = fmaxf(x, c >= shift ? left - gap * static_cast<float>(shift) : kNeg);
      }
      diag = __shfl_up_sync(mask, x, 1, block);
    } else {
      int cur = 0;
      buf[c] = x;
      __syncthreads();
      for (int shift = 1; shift < block; shift *= 2) {
        const float left = c >= shift ? buf[cur * block + c - shift] - gap * static_cast<float>(shift)
                                      : kNeg;
        x = fmaxf(x, left);
        buf[(cur ^ 1) * block + c] = x;
        __syncthreads();
        cur ^= 1;
      }
      diag = c > 0 ? buf[cur * block + c - 1] : 0.f;
      __syncthreads();  // every read of buf is done before the next row writes it
    }
    if (c == 0) diag = west[r];
    up = x;
    orow[static_cast<size_t>(r) * m + c] = x;
    if (c == block - 1) east[(static_cast<size_t>(i + 1) * sc + j + 1) * block + r] = x;
  }
  south[(static_cast<size_t>(i + 1) * sc + j + 1) * block + c] = x;
  if (c == block - 1) corners[static_cast<size_t>(i + 1) * sc + j + 1] = x;
}

}  // namespace

// Tiles (i0 + t, d - i0 - t) for t < count.  Returns cudaGetLastError()
// after the launch.
extern "C" int nw_diagonal(const float* scores, float* out, float* south, float* east,
                           float* corners, int m, int cols, int block, int i0, int count,
                           int d, float gap, void* stream) {
  if (block < 1 || block > kMaxBlock || (block & (block - 1)) != 0 || count < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 3 * static_cast<size_t>(block) * sizeof(float);
  if (block <= 32) {
    nw_kernel<true><<<count, block, smem, s>>>(scores, out, south, east, corners, m, cols,
                                              block, i0, d, gap);
  } else {
    nw_kernel<false><<<count, block, smem, s>>>(scores, out, south, east, corners, m, cols,
                                               block, i0, d, gap);
  }
  return static_cast<int>(cudaGetLastError());
}
