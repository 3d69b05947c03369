// Mamba2 SSD chunk scan for Hopper (sm_90a): y and the final state of
//
//   h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t,   y_t = C_t h_t
//
// computed chunk by chunk, as repro/models/mamba.py::ssd_chunked does:
//
//   y[i]      = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) xd_j + exp(cs_i) C_i . state
//   state_out = exp(cs_last) state + sum_j B_j exp(cs_last - cs_j) xd_j
//
// with xd = x * dt in f32 and cs the inclusive cumulative sum of dt * a
// inside the chunk.
//
// Replaces the TPU kernel repro/kernels/ssd_chunk.py::_ssd_kernel
// (ssd_chunk_kernel, reached through ops.ssd).  What differs from it:
//   * it reads an initial state (chunked prefill continues from the previous
//     piece's state, a restored snapshot is a nonzero state) and writes the
//     final state; the TPU kernel starts from zero and keeps its state;
//   * the last chunk may be short (a ragged tail: head chunks of `chunk`,
//     then one chunk of s % chunk, the grid of ssd_chunked); rows and
//     columns past it are masked and the end-of-chunk decay uses its last
//     valid position;
//   * B and C are one group shared by every head: the block indexes batch
//     b = bh / H and never reads a broadcast copy;
//   * the chunks of one (b, h) are a loop inside the block (blocks run in no
//     order), with the block's slice of the state in shared memory across
//     the loop.
//
//   x  (B, S, H, P) f32 or bf16     dt (B, S, H) f32     a (H,) f32
//   B/C (B, S, N)   x's type        init_state, final_state (B, H, P, N) f32
//   y  (B, S, H, P) x's type
//
// Grid: (B * H, ceil(P / 16)).  Columns of P are independent (y[:, p] needs
// only x[:, p] and state[p, :]), so a block owns 16 of them: at the serve's
// b = 1, H = 80, P = 64 that is 320 blocks for the 132 SMs.  256 threads as
// a 16 x 16 grid.  A chunk of up to 256 rows does not fit whole (its f32
// score matrix alone is 256 KB), so the chunk is cut into 64-row tiles and
// each row tile walks the 64-key tiles up to its diagonal, flash-style:
// scores C B^T (each thread a 4 x 4 sub-tile over N), masked by position
// before the exponential (exp of the unmasked upper triangle overflows),
// times the decay, then accumulated against the key tile's xd columns; the
// carried-state term is added once per row.  The state update is one more
// pass over the chunk's key tiles.  The cumulative log-decay is a warp scan
// (segment sums, then a shuffle scan of the segment totals): another
// summation order than torch.cumsum, well inside the f32 tolerance.
// Plain FMA in f32; no tensor cores yet.
//
// What bounds it at the serve's shapes (b = 1, a 64-token chunk, H = 80,
// P = 64, N = 128, bf16 x): bytes, dominated by the f32 state read and
// written (2 x 80 x 64 x 128 x 4 B = 5.2 MB) over 3.35 TB/s, about 2 us;
// the flops are a fraction of a microsecond at the card's rate.  This
// simple kernel recomputes C B^T in each of the 4 column blocks of a head
// and re-reads B and C from L2 for every head: mma.sync / wgmma on the
// score and state products, and sharing C B^T across heads, are the later
// fast path.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;            // rows (and keys) of a score tile
constexpr int kCols = 16;            // state / output columns p per block
constexpr int kSub = kTile / 16;     // rows (and keys) per thread in a score tile
constexpr int kMaxState = 256;

template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src,
                                           int rows_valid, int n, int ns, int tid) {
  // dst[i * ns + k] = src[i * n + k] for i < rows_valid, else 0 (kTile rows).
  for (int e = tid; e < kTile * n; e += kThreads) {
    const int i = e / n;
    const int k = e - i * n;
    dst[i * ns + k] = i < rows_valid ? to_f32(src[static_cast<size_t>(i) * n + k]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ bm, const T* __restrict__ cm,
    const float* __restrict__ init_state, T* __restrict__ y,
    float* __restrict__ final_state, int s_len, int n_heads, int p_dim, int n_state,
    int chunk) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int p0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key / column index inside a tile
  const int ty = tid >> 4;  // row index inside a tile
  const int lane = tid & 31;
  const int n = n_state;
  const int ns = n + 1;  // odd row stride: the 16 rows a warp reads sit in distinct banks

  float* cs = smem;                      // chunk: cumulative log-decay of the chunk
  float* c_s = cs + chunk;               // kTile * ns: C rows of the row tile
  float* b_s = c_s + kTile * ns;         // kTile * ns: B rows of the key tile
  float* x_s = b_s + kTile * ns;         // kTile * kCols: xd (or xd * decay) columns
  float* s_s = x_s + kTile * kCols;      // kTile * (kTile + 1): masked, decayed scores
  float* st = s_s + kTile * (kTile + 1); // kCols * ns: this block's state columns

  const float ah = a[h];
  const size_t row_stride = static_cast<size_t>(n_heads) * p_dim;  // x / y per token

  for (int e = tid; e < kCols * n; e += kThreads) {
    const int p = e / n;
    const int k = e - p * n;
    float v = 0.f;
    if (init_state != nullptr && p0 + p < p_dim)
      v = init_state[(static_cast<size_t>(bh) * p_dim + p0 + p) * n + k];
    st[p * ns + k] = v;
  }

  for (int t0 = 0; t0 < s_len; t0 += chunk) {
    const int q = min(chunk, s_len - t0);
    const size_t tok0 = static_cast<size_t>(b) * s_len + t0;  // first token of the chunk
    __syncthreads();  // the previous chunk's readers of cs and st are done

    // Inclusive cumulative sum of dt * a over the chunk: each lane of warp 0
    // sums a contiguous segment, then a shuffle scan adds the earlier
    // segments' totals.
    if (tid < 32) {
      const int per = (q + 31) / 32;
      const int lo = min(lane * per, q);
      const int hi = min(lo + per, q);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += dt[(tok0 + i) * n_heads + h] * ah;
        cs[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) before = 0.f;
      for (int i = lo; i < hi; ++i) cs[i] += before;
    }

    // y, one 64-row tile at a time.
    for (int r0 = 0; r0 < q; r0 += kTile) {
      __syncthreads();  // cs is written; the previous row tile's readers of c_s are done
      stage_rows(c_s, cm + (tok0 + r0) * n, q - r0, n, ns, tid);
      float acc[kSub];
#pragma unroll
      for (int u = 0; u < kSub; ++u) acc[u] = 0.f;

      for (int k0 = 0; k0 <= r0; k0 += kTile) {  // key tiles up to the diagonal
        __syncthreads();  // readers of the previous key tile's b_s, x_s, s_s are done
        stage_rows(b_s, bm + (tok0 + k0) * n, q - k0, n, ns, tid);
        for (int e = tid; e < kTile * kCols; e += kThreads) {
          const int j = e / kCols;
          const int p = e - j * kCols;
          float v = 0.f;
          if (k0 + j < q && p0 + p < p_dim) {
            const size_t tok = tok0 + k0 + j;
            v = to_f32(x[tok * row_stride + static_cast<size_t>(h) * p_dim + p0 + p]) *
                dt[tok * n_heads + h];
          }
          x_s[j * kCols + p] = v;
        }
        __syncthreads();

        float sc[kSub][kSub];
#pragma unroll
        for (int u = 0; u < kSub; ++u)
#pragma unroll
          for (int w = 0; w < kSub; ++w) sc[u][w] = 0.f;
        for (int k = 0; k < n; ++k) {
          float cv[kSub], bv[kSub];
#pragma unroll
          for (int u = 0; u < kSub; ++u) cv[u] = c_s[(ty + 16 * u) * ns + k];
#pragma unroll
          for (int w = 0; w < kSub; ++w) bv[w] = b_s[(tx + 16 * w) * ns + k];
#pragma unroll
          for (int u = 0; u < kSub; ++u)
#pragma unroll
            for (int w = 0; w < kSub; ++w) sc[u][w] = fmaf(cv[u], bv[w], sc[u][w]);
        }
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
          const int i = r0 + ty + 16 * u;  // positions inside the chunk
#pragma unroll
          for (int w = 0; w < kSub; ++w) {
            const int j = k0 + tx + 16 * w;
            // Mask before the exponential: exp(NEG_INF) is 0.
            const float d = (j <= i && i < q) ? cs[i] - cs[j] : NEG_INF;
            s_s[(ty + 16 * u) * (kTile + 1) + tx + 16 * w] = sc[u][w] * expf(d);
          }
        }
        __syncthreads();
        for (int j = 0; j < kTile; ++j) {
          const float xv = x_s[j * kCols + tx];
#pragma unroll
          for (int u = 0; u < kSub; ++u)
            acc[u] = fmaf(s_s[(ty + 16 * u) * (kTile + 1) + j], xv, acc[u]);
        }
      }

      // The carried state's term, then the store (x's type).
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const int i = ty + 16 * u;
        if (r0 + i < q && p0 + tx < p_dim) {
          float off = 0.f;
          for (int k = 0; k < n; ++k) off = fmaf(c_s[i * ns + k], st[tx * ns + k], off);
          const size_t tok = tok0 + r0 + i;
          y[tok * row_stride + static_cast<size_t>(h) * p_dim + p0 + tx] =
              from_f32<T>(acc[u] + expf(cs[r0 + i]) * off);
        }
      }
    }

    // State update: decay the carried state to the chunk's last valid
    // position, then add the chunk's inputs decayed to it.  Thread tid owns
    // the state entries tid, tid + 256, ... in both steps.
    __syncthreads();  // every reader of st for this chunk's y is done
    const float cs_last = cs[q - 1];
    const float total = expf(cs_last);
    for (int e = tid; e < kCols * n; e += kThreads) {
      const int p = e / n;
      st[p * ns + (e - p * n)] *= total;
    }
    for (int k0 = 0; k0 < q; k0 += kTile) {
      __syncthreads();  // readers of the previous key tile are done
      stage_rows(b_s, bm + (tok0 + k0) * n, q - k0, n, ns, tid);
      for (int e = tid; e < kTile * kCols; e += kThreads) {
        const int j = e / kCols;
        const int p = e - j * kCols;
        float v = 0.f;
        if (k0 + j < q && p0 + p < p_dim) {
          const size_t tok = tok0 + k0 + j;
          v = to_f32(x[tok * row_stride + static_cast<size_t>(h) * p_dim + p0 + p]) *
              dt[tok * n_heads + h] * expf(cs_last - cs[k0 + j]);
        }
        x_s[j * kCols + p] = v;
      }
      __syncthreads();
      for (int e = tid; e < kCols * n; e += kThreads) {
        const int p = e / n;
        const int k = e - p * n;
        float sum = 0.f;
        for (int j = 0; j < kTile; ++j) sum = fmaf(b_s[j * ns + k], x_s[j * kCols + p], sum);
        st[p * ns + k] += sum;
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < kCols * n; e += kThreads) {
    const int p = e / n;
    const int k = e - p * n;
    if (p0 + p < p_dim)
      final_state[(static_cast<size_t>(bh) * p_dim + p0 + p) * n + k] = st[p * ns + k];
  }
}

size_t smem_bytes(int n_state, int chunk) {
  const size_t ns = n_state + 1;
  return sizeof(float) * (chunk + 2 * kTile * ns + kTile * kCols + kTile * (kTile + 1) +
                          kCols * ns);
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* a, const void* bm,
                   const void* cm, const void* init_state, void* y, void* final_state,
                   int batch, int s_len, int n_heads, int p_dim, int n_state, int chunk,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(n_state, chunk);
  cudaError_t err = allow_smem(ssd_chunk_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(batch * n_heads, (p_dim + kCols - 1) / kCols);
  ssd_chunk_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const float*>(init_state), static_cast<T*>(y),
      static_cast<float*>(final_state), s_len, n_heads, p_dim, n_state, chunk);
  return cudaGetLastError();
}

}  // namespace

// init_state may be null (a zero initial state).  `chunk` is the SSD chunk
// length after the caller's clamp to s_len.
extern "C" int ssd_chunk(int dtype, const void* x, const void* dt, const void* a,
                         const void* bm, const void* cm, const void* init_state, void* y,
                         void* final_state, int batch, int s_len, int n_heads, int p_dim,
                         int n_state, int chunk, void* stream) {
  if (batch < 1 || s_len < 1 || n_heads < 1 || p_dim < 1 || n_state < 1 ||
      n_state > kMaxState || chunk < 1 || chunk > s_len ||
      static_cast<long long>(batch) * n_heads > 2147483647LL ||
      (p_dim + kCols - 1) / kCols > 65535 || smem_bytes(n_state, chunk) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == DTYPE_BF16
          ? launch<__nv_bfloat16>(x, dt, a, bm, cm, init_state, y, final_state, batch,
                                  s_len, n_heads, p_dim, n_state, chunk, s)
          : launch<float>(x, dt, a, bm, cm, init_state, y, final_state, batch, s_len,
                          n_heads, p_dim, n_state, chunk, s);
  return static_cast<int>(err);
}
