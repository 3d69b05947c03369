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
// Two bodies.  The tensor-core body (ssd_tc_kernel) takes bf16 x, B and C
// with N in {32, 64, 128, 256}, P a multiple of 64 (32 at N = 256), a chunk
// of at most 256 rows and 16-byte aligned rows -- the serve's mamba2 -- and
// the f32 / any-shape FMA body (ssd_chunk_kernel) the rest: the card-vs-CPU
// f32 checks, small test widths.
//
// Tensor-core body: one block of 4 warps per (b, head, 64 columns of P; 32
// at N = 256): 80 blocks at the serve's b = 1, H = 80, P = 64.  The chunk
// runs as 64-row tiles, warp w owning rows 16w .. 16w + 15, on mma.sync
// m16n8k16 (bf16 in, f32 accumulate; operands by ldmatrix from padded
// shared rows):
//   S = C B^T                      masked by position before the
//                                  exponential, then exp(cs_i - cs_j) dt_j
//                                  in f32 registers, rounded to bf16: the A
//                                  operand of
//   y = (S o L dt) x + exp(cs) (C state^T)    x exact in bf16; the state as
//                                  a bf16 operand (y's 2e-2 allows it)
//   state' = exp(cs_last) state + (wdt o x)^T B,  wdt_j = exp(cs_last - cs_j) dt_j:
//                                  the A operand wdt o x split into bf16
//                                  hi + lo, both products into one f32
//                                  accumulator (~16 bits: the state is held
//                                  to f32's 1e-4; one bf16 operand misses
//                                  it, tests/test_torch_ssd_tc.py).
// The dt loads go first, then the tiles' copies (cp.async), then the
// initial state's, which land under the cumsum, the state update's products
// (they need no state, and run before y) and the scores; the final state
// goes straight from the accumulators to memory.  A k-step's fragment
// loads are issued before its products.  C B^T is recomputed by every block
// of a batch row (a few hundred mma, far below the state's bytes).  Of 64,
// 32 and 16 columns a block (80, 160 and 320 blocks at the serve's shape),
// 64 timed fastest (repro_torch/launch/variants.py; PERF.md).
//
// FMA body: grid (B * H, ceil(P / 16)), a block owning 16 columns of P
// (y[:, p] needs only x[:, p] and state[p, :]); 256 threads as a 16 x 16
// grid.  The chunk is cut into 64-row tiles and each row tile walks the
// 64-key tiles up to its diagonal, flash-style: scores C B^T (each thread a
// 4 x 4 sub-tile over N), masked by position before the exponential (exp of
// the unmasked upper triangle overflows), times the decay, then accumulated
// against the key tile's xd columns; the carried-state term is added once
// per row.  The state update is one more pass over the chunk's key tiles.
// Plain FMA in f32.
//
// Both take the cumulative log-decay as a warp scan (segment sums, then a
// shuffle scan of the segment totals): another summation order than
// torch.cumsum, well inside the f32 tolerance.
//
// What bounds it at the serve's shapes (b = 1, a 64-token chunk, H = 80,
// P = 64, N = 128, bf16 x): bytes, dominated by the f32 state read and
// written (2 x 80 x 64 x 128 x 4 B = 5.2 MB) over 3.35 TB/s, about 2 us;
// the flops are a fraction of a microsecond at the card's rate.  The
// tensor-core body is latency-bound: its phases (the copies, the cumsum,
// the scores, y, the state update) run one after another in each block,
// and taking every product out saves only about a third of its time (the
// "no products" variant of repro_torch/launch/variants.py; PERF.md).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;            // rows (and keys) of a score tile
constexpr int kCols = 16;            // state / output columns p per block
constexpr int kSub = kTile / 16;     // rows (and keys) per thread in a score tile
constexpr int kMaxState = 256;

// The sum of the earlier lanes' `run` (an exclusive warp scan).
__device__ __forceinline__ float earlier_lanes(float run, int lane) {
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const float before = __shfl_up_sync(0xffffffffu, incl, 1);
  return lane == 0 ? 0.f : before;
}

// Inclusive cumulative sum of dt * a over a chunk of q rows into cs, by one
// warp: each lane sums a contiguous segment (8 loads in flight at a time),
// then a shuffle scan adds the earlier segments' totals.
__device__ __forceinline__ void chunk_cumsum(float* cs, const float* __restrict__ dt,
                                             size_t tok0, int n_heads, int h, float ah, int q,
                                             int lane) {
  const int per = (q + 31) / 32;
  const int lo = min(lane * per, q);
  const int hi = min(lo + per, q);
  float run = 0.f;
  for (int i0 = lo; i0 < hi; i0 += 8) {
    float d[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) d[u] = i0 + u < hi ? dt[(tok0 + i0 + u) * n_heads + h] : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (i0 + u < hi) {
        run += d[u] * ah;
        cs[i0 + u] = run;
      }
    }
  }
  const float before = earlier_lanes(run, lane);
  for (int i = lo; i < hi; ++i) cs[i] += before;
}

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

    if (tid < 32) chunk_cumsum(cs, dt, tok0, n_heads, h, ah, q, lane);

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

// ---- The tensor-core body: bf16 x, B and C -------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 64;        // rows (and keys) of a tile: 16 a warp
// State / output columns p per block: 64, or 32 at N = 256, where the
// state update's accumulators (N / 8 x 4 a thread at 64) would spill.
__host__ __device__ constexpr int cols_for(int n) { return n >= 256 ? 32 : 64; }
constexpr int kMaxChunk = 256;

constexpr size_t smem_bytes(int n) {
  const int cols = cols_for(n);
  return sizeof(float) * (3 * kMaxChunk + cols * (n + 4)) +
         sizeof(bf16) * (2 * kRows * (n + 8) + kRows * (cols + 8) + cols * (n + 8));
}

// Two bf16 of an mma operand times (w0, w1) in f32, split into hi = bf16(v)
// and lo = bf16(v - hi): hi + lo keeps ~16 bits of v.
__device__ __forceinline__ void scale_split(uint32_t packed, float w0, float w1, uint32_t& hi,
                                            uint32_t& lo) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&packed));
  const float a = v.x * w0, b = v.y * w1;
  hi = pack_bf16(a, b);
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = pack_bf16(a - h.x, b - h.y);
}

// One block per (b, head, cols_for(N) columns of P); 4 warps, warp w owns rows
// 16w .. 16w + 15 of a 64-row tile for the scores and y, and a (16 p x
// kN / (4 / (kCols / 16)) n) slice of the state update.
template <int kN>
__global__ void __launch_bounds__(kThreads) ssd_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const bf16* __restrict__ bm, const bf16* __restrict__ cm,
    const float* __restrict__ init_state, bf16* __restrict__ y,
    float* __restrict__ final_state, int s_len, int n_heads, int p_dim, int chunk) {
  constexpr int kNP = kN + 8;     // bf16 row pitch of C, B and the bf16 state (16 B pad)
  constexpr int kSP = kN + 4;     // f32 row pitch of the state
  constexpr int kCols = cols_for(kN);
  constexpr int kXP = kCols + 8;  // bf16 row pitch of x
  constexpr int kTM = kCols / 16;            // m-tiles (of p) of the state update
  constexpr int kNT = kN / 8 / (kWarps / kTM);  // its n-tiles a warp
  static_assert(kNT % 2 == 0 && kN % 16 == 0, "state tiles come in pairs");
  static_assert(kNT <= 16, "the state update's accumulators fit beside y's");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cs = reinterpret_cast<float*>(smem_raw);  // cumulative log-decay of the chunk
  float* dts = cs + kMaxChunk;                      // dt of each row (0 past the chunk)
  float* wdt = dts + kMaxChunk;                     // exp(cs_last - cs_j) dt_j
  float* st = wdt + kMaxChunk;                      // kCols x kN: the carried state, f32
  bf16* c_s = reinterpret_cast<bf16*>(st + kCols * kSP);  // 64 x kN: C rows of the row tile
  bf16* b_s = c_s + kRows * kNP;                    // 64 x kN: B rows of the key tile
  bf16* x_s = b_s + kRows * kNP;                    // 64 x kCols: x of the key tile
  bf16* sb = x_s + kRows * kXP;                     // kCols x kN: the state, bf16

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int p0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const float ah = a[h];
  const size_t row_stride = static_cast<size_t>(n_heads) * p_dim;  // x / y per token
  const size_t xcol = static_cast<size_t>(h) * p_dim + p0;

  auto load_rows = [&](bf16* dst, const bf16* src, int valid) {  // 64 rows of kN
    constexpr int kPer = kN / 8;
    for (int e = tid; e < kRows * kPer; e += kThreads) {
      const int r = e / kPer;
      const int ch = e - r * kPer;
      cp_async16(dst + r * kNP + ch * 8, src + static_cast<size_t>(r < valid ? r : 0) * kN + ch * 8,
                 r < valid);
    }
  };
  auto load_x = [&](size_t tok, int valid) {  // 64 rows of kCols
    constexpr int kPer = kCols / 8;
    for (int e = tid; e < kRows * kPer; e += kThreads) {
      const int r = e / kPer;
      const int ch = e - r * kPer;
      cp_async16(x_s + r * kXP + ch * 8,
                 x + (tok + (r < valid ? r : 0)) * row_stride + xcol + ch * 8, r < valid);
    }
  };
  auto load_keys = [&](size_t tok, int valid) {
    load_rows(b_s, bm + tok * kN, valid);
    load_x(tok, valid);
  };

  // ldmatrix row addresses (see the prefill kernel): A from row-major
  // [row][k]; B from [n][k] (non-trans) or [k][n] (.trans).
  const bf16* c_a = c_s + (16 * warp + (lane & 15)) * kNP + (lane >> 4) * 8;
  const bf16* b_nk = b_s + ((lane & 7) + (lane >> 4) * 8) * kNP + ((lane >> 3) & 1) * 8;
  const bf16* x_kn = x_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * kXP + (lane >> 4) * 8;
  const bf16* s_nk = sb + ((lane & 7) + (lane >> 4) * 8) * kNP + ((lane >> 3) & 1) * 8;
  const int mt = warp % kTM;                  // the state update's m-tile
  const int n_base = (warp / kTM) * kNT * 8;  // and its first column n
  const bf16* x_t = x_s + ((lane & 7) + (lane >> 4) * 8) * kXP + mt * 16 + ((lane >> 3) & 1) * 8;
  const bf16* b_kn = b_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * kNP + n_base + (lane >> 4) * 8;

  bool state_f32 = true;   // st holds the state (its copies issued, not yet awaited)
  bool state_bf = false;   // sb holds it in bf16
  for (int t0 = 0; t0 < s_len; t0 += chunk) {
    const int q = min(chunk, s_len - t0);
    const int q_pad = (q + kRows - 1) / kRows * kRows;
    const size_t tok0 = static_cast<size_t>(b) * s_len + t0;
    // Warp 0's dt loads go first, ahead of the tiles' and the state's
    // copies: the cumsum waits on them.  A lane holds a segment of at most
    // 8 rows (q <= 256).
    const int per = (q + 31) / 32;
    const int seg_lo = min(lane * per, q);
    const int seg_hi = min(seg_lo + per, q);
    float dseg[8];
    if (warp == 0) {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        dseg[u] = seg_lo + u < seg_hi ? dt[(tok0 + seg_lo + u) * n_heads + h] : 0.f;
    }
    __syncthreads();  // the previous chunk's readers of cs, the tiles and st are done
    load_rows(c_s, cm + tok0 * kN, q);
    load_keys(tok0, q);
    cp_async_commit();
    if (t0 == 0) {
      // The initial state's copies go last, so that the first tiles can be
      // awaited alone: they land under the cumsum and the scores.
      constexpr int kPer = kN / 4;
      for (int e = tid; e < kCols * kPer; e += kThreads) {
        const int p = e / kPer;
        const int ch = e - p * kPer;
        if (init_state != nullptr)
          cp_async16(st + p * kSP + ch * 4,
                     init_state + (static_cast<size_t>(bh) * p_dim + p0 + p) * kN + ch * 4, true);
        else
          *reinterpret_cast<float4*>(st + p * kSP + ch * 4) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      cp_async_commit();
      state_f32 = false;
    }
    if (warp == 0) {  // the cumsum of dt * a, and dt itself, 0 past the chunk
      float run = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (seg_lo + u < seg_hi) {
          run += dseg[u] * ah;
          cs[seg_lo + u] = run;
          dts[seg_lo + u] = dseg[u];
        }
      }
      const float before = earlier_lanes(run, lane);
      for (int i = seg_lo; i < seg_hi; ++i) cs[i] += before;
      for (int i = q + lane; i < q_pad; i += 32) cs[i] = dts[i] = 0.f;
    }
    __syncthreads();
    const float cs_last = cs[q - 1];
    for (int j = tid; j < q_pad; j += kThreads)
      wdt[j] = j < q ? expf(cs_last - cs[j]) * dts[j] : 0.f;
    if (state_f32) cp_async_wait<0>();
    else cp_async_wait<1>();
    __syncthreads();
    int c_tile = 0, k_tile = 0;  // the row tile in c_s, the key tile in b_s / x_s
    // The state update's products, (wdt o x)^T B: the A operand (wdt o x)^T
    // is split into bf16 hi + lo against the exact B, both products into one
    // f32 accumulator; state' = exp(cs_last) state + the sum, after y.  They
    // need no state, so they run before y, while its copies land.
    float sacc[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sacc[i][c] = 0.f;
    for (int k0 = 0; k0 < q; k0 += kRows) {
      if (k_tile != k0) {
        __syncthreads();
        load_keys(tok0 + k0, q - k0);
        cp_async_commit();
        cp_async_wait<0>();
        state_f32 = true;
        __syncthreads();
        k_tile = k0;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ax[4], hi[4], lo[4];
        ldsm_x4_trans(ax, x_t + kk * 16 * kXP);
        const int j = k0 + kk * 16 + 2 * t4;
        scale_split(ax[0], wdt[j], wdt[j + 1], hi[0], lo[0]);
        scale_split(ax[1], wdt[j], wdt[j + 1], hi[1], lo[1]);
        scale_split(ax[2], wdt[j + 8], wdt[j + 9], hi[2], lo[2]);
        scale_split(ax[3], wdt[j + 8], wdt[j + 9], hi[3], lo[3]);
        constexpr int kBatch = kNT / 2 < 4 ? kNT / 2 : 4;  // B loads, then their products
#pragma unroll
        for (int np0 = 0; np0 < kNT / 2; np0 += kBatch) {
          uint32_t bf[kBatch][4];
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            ldsm_x4_trans(bf[u], b_kn + kk * 16 * kNP + (np0 + u) * 16);
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int np = np0 + u;
            mma_bf16(sacc[2 * np], hi, bf[u][0], bf[u][1]);
            mma_bf16(sacc[2 * np + 1], hi, bf[u][2], bf[u][3]);
            mma_bf16(sacc[2 * np], lo, bf[u][0], bf[u][1]);
            mma_bf16(sacc[2 * np + 1], lo, bf[u][2], bf[u][3]);
          }
        }
      }
    }

    for (int r0 = 0; r0 < q; r0 += kRows) {
      if (c_tile != r0) {
        __syncthreads();
        load_rows(c_s, cm + (tok0 + r0) * kN, q - r0);
        cp_async_commit();
        cp_async_wait<0>();
        state_f32 = true;
        __syncthreads();
        c_tile = r0;
      }
      const int ia = r0 + 16 * warp + g;  // this thread's rows: ia and ia + 8
      const int ib = ia + 8;
      float yacc[kCols / 8][4];
#pragma unroll
      for (int i = 0; i < kCols / 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) yacc[i][c] = 0.f;

      for (int k0 = 0; k0 <= r0; k0 += kRows) {
        if (k_tile != k0) {
          __syncthreads();
          load_keys(tok0 + k0, q - k0);
          cp_async_commit();
          cp_async_wait<0>();
          state_f32 = true;
          __syncthreads();
          k_tile = k0;
        }
        // Key n-tile pairs wholly above this warp's rows (the diagonal tile)
        // are masked out: skip their products.
        const int n_pairs = k0 < r0 ? 4 : warp + 1;
        // S = C B^T: 16 rows x 64 keys, k over N.
        float sc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) {
          // A k-step's fragment loads first, then its products: one load
          // latency a k-step (ldmatrix and mma.sync stay in program order).
          uint32_t af[4], bf[4][4];
          ldsm_x4(af, c_a + kk * 16);
#pragma unroll
          for (int np = 0; np < 4; ++np)
            if (np < n_pairs) ldsm_x4(bf[np], b_nk + np * 16 * kNP + kk * 16);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (np < n_pairs) {
              mma_bf16(sc[2 * np], af, bf[np][0], bf[np][1]);
              mma_bf16(sc[2 * np + 1], af, bf[np][2], bf[np][3]);
            }
          }
        }
        // Mask by position before the exponential, then the decay and dt in
        // f32: (S o L)_ij dt_j, rounded to bf16 as the A operand of the
        // product with x.
        uint32_t pa[4][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          float v[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = c < 2 ? ia : ib;
            const int j = k0 + nt * 8 + 2 * t4 + (c & 1);
            v[c] = (j <= i && i < q) ? sc[nt][c] * expf(cs[i] - cs[j]) * dts[j] : 0.f;
          }
          pa[nt >> 1][(nt & 1) * 2] = pack_bf16(v[0], v[1]);
          pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
        }
        // y += (S o L dt) x: 16 rows x kCols, k over the 64 keys.
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < n_pairs) {
            uint32_t vf[kCols / 16][4];
#pragma unroll
            for (int pp = 0; pp < kCols / 16; ++pp)
              ldsm_x4_trans(vf[pp], x_kn + kk * 16 * kXP + pp * 16);
#pragma unroll
            for (int pp = 0; pp < kCols / 16; ++pp) {
              mma_bf16(yacc[2 * pp], pa[kk], vf[pp][0], vf[pp][1]);
              mma_bf16(yacc[2 * pp + 1], pa[kk], vf[pp][2], vf[pp][3]);
            }
          }
        }
      }

      // The carried state's term: exp(cs_i) C_i . state[p], the state as
      // the bf16 B operand.
      if (!state_bf) {
        if (!state_f32) cp_async_wait<0>();
        state_f32 = true;
        __syncthreads();
        for (int e = tid; e < kCols * kN / 2; e += kThreads) {
          const int p = e / (kN / 2);
          const int k = 2 * (e - p * (kN / 2));
          *reinterpret_cast<uint32_t*>(sb + p * kNP + k) =
              pack_bf16(st[p * kSP + k], st[p * kSP + k + 1]);
        }
        __syncthreads();
        state_bf = true;
      }
      float off[kCols / 8][4];
#pragma unroll
      for (int i = 0; i < kCols / 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) off[i][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        uint32_t af[4], bf[kCols / 16][4];
        ldsm_x4(af, c_a + kk * 16);
#pragma unroll
        for (int pp = 0; pp < kCols / 16; ++pp) ldsm_x4(bf[pp], s_nk + pp * 16 * kNP + kk * 16);
#pragma unroll
        for (int pp = 0; pp < kCols / 16; ++pp) {
          mma_bf16(off[2 * pp], af, bf[pp][0], bf[pp][1]);
          mma_bf16(off[2 * pp + 1], af, bf[pp][2], bf[pp][3]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = half ? ib : ia;
        if (i < q) {
          const float e = expf(cs[i]);
          bf16* out = y + (tok0 + i) * row_stride + xcol + 2 * t4;
#pragma unroll
          for (int pt = 0; pt < kCols / 8; ++pt)
            *reinterpret_cast<uint32_t*>(out + pt * 8) =
                pack_bf16(yacc[pt][2 * half] + e * off[pt][2 * half],
                          yacc[pt][2 * half + 1] + e * off[pt][2 * half + 1]);
        }
      }
    }

    // The new state: back into st and sb for the next chunk, or, after the
    // last chunk, straight from the accumulators into final_state.
    __syncthreads();  // every reader of sb (the y term) is done
    const float total = expf(cs_last);
    const bool last = t0 + chunk >= s_len;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = mt * 16 + g + half * 8;
        const int n = n_base + nt * 8 + 2 * t4;
        const float v0 = total * st[p * kSP + n] + sacc[nt][2 * half];
        const float v1 = total * st[p * kSP + n + 1] + sacc[nt][2 * half + 1];
        if (last) {
          *reinterpret_cast<float2*>(final_state +
                                     (static_cast<size_t>(bh) * p_dim + p0 + p) * kN + n) =
              make_float2(v0, v1);
        } else {
          *reinterpret_cast<float2*>(st + p * kSP + n) = make_float2(v0, v1);
          *reinterpret_cast<uint32_t*>(sb + p * kNP + n) = pack_bf16(v0, v1);
        }
      }
  }
}

template <int kN>
cudaError_t launch_tc(const void* x, const void* dt, const void* a, const void* bm,
                      const void* cm, const void* init_state, void* y, void* final_state,
                      int batch, int s_len, int n_heads, int p_dim, int chunk,
                      cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(kN);
  cudaError_t err = allow_smem(ssd_tc_kernel<kN>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(batch * n_heads, p_dim / cols_for(kN));
  ssd_tc_kernel<kN><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const bf16*>(bm), static_cast<const bf16*>(cm),
      static_cast<const float*>(init_state), static_cast<bf16*>(y),
      static_cast<float*>(final_state), s_len, n_heads, p_dim, chunk);
  return cudaGetLastError();
}

// Whether the tensor-core body takes these inputs: bf16, N a power of two
// in [32, 256], P a multiple of cols_for(N), a chunk of at most 256 rows, and
// 16-byte aligned rows.
bool takes(int dtype, const void* x, const void* bm, const void* cm, const void* init_state,
           const void* y, const void* final_state, int p_dim, int n_state, int chunk) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return dtype == DTYPE_BF16 &&
         (n_state == 32 || n_state == 64 || n_state == 128 || n_state == 256) &&
         p_dim % cols_for(n_state) == 0 && chunk <= kMaxChunk && aligned(x) &&
         aligned(bm) && aligned(cm) && (init_state == nullptr || aligned(init_state)) &&
         aligned(y) && aligned(final_state);
}

}  // namespace tc

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
      (p_dim + kCols - 1) / kCols > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc::takes(dtype, x, bm, cm, init_state, y, final_state, p_dim, n_state, chunk)) {
    cudaError_t err;
    switch (n_state) {
      case 32: err = tc::launch_tc<32>(x, dt, a, bm, cm, init_state, y, final_state, batch,
                                       s_len, n_heads, p_dim, chunk, s); break;
      case 64: err = tc::launch_tc<64>(x, dt, a, bm, cm, init_state, y, final_state, batch,
                                       s_len, n_heads, p_dim, chunk, s); break;
      case 128: err = tc::launch_tc<128>(x, dt, a, bm, cm, init_state, y, final_state, batch,
                                         s_len, n_heads, p_dim, chunk, s); break;
      default: err = tc::launch_tc<256>(x, dt, a, bm, cm, init_state, y, final_state, batch,
                                        s_len, n_heads, p_dim, chunk, s);
    }
    return static_cast<int>(err);
  }
  if (smem_bytes(n_state, chunk) > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      dtype == DTYPE_BF16
          ? launch<__nv_bfloat16>(x, dt, a, bm, cm, init_state, y, final_state, batch,
                                  s_len, n_heads, p_dim, n_state, chunk, s)
          : launch<float>(x, dt, a, bm, cm, init_state, y, final_state, batch, s_len,
                          n_heads, p_dim, n_state, chunk, s);
  return static_cast<int>(err);
}
