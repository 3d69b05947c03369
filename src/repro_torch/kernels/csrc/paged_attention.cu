// Paged decode attention for Hopper (sm_90a): keys and values read from the
// paged KV pool through the page table, for a block of q_len >= 1 new tokens
// per sequence, over full-precision or quantized (int8 / fp8 e4m3) pages.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::_paged_kernel in
// all four of its uses: ops.paged_attention (q_len 1), paged_attention_multi
// (q_len > 1, the speculative verify step), and their fused-dequant twins
// paged_attention_quant / paged_attention_multi_quant.  There the page stream
// was the sequential innermost grid axis and the online softmax state lived
// in VMEM scratch across it; here blocks run in parallel and in no order, so
// one thread block owns one (sequence b, kv head, tile of query rows) and
// walks that sequence's pages in a loop, keeping m, l and acc in f32.
//
//   q           (B, q_len, H, hd)          H = Hkv * g query heads
//   k/v pool    (num_blocks, bs, Hkv, hd)  f32 / bf16 (the type of q), or
//                                          int8 / fp8 e4m3 codes
//   k/v scale   (num_blocks, Hkv) f32      quantized pools only
//   page_table  (B, n_pages) int32         logical page j -> physical block
//   cur_len     (B,) int32                 position of token 0 of the block
//   out         (B, q_len, H, hd)
//
// Rows.  The q_len * g query rows of one (b, kv head) are ordered r = t*g + i
// (token t, group member i); row r sits at position cur_len + r / g and sees
// keys at positions <= cur_len + r / g (causal within the block) and, with a
// window, cur_len + r / g - pos < window.  q is read in place as
// q[b, t, kvh*g + i, :]: no transposed copy.  A block holds at most
// kRowTile rows in registers; more rows (g > 16, or a long draft block) are
// split into balanced tiles along grid z, each reading the pages again.
//
// Pages.  A block walks pages j while j * bs <= its youngest row's position
// (clamped to the table), and skips a page only when every row of the tile
// masks it: behind the window of its oldest row.  It stages each page's
// bs x hd slice of K and V for its kv head in f32 shared memory; for a
// quantized pool it reads k_scale[page, kvh] and v_scale[page, kvh] once
// per page, through the same page_table[b, j], and dequantizes while staging
// (code * scale, in f32, as the TPU kernel does).  Positions are masked by
// position, never by page id: table entries past a sequence's pages point
// at trash block 0, whose contents are garbage, and a shielded or free slot
// (cur_len 0, all-trash row) reads one page and comes out finite.  The output
// divides by l, guarded l == 0 -> 1.
//
// What bounds it: memory.  Per (b, kv head) it must read the K and V bytes of
// the live positions once and does 4 * q_len * g * hd flops per key, far
// below the ~295 flops/byte the H100 needs before compute binds; int8 / fp8
// codes halve the K/V bytes of bf16.  Known weakness: the grid is B x Hkv
// (x row tiles) blocks, 32-64 at the serving shapes on 132 SMs, with four
// barriers per page, so it is latency-bound at small batch; splitting each
// sequence's pages over several blocks with a second reduction pass, and
// 16-byte vector loads, are later work.

#include <cuda_fp8.h>

#include <cstdint>

#include "common.cuh"

// The quantized pools' code types (f32 and bf16 are in common.cuh; beside
// them, outside the namespace below, so that one overload set is found).
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 16;       // query rows a block keeps in registers
constexpr int kMaxDPerThread = 2;  // head_dim <= kThreads * 2 = 256

// T: the type of q and out.  C: the pool's element type.  kQuant: C holds
// codes to be multiplied by the per-(page, kv head) scales.
template <typename T, typename C, bool kQuant>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const C* __restrict__ k_pool, const C* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ page_table, const int* __restrict__ cur_len,
    T* __restrict__ out, int q_len, int n_heads, int n_kv, int head_dim, int block_size,
    int n_pages, int tile_rows, int window, float softcap, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = n_heads / n_kv;
  const int hd = head_dim;
  const int bs = block_size;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.z * tile_rows;               // first row of this tile
  const int nr = min(tile_rows, q_len * g - r0);       // rows of this tile

  float* q_s = smem;                    // tile_rows * hd
  float* k_s = q_s + tile_rows * hd;    // bs * hd
  float* v_s = k_s + bs * hd;           // bs * hd
  float* p_s = v_s + bs * hd;           // tile_rows * bs: scores, then probabilities
  float* m_s = p_s + tile_rows * bs;    // tile_rows
  float* l_s = m_s + tile_rows;         // tile_rows
  float* alpha_s = l_s + tile_rows;     // tile_rows
  int* qpos_s = reinterpret_cast<int*>(alpha_s + tile_rows);  // tile_rows: row positions

  // Offset of tile row rr in q and out: token t = r / g, head kvh * g + r % g.
  auto row_offset = [&](int rr) -> size_t {
    const int r = r0 + rr;
    const int t = r / g;
    return ((static_cast<size_t>(b) * q_len + t) * n_heads + kvh * g + (r - t * g)) * hd;
  };

  for (int i = tid; i < nr * hd; i += kThreads) {
    const int rr = i / hd;
    q_s[i] = to_f32(q[row_offset(rr) + (i - rr * hd)]);
  }
  const int cur = cur_len[b];
  if (tid < nr) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
    qpos_s[tid] = cur + (r0 + tid) / g;  // once here, not per score
  }
  float acc[kRowTile][kMaxDPerThread];
#pragma unroll
  for (int r = 0; r < kRowTile; ++r)
#pragma unroll
    for (int c = 0; c < kMaxDPerThread; ++c) acc[r][c] = 0.f;

  const int oldest = cur + r0 / g;               // position of the tile's first row
  const int youngest = cur + (r0 + nr - 1) / g;  // and of its last
  const int last_page = min(n_pages - 1, youngest / bs);
  const int* row = page_table + static_cast<size_t>(b) * n_pages;

  for (int j = 0; j <= last_page; ++j) {
    if (window > 0 && oldest - (j * bs + bs - 1) >= window) continue;  // behind every window
    const size_t page = static_cast<size_t>(row[j]);
    float ks = 1.f, vs = 1.f;
    if constexpr (kQuant) {
      ks = k_scale[page * n_kv + kvh];
      vs = v_scale[page * n_kv + kvh];
    }
    __syncthreads();  // the previous page's K/V/p are consumed (and q_s is ready)
    for (int i = tid; i < bs * hd; i += kThreads) {
      const int t = i / hd;
      const int d = i - t * hd;
      const size_t off = ((page * bs + t) * n_kv + kvh) * hd + d;
      if constexpr (kQuant) {
        k_s[i] = to_f32(k_pool[off]) * ks;
        v_s[i] = to_f32(v_pool[off]) * vs;
      } else {
        k_s[i] = to_f32(k_pool[off]);
        v_s[i] = to_f32(v_pool[off]);
      }
    }
    __syncthreads();

    // Scores: one warp per (query row, key) pair, lanes split head_dim.
    for (int idx = warp; idx < nr * bs; idx += kWarps) {
      const int r = idx / bs;
      const int t = idx - r * bs;
      float part = 0.f;
      for (int d = lane; d < hd; d += 32) part += q_s[r * hd + d] * k_s[t * hd + d];
      const float dot = warp_sum(part);
      if (lane == 0) {
        const float s = apply_softcap(dot * scale, softcap);
        const int pos = j * bs + t;
        const int qpos = qpos_s[r];
        bool ok = pos <= qpos;
        if (window > 0) ok = ok && (qpos - pos < window);
        p_s[idx] = ok ? s : NEG_INF;
      }
    }
    __syncthreads();

    // Online softmax update, one thread per query row.
    if (tid < nr) {
      const int r = tid;
      float mx = NEG_INF;
      for (int t = 0; t < bs; ++t) mx = fmaxf(mx, p_s[r * bs + t]);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = expf(p_s[r * bs + t] - m_new);
        p_s[r * bs + t] = p;
        sum += p;
      }
      const float alpha = expf(m_old - m_new);
      l_s[r] = alpha * l_s[r] + sum;
      m_s[r] = m_new;
      alpha_s[r] = alpha;
    }
    __syncthreads();

    // acc = alpha * acc + p @ V; thread tid owns columns tid + c * kThreads.
#pragma unroll
    for (int c = 0; c < kMaxDPerThread; ++c) {
      const int d = tid + c * kThreads;
      if (d >= hd) continue;
#pragma unroll
      for (int r = 0; r < kRowTile; ++r)
        if (r < nr) acc[r][c] *= alpha_s[r];
      for (int t = 0; t < bs; ++t) {
        const float vv = v_s[t * hd + d];
#pragma unroll
        for (int r = 0; r < kRowTile; ++r)
          if (r < nr) acc[r][c] += p_s[r * bs + t] * vv;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int c = 0; c < kMaxDPerThread; ++c) {
    const int d = tid + c * kThreads;
    if (d >= hd) continue;
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) {
      if (r >= nr) continue;
      const float l = l_s[r] == 0.f ? 1.f : l_s[r];
      out[row_offset(r) + d] = from_f32<T>(acc[r][c] / l);
    }
  }
}

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *page_table, *cur_len;
  void* out;
  int batch, q_len, n_heads, n_kv, head_dim, block_size, n_pages, window;
  float softcap, scale;
  cudaStream_t stream;
};

template <typename T, typename C, bool kQuant>
cudaError_t launch(const Args& a) {
  const int rows = a.q_len * (a.n_heads / a.n_kv);
  const int tiles = (rows + kRowTile - 1) / kRowTile;
  const int tile_rows = (rows + tiles - 1) / tiles;  // balanced tiles
  const size_t smem = sizeof(float) * (static_cast<size_t>(tile_rows) * a.head_dim +
                                       2u * a.block_size * a.head_dim +
                                       static_cast<size_t>(tile_rows) * a.block_size +
                                       4u * tile_rows);  // m, l, alpha, qpos
  auto kernel = paged_attention_kernel<T, C, kQuant>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.batch, a.n_kv, tiles), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const C*>(a.k_pool),
      static_cast<const C*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.page_table),
      static_cast<const int*>(a.cur_len), static_cast<T*>(a.out), a.q_len, a.n_heads,
      a.n_kv, a.head_dim, a.block_size, a.n_pages, tile_rows, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_codes(int code, const Args& a) {
  switch (code) {
    case DTYPE_INT8: return launch<T, int8_t, true>(a);
    case DTYPE_FP8: return launch<T, __nv_fp8_e4m3, true>(a);
    default: return cudaErrorInvalidValue;
  }
}

// dtype: the type of q, out (and of the pools when code < 0).  code: the
// quantized pool's code type, or -1 for a full-precision pool.
int run(int dtype, int code, const Args& a) {
  if (a.n_kv <= 0 || a.n_heads % a.n_kv != 0 || a.head_dim < 1 ||
      a.head_dim > kThreads * kMaxDPerThread || a.block_size < 1 || a.n_pages < 1 ||
      a.batch < 1 || a.q_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == DTYPE_F32)
    err = code < 0 ? launch<float, float, false>(a) : launch_codes<float>(code, a);
  else if (dtype == DTYPE_BF16)
    err = code < 0 ? launch<__nv_bfloat16, __nv_bfloat16, false>(a)
                   : launch_codes<__nv_bfloat16>(code, a);
  return static_cast<int>(err);
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 on success).

extern "C" int paged_attention(int dtype, const void* q, const void* k_pool,
                               const void* v_pool, const void* page_table,
                               const void* cur_len, void* out, int batch, int n_heads,
                               int n_kv, int head_dim, int block_size, int n_pages,
                               int window, float softcap, float scale, void* stream) {
  return run(dtype, -1, Args{q, k_pool, v_pool, nullptr, nullptr, page_table, cur_len, out,
                             batch, 1, n_heads, n_kv, head_dim, block_size, n_pages, window,
                             softcap, scale, static_cast<cudaStream_t>(stream)});
}

extern "C" int paged_attention_multi(int dtype, const void* q, const void* k_pool,
                                     const void* v_pool, const void* page_table,
                                     const void* cur_len, void* out, int batch, int q_len,
                                     int n_heads, int n_kv, int head_dim, int block_size,
                                     int n_pages, int window, float softcap, float scale,
                                     void* stream) {
  return run(dtype, -1, Args{q, k_pool, v_pool, nullptr, nullptr, page_table, cur_len, out,
                             batch, q_len, n_heads, n_kv, head_dim, block_size, n_pages,
                             window, softcap, scale, static_cast<cudaStream_t>(stream)});
}

extern "C" int paged_attention_quant(int dtype, int code, const void* q, const void* k_pool,
                                     const void* v_pool, const void* k_scale,
                                     const void* v_scale, const void* page_table,
                                     const void* cur_len, void* out, int batch, int n_heads,
                                     int n_kv, int head_dim, int block_size, int n_pages,
                                     int window, float softcap, float scale, void* stream) {
  if (code < 0) return static_cast<int>(cudaErrorInvalidValue);
  return run(dtype, code, Args{q, k_pool, v_pool, k_scale, v_scale, page_table, cur_len,
                               out, batch, 1, n_heads, n_kv, head_dim, block_size, n_pages,
                               window, softcap, scale, static_cast<cudaStream_t>(stream)});
}

extern "C" int paged_attention_multi_quant(int dtype, int code, const void* q,
                                           const void* k_pool, const void* v_pool,
                                           const void* k_scale, const void* v_scale,
                                           const void* page_table, const void* cur_len,
                                           void* out, int batch, int q_len, int n_heads,
                                           int n_kv, int head_dim, int block_size,
                                           int n_pages, int window, float softcap,
                                           float scale, void* stream) {
  if (code < 0) return static_cast<int>(cudaErrorInvalidValue);
  return run(dtype, code, Args{q, k_pool, v_pool, k_scale, v_scale, page_table, cur_len,
                               out, batch, q_len, n_heads, n_kv, head_dim, block_size,
                               n_pages, window, softcap, scale,
                               static_cast<cudaStream_t>(stream)});
}
