// Paged decode attention for Hopper (sm_90a): one new token per sequence,
// keys and values read from the paged KV pool through the page table.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::_paged_kernel
// (called through paged_attention_kernel / ops.paged_attention).  There the
// page stream was the sequential innermost grid axis and the online softmax
// state lived in VMEM scratch across it; here blocks run in parallel and in
// no order, so one thread block owns one (sequence b, kv head) pair and walks
// that sequence's pages in a loop, keeping m, l and acc in f32.
//
//   q           (B, H, hd)                 H = Hkv * g query heads
//   k/v pool    (num_blocks, bs, Hkv, hd)  f32 or bf16
//   page_table  (B, n_pages) int32         logical page j -> physical block
//   cur_len     (B,) int32                 position of the token decoded now
//   out         (B, H, hd)
//
// The block reads its own page_table[b, j] and cur_len[b].  It walks pages
// only while j * bs <= cur_len (and, with a window, while the page reaches
// into the window), stages each page's bs x hd slice of K and V for its kv
// head in shared memory, and scores the g query heads of that kv head.
// Positions are masked by position, never by page id: table entries past
// cur_len point at trash block 0, whose contents are garbage.  A shielded or
// free slot has cur_len 0 and an all-trash row; it reads one page and comes
// out finite.  The output divides by l, guarded l == 0 -> 1.
//
// What bounds it: memory.  Per (b, kv head) it must read the K and V bytes of
// the live pages once and does 4 * g * hd flops per key, far below the
// ~295 flops/byte the H100 needs before compute binds.  Known weakness: the
// grid is B x Hkv blocks (32 at B=4, Hkv=8) on 132 SMs, so most of the card
// idles at small batch; splitting each sequence's pages over several blocks
// with a second reduction pass is later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;  // query heads per kv head
constexpr int kMaxDPerThread = 2;  // head_dim <= kThreads * 2 = 256

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ page_table,
    const int* __restrict__ cur_len, T* __restrict__ out, int n_heads, int n_kv,
    int head_dim, int block_size, int n_pages, int window, float softcap,
    float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = n_heads / n_kv;
  const int hd = head_dim;
  const int bs = block_size;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* q_s = smem;             // g * hd
  float* k_s = q_s + g * hd;     // bs * hd
  float* v_s = k_s + bs * hd;    // bs * hd
  float* p_s = v_s + bs * hd;    // g * bs: scores, then probabilities
  float* m_s = p_s + g * bs;     // g
  float* l_s = m_s + g;          // g
  float* alpha_s = l_s + g;      // g

  const size_t q_row0 = (static_cast<size_t>(b) * n_heads + kvh * g) * hd;
  for (int i = tid; i < g * hd; i += kThreads) q_s[i] = to_f32(q[q_row0 + i]);
  if (tid < g) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[kMaxGroup][kMaxDPerThread];
#pragma unroll
  for (int r = 0; r < kMaxGroup; ++r)
#pragma unroll
    for (int c = 0; c < kMaxDPerThread; ++c) acc[r][c] = 0.f;

  const int cur = cur_len[b];
  const int last_page = min(n_pages - 1, cur / bs);
  const int* row = page_table + static_cast<size_t>(b) * n_pages;

  for (int j = 0; j <= last_page; ++j) {
    if (window > 0 && cur - (j * bs + bs - 1) >= window) continue;  // behind the window
    const size_t page = static_cast<size_t>(row[j]);
    __syncthreads();  // the previous page's K/V/p are consumed (and q_s is ready)
    for (int i = tid; i < bs * hd; i += kThreads) {
      const int t = i / hd;
      const int d = i - t * hd;
      const size_t off = ((page * bs + t) * n_kv + kvh) * hd + d;
      k_s[i] = to_f32(k_pool[off]);
      v_s[i] = to_f32(v_pool[off]);
    }
    __syncthreads();

    // Scores: one warp per (query head, key) pair, lanes split head_dim.
    for (int idx = warp; idx < g * bs; idx += kWarps) {
      const int r = idx / bs;
      const int t = idx - r * bs;
      float part = 0.f;
      for (int d = lane; d < hd; d += 32) part += q_s[r * hd + d] * k_s[t * hd + d];
      const float dot = warp_sum(part);
      if (lane == 0) {
        const float s = apply_softcap(dot * scale, softcap);
        const int pos = j * bs + t;
        bool ok = pos <= cur;
        if (window > 0) ok = ok && (cur - pos < window);
        p_s[idx] = ok ? s : NEG_INF;
      }
    }
    __syncthreads();

    // Online softmax update, one thread per query head.
    if (tid < g) {
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
      for (int r = 0; r < kMaxGroup; ++r)
        if (r < g) acc[r][c] *= alpha_s[r];
      for (int t = 0; t < bs; ++t) {
        const float vv = v_s[t * hd + d];
#pragma unroll
        for (int r = 0; r < kMaxGroup; ++r)
          if (r < g) acc[r][c] += p_s[r * bs + t] * vv;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int c = 0; c < kMaxDPerThread; ++c) {
    const int d = tid + c * kThreads;
    if (d >= hd) continue;
#pragma unroll
    for (int r = 0; r < kMaxGroup; ++r) {
      if (r >= g) continue;
      const float l = l_s[r] == 0.f ? 1.f : l_s[r];
      out[q_row0 + static_cast<size_t>(r) * hd + d] = from_f32<T>(acc[r][c] / l);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* page_table, const void* cur_len, void* out, int batch,
                   int n_heads, int n_kv, int head_dim, int block_size, int n_pages,
                   int window, float softcap, float scale, cudaStream_t stream) {
  const int g = n_heads / n_kv;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(g) * head_dim + 2u * block_size * head_dim +
                       static_cast<size_t>(g) * block_size + 3u * g);
  cudaError_t err = allow_smem(paged_attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  paged_attention_kernel<T><<<dim3(batch, n_kv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(cur_len), static_cast<T*>(out), n_heads, n_kv, head_dim,
      block_size, n_pages, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int paged_attention(int dtype, const void* q, const void* k_pool,
                               const void* v_pool, const void* page_table,
                               const void* cur_len, void* out, int batch, int n_heads,
                               int n_kv, int head_dim, int block_size, int n_pages,
                               int window, float softcap, float scale, void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || n_heads / n_kv > kMaxGroup ||
      head_dim > kThreads * kMaxDPerThread || n_pages < 1 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == DTYPE_BF16
          ? launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, cur_len, out, batch,
                                  n_heads, n_kv, head_dim, block_size, n_pages, window,
                                  softcap, scale, s)
          : launch<float>(q, k_pool, v_pool, page_table, cur_len, out, batch, n_heads,
                          n_kv, head_dim, block_size, n_pages, window, softcap, scale, s);
  return static_cast<int>(err);
}
