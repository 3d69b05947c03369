// Prefill (chunked) attention for Hopper (sm_90a): a query chunk at absolute
// positions q_offset .. q_offset + Sq - 1 attends keys at 0 .. Sk - 1.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (flash_attention_kernel / ops.flash_attention) and covers what the
// reference model path runs as the jnp flash_attention_ref for a prefill
// chunk: q_offset, GQA (kv head = h / g, indexed directly, no broadcast
// copy), and lengths that are not multiples of the tile (masked here).
//
//   q    (B, Sq, H, hd)     f32 or bf16
//   k/v  (B, Sk, Hkv, hd)
//   out  (B, Sq, H, hd)
//
// One block per (b * H + h, tile of 16 query rows).  The block loops over
// tiles of 32 keys from the window's start up to the causal limit of its
// last row, stages each K/V tile in shared memory as f32 and keeps the
// online-softmax state (m, l, acc) in registers: warp w owns rows 4w..4w+3,
// lane t scores key t of the tile, then lane t accumulates columns
// t, t + 32, ... of P @ V.  Plain FMA; no tensor cores yet.
//
// What bounds it at the serving shapes (Sq = 64, Sk <= a few hundred):
// memory and launch latency.  It reads each K/V tile once per query tile
// (Sq / 16 times in all) and the flops are ~4 * Sq * Sk * hd per head, tiny
// next to the card's rate.  At long prefill it would be bound by FMA
// throughput: mma.sync / wgmma with TMA-fed tiles is the later fast path.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = (kThreads / 32) * kRowsPerWarp;  // 16 query rows
constexpr int kBlockK = 32;                              // one key per lane
constexpr int kMaxDPerLane = 8;                          // head_dim <= 256

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int sq, int sk, int n_heads, int n_kv, int head_dim,
    int q_offset, int causal, int window, float softcap, float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int kvh = h / (n_heads / n_kv);
  const int q0 = blockIdx.y * kBlockQ;
  const int hd = head_dim;
  const int kstride = hd + 1;  // odd row stride: lanes read distinct banks
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* q_s = smem;                   // kBlockQ * hd
  float* k_s = q_s + kBlockQ * hd;     // kBlockK * (hd + 1)
  float* v_s = k_s + kBlockK * kstride;  // kBlockK * hd
  float* p_s = v_s + kBlockK * hd;     // kBlockQ * kBlockK

  for (int i = tid; i < kBlockQ * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int qi = q0 + r;
    q_s[i] = qi < sq ? to_f32(q[((static_cast<size_t>(b) * sq + qi) * n_heads + h) * hd + d])
                     : 0.f;
  }

  // Key range of this query tile: the window's start of its first row up
  // to the causal limit of its last row.
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + kBlockQ, sq) - 1;
  const int k_end = causal ? min(sk, q_hi + 1) : sk;
  int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  k_begin = (k_begin / kBlockK) * kBlockK;
  const int nd = (hd + 31) / 32;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxDPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxDPerLane; ++c) acc[rr][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // previous tile consumed (first pass: q_s written)
    for (int i = tid; i < kBlockK * hd; i += kThreads) {
      const int t = i / hd;
      const int d = i - t * hd;
      const int kj = k0 + t;
      float kv = 0.f, vv = 0.f;
      if (kj < sk) {
        const size_t off = ((static_cast<size_t>(b) * sk + kj) * n_kv + kvh) * hd + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      k_s[t * kstride + d] = kv;
      v_s[t * hd + d] = vv;
    }
    __syncthreads();

    const int kj = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int qi = q0 + r;
      const int qpos = q_offset + qi;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += q_s[r * hd + d] * k_s[lane * kstride + d];
      s = apply_softcap(s * scale, softcap);
      bool ok = kj < sk && qi < sq;
      if (causal) ok = ok && kj <= qpos;
      if (window > 0) ok = ok && (qpos - kj < window);
      s = ok ? s : NEG_INF;
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m[rr] - m_new);
      l[rr] = alpha * l[rr] + warp_sum(p);
      m[rr] = m_new;
      p_s[r * kBlockK + lane] = p;
#pragma unroll
      for (int c = 0; c < kMaxDPerLane; ++c) acc[rr][c] *= alpha;
    }
    __syncwarp();

    // acc += P @ V over this warp's rows; lane owns columns lane + 32 c.
    for (int t = 0; t < kBlockK; ++t) {
      float vv[kMaxDPerLane];
#pragma unroll
      for (int c = 0; c < kMaxDPerLane; ++c) {
        const int d = lane + 32 * c;
        vv[c] = (c < nd && d < hd) ? v_s[t * hd + d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float p = p_s[(warp * kRowsPerWarp + rr) * kBlockK + t];
#pragma unroll
        for (int c = 0; c < kMaxDPerLane; ++c) acc[rr][c] += p * vv[c];
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kRowsPerWarp + rr;
    if (qi >= sq) continue;
    const float denom = l[rr] == 0.f ? 1.f : l[rr];
    T* o = out + ((static_cast<size_t>(b) * sq + qi) * n_heads + h) * hd;
#pragma unroll
    for (int c = 0; c < kMaxDPerLane; ++c) {
      const int d = lane + 32 * c;
      if (c < nd && d < hd) o[d] = from_f32<T>(acc[rr][c] / denom);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int batch,
                   int sq, int sk, int n_heads, int n_kv, int head_dim, int q_offset,
                   int causal, int window, float softcap, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBlockQ) * head_dim +
                       static_cast<size_t>(kBlockK) * (head_dim + 1) +
                       static_cast<size_t>(kBlockK) * head_dim + kBlockQ * kBlockK);
  cudaError_t err = allow_smem(flash_attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_heads, (sq + kBlockQ - 1) / kBlockQ);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, sk, n_heads, n_kv, head_dim, q_offset, causal, window,
      softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v,
                               void* out, int batch, int sq, int sk, int n_heads,
                               int n_kv, int head_dim, int q_offset, int causal,
                               int window, float softcap, float scale, void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || head_dim > 32 * kMaxDPerLane || sq < 1 ||
      sk < 1 || batch < 1 || (sq + kBlockQ - 1) / kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == DTYPE_BF16
          ? launch<__nv_bfloat16>(q, k, v, out, batch, sq, sk, n_heads, n_kv, head_dim,
                                  q_offset, causal, window, softcap, scale, s)
          : launch<float>(q, k, v, out, batch, sq, sk, n_heads, n_kv, head_dim, q_offset,
                          causal, window, softcap, scale, s);
  return static_cast<int>(err);
}
