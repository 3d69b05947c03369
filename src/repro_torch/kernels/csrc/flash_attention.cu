// Prefill (chunked) attention for Hopper (sm_90a): a query chunk at absolute
// positions q_offset .. q_offset + Sq - 1 attends keys at 0 .. Sk - 1.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (flash_attention_kernel / ops.flash_attention) and covers what the
// reference model path runs as the jnp flash_attention_ref for a prefill
// chunk: q_offset, GQA (kv head = h / g, indexed directly, no broadcast
// copy), window, softcap, and lengths that are not multiples of the tile
// (masked here).
//
//   q    (B, Sq, H, hd)     f32 or bf16
//   k/v  (B, Sk, Hkv, hd)
//   out  (B, Sq, H, hd)
//
// Two bodies share the entry; the wrapper (kernels/flash_attention.py,
// plan_flash) picks one and passes its tiling:
// * flash_attention_tc_kernel: bf16 q/k/v with head_dim a multiple of 16
//   (the serve's type; every configuration's head_dim, 64 / 128 / 256), on
//   the tensor cores.  Its note is below.
// * flash_attention_simt_kernel: f32 inputs (the card-vs-CPU checks) and a
//   head_dim that is not a multiple of 16.  The first version of this
//   kernel, unchanged: one block per (b * H + h, 16 query rows), K/V tiles
//   of 32 keys staged in shared memory as f32, one key a lane for the
//   scores, plain FMA for P V.
//
// What bounds the function: at the serving shape (Sq = 64 at q_offset 64,
// H = 32 / 8, hd 128) memory, 0.47 us for its 1.6 MB (q, k, v read and out
// written once); its flops, ~4 Sq Sk hd a head, are ~0.1 us of the H100's
// bf16 rate.  At a long context (Sq = 64 at q_offset 1984) the bytes (9.4
// MB, 2.8 us) still bind.  Both are far below
// what one launch and a block's chain of latencies (Q, then K/V tiles, then
// products) take, so the design aims at latency: every SM busy, copies in
// flight while the tensor cores work, K/V read once per kv head a block.
//
// The tensor-core body.
// * Rows.  The Sq * g query rows of one (b, kv head) are ordered r = i * g +
//   j (query i, group member j: query head kvh * g + j at position q_offset
//   + i), so one 16-row m-tile holds all g heads of 16 / g positions, and
//   one staged K/V tile serves the g query heads of its kv head (the old
//   body read every K/V tile g times, once per query head).  q and out are
//   addressed in place: no transposed copy.
// * Grid (m-tiles, Hkv, B); a block is 4 warps on one m-tile of 16 rows,
//   split over the keys: of every 64-key stage, warp w takes the 16-key
//   sub-tile w, runs its own online softmax over those keys, and the 4
//   partial (m, l, acc) are combined in shared memory at the end.  The
//   serve's chunk has 64 x 32 = 2048 query rows, 128 m-tiles: grid (16, 8,
//   1) = 128 blocks of 4 warps, 512 warps in flight on 128 of the 132 SMs,
//   each warp with a quarter of its rows' keys.  One warp per m-tile (no key
//   split) would leave 3 of every SM's 4 schedulers idle at this shape, and
//   at the long context walk all 2048 keys in one chain.  Wider blocks (2 or
//   4 m-tiles sharing each staged K/V tile, fewer key splits) were slower at
//   both shapes timed (PERF.md), so there is one tiling.
// * Copies.  Q (the block's rows, zero past the last) and then K and V, 64
//   keys a stage, go global -> shared in bf16 by 16-byte cp.async copies
//   (a key row of one kv head is hd contiguous elements at a stride of Hkv
//   * hd), into a ring of 3 stages (2 for head_dim 256), so stages i + 1
//   and i + 2 stream in while stage i computes; one barrier a stage.  Rows
//   are padded by 16 bytes so that the 8 row addresses of an ldmatrix fall
//   in distinct banks.  Keys past Sk are zero-filled (and masked).
// * Products.  S = Q K^T and O += P V run as mma.sync m16n8k16 bf16 with
//   f32 accumulators; ldmatrix reads the Q and K fragments, ldmatrix.trans
//   the V fragments.  A warp holds all head_dim columns of its 16 rows
//   (head_dim / 8 accumulator tiles: 64 f32 a lane at 128, 128 at 256; the
//   scores of one 16-key sub-tile take 8 more), so head_dim 256 runs this
//   body too, with no split of P V's columns across warps: ptxas gives it
//   239 registers and no spills (217 at head_dim 128).
// * Softmax in registers, on the score fragments: each quad of lanes holds
//   two rows, whose max and sum are quad shuffles; exp2 with scale * log2(e)
//   folded into the scores (after the softcap, when there is one).  Masked
//   keys get p = 0 and take no part in the max, so a sub-tile a row cannot
//   see leaves its state as it was.  P is rounded to bf16 for P V per
//   16-key sub-tile, as the reference rounds p.astype(v.dtype) per key
//   block; l sums P in f32 before the rounding, as there.
// * Skipping.  A block starts at the window's start of its first row
//   (rounded down to a stage) and stops at the causal limit of its last
//   row; a warp skips each sub-tile that none of its rows may see, so only
//   the edge sub-tiles are masked.

#include "common.cuh"

namespace {

// ---- The SIMT body (f32, or head_dim % 16 != 0) -----------------------------

constexpr int kThreads = 128;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = (kThreads / 32) * kRowsPerWarp;  // 16 query rows
constexpr int kBlockK = 32;                              // one key per lane
constexpr int kMaxDPerLane = 8;                          // head_dim <= 256

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_simt_kernel(
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
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* out, int batch,
                        int sq, int sk, int n_heads, int n_kv, int head_dim, int q_offset,
                        int causal, int window, float softcap, float scale,
                        cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBlockQ) * head_dim +
                       static_cast<size_t>(kBlockK) * (head_dim + 1) +
                       static_cast<size_t>(kBlockK) * head_dim + kBlockQ * kBlockK);
  cudaError_t err = allow_smem(flash_attention_simt_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_heads, (sq + kBlockQ - 1) / kBlockQ);
  flash_attention_simt_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, sk, n_heads, n_kv, head_dim, q_offset, causal, window,
      softcap, scale);
  return cudaGetLastError();
}

// ---- The tensor-core body (bf16, head_dim % 16 == 0) ------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kStageKeys = 64;                 // keys a cp.async stage holds
constexpr int kSubKeys = 16;                   // keys a softmax step takes
constexpr int kSubs = kStageKeys / kSubKeys;   // sub-tiles a stage
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// The ring's depth: 3 stages up to head_dim 128, 2 at 256 (3 would not fit
// in shared memory beside Q).
template <int kNT>
constexpr int kTcStages = kNT <= 16 ? 3 : 2;

// Shared memory of the tensor-core body: Q (16 rows), the K/V ring, and
// the combine's (m, l) a warp row.
template <int kNT>
size_t tc_smem_bytes(int head_dim) {
  const size_t row = static_cast<size_t>(head_dim + 8) * sizeof(bf16);
  return 16 * row + static_cast<size_t>(kTcStages<kNT>) * 2 * kStageKeys * row +
         sizeof(float) * kTcWarps * 16 * 2;
}

// Fragment layout (m16n8, as mma.sync returns it): lane = 4 * gid + tig
// holds rows gid and gid + 8, columns 2 * tig and 2 * tig + 1 of each 8-wide
// n-tile: element c of a fragment is (row gid + 8 * (c / 2), column
// 2 * tig + c % 2).  Scores s[nt][c] cover keys nt * 8 + 2 * tig + c % 2 of
// a sub-tile; acc[n][c] covers head_dim columns n * 8 + 2 * tig + c % 2.
template <int kNT>
__global__ void __launch_bounds__(kTcThreads) flash_attention_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, int sq, int sk, int n_heads, int n_kv, int head_dim,
    int q_offset, int causal, int window, float softcap, float scale) {
  constexpr int kStages = kTcStages<kNT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = n_heads / n_kv;
  const int hd = head_dim;
  const int rows = sq * g;
  const int r0 = blockIdx.x * 16;    // first row of the block
  const int nr = min(16, rows - r0);  // rows of the block
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  const int stride = hd + 8;  // a padded row, in bf16
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv_s = q_s + 16 * stride;  // stage st: K rows, then V rows
  float* ml_s = reinterpret_cast<float*>(kv_s + kStages * 2 * kStageKeys * stride);

  auto row_offset = [&](int r) -> size_t {  // of block row r in q and out
    const int i = (r0 + r) / g;
    return ((static_cast<size_t>(b) * sq + i) * n_heads + kvh * g + (r0 + r - i * g)) * hd;
  };

  // Q by 16-byte copies (rows past nr zero-filled); they join the first
  // stage's copy group.
  const int cpr = hd / 8;  // 16-byte chunks a row
  for (int i = tid; i < 16 * cpr; i += kTcThreads) {
    const int rr = i / cpr;
    const int ch = i - rr * cpr;
    const bool ok = rr < nr;
    cp_async16(q_s + rr * stride + ch * 8, ok ? q + row_offset(rr) + ch * 8 : q, ok);
  }

  // The block's keys: from the window's start of its oldest row (rounded
  // down to a stage) to the causal limit of its youngest.
  const int pos_lo = q_offset + r0 / g;
  const int pos_hi = q_offset + (r0 + nr - 1) / g;
  const int k_end = causal ? min(sk, pos_hi + 1) : sk;
  int k_begin = window > 0 ? max(0, pos_lo - window + 1) : 0;
  k_begin = (k_begin / kStageKeys) * kStageKeys;
  const int n_stages = k_end > k_begin ? (k_end - k_begin + kStageKeys - 1) / kStageKeys : 0;

  // Copies: thread tid owns key row my_key of every stage and its 16-byte
  // chunks my_ch0, my_ch0 + tpr, ... in K and in V alike.
  constexpr int tpr = kTcThreads / kStageKeys;  // threads a key row
  const int my_key = tid / tpr;
  const int my_ch0 = tid - my_key * tpr;
  auto issue = [&](int it) {  // stage it into ring slot it % kStages
    if (it < n_stages) {
      const int key = k_begin + it * kStageKeys + my_key;
      const bool ok = key < sk;
      const size_t off = ((static_cast<size_t>(b) * sk + (ok ? key : 0)) * n_kv + kvh) * hd;
      bf16* k_dst = kv_s + (static_cast<size_t>(it % kStages) * 2 * kStageKeys + my_key) * stride;
      bf16* v_dst = k_dst + kStageKeys * stride;
      for (int ch = my_ch0; ch < cpr; ch += tpr) {
        cp_async16(k_dst + ch * 8, k + off + ch * 8, ok);
        cp_async16(v_dst + ch * 8, v + off + ch * 8, ok);
      }
    }
    cp_async_commit();
  };

  // This thread's two rows (within the block) and their positions; a pad
  // row sees nothing.  The keys some row of the block may see: w_lo..w_hi.
  const int ra = gid;
  const int rb = ra + 8;
  const bool ok_a = ra < nr, ok_b = rb < nr;
  const int qpos_a = q_offset + (r0 + ra) / g;
  const int qpos_b = q_offset + (r0 + rb) / g;
  const int w_lo = window > 0 ? pos_lo - window + 1 : 0;
  const int w_hi = causal ? min(sk - 1, pos_hi) : sk - 1;
  const float scale2 = scale * kLog2e;

  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;  // l: this thread's part
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  // ldmatrix addresses: Q rows (lane & 15) at column half lane >> 4.  Up to
  // head_dim 128 the warp's Q fragments stay in registers (32 a lane),
  // loaded once; at 256 they are read again for each sub-tile.
  const bf16* qa = q_s + (lane & 15) * stride + (lane >> 4) * 8;
  constexpr int kKB = kNT / 2;  // 16-column k-steps of Q K^T
  constexpr bool kQRegs = kNT <= 16;
  uint32_t qf[kQRegs ? kKB : 1][4];

#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) issue(it);
  for (int it = 0; it < n_stages; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage it landed
    __syncthreads();               // everyone's; stage it - 1 is consumed
    issue(it + kStages - 1);
    if constexpr (kQRegs) {
      if (it == 0) {  // Q came with stage 0's copies
#pragma unroll
        for (int kb = 0; kb < kKB; ++kb)
          if (kb * 16 < hd) ldsm_x4(qf[kb], qa + kb * 16);
      }
    }
    const bf16* k_t = kv_s + static_cast<size_t>(it % kStages) * 2 * kStageKeys * stride;
    const bf16* v_t = k_t + kStageKeys * stride;
#pragma unroll 1
    for (int u = warp; u < kSubs; u += kTcWarps) {
      const int base = k_begin + it * kStageKeys + u * kSubKeys;
      if (base > w_hi || base + kSubKeys - 1 < w_lo) continue;  // no row sees it

      // Scores of rows ra, rb against the sub-tile's 16 keys, 4 k-steps at
      // a time: their fragment loads first, then their products, on two
      // accumulator pairs (even and odd k-steps) so that the dependent
      // chains are half as long.  K by ldmatrix: keys (lane & 7) + 8 *
      // (lane >> 4) at column half (lane >> 3) & 1.
      float s[2][4], s_odd[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] = s_odd[nt][c] = 0.f;
      const bf16* ka = k_t + (u * kSubKeys + (lane & 7) + (lane >> 4) * 8) * stride +
                       ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kb0 = 0; kb0 < kKB; kb0 += 4) {
        uint32_t kf[4][4], qt[kQRegs ? 1 : 4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (kb0 + j < kKB && (kb0 + j) * 16 < hd) {
            ldsm_x4(kf[j], ka + (kb0 + j) * 16);
            if constexpr (!kQRegs) ldsm_x4(qt[j], qa + (kb0 + j) * 16);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (kb0 + j < kKB && (kb0 + j) * 16 < hd) {
            const uint32_t(&a)[4] = kQRegs ? qf[kQRegs ? kb0 + j : 0] : qt[kQRegs ? 0 : j];
            float(&d)[2][4] = (j & 1) ? s_odd : s;
            mma_bf16(d[0], a, kf[j][0], kf[j][1]);
            mma_bf16(d[1], a, kf[j][2], kf[j][3]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] += s_odd[nt][c];

      // V by ldmatrix.trans, two column tiles a load: keys (lane & 7) + 8 *
      // ((lane >> 3) & 1), column tile + (lane >> 4).  Up to head_dim 128
      // all of them are issued here, so that their latency passes under the
      // softmax; at 256 they come after it, 4 loads at a time.
      const bf16* va = v_t + (u * kSubKeys + (lane & 7) + ((lane >> 3) & 1) * 8) * stride +
                       (lane >> 4) * 8;
      constexpr bool kVEarly = kNT <= 16;
      uint32_t vf[kVEarly ? kNT / 2 : 4][4];
      if constexpr (kVEarly) {
#pragma unroll
        for (int j = 0; j < kNT / 2; ++j)
          if (j * 16 < hd) ldsm_x4_trans(vf[j], va + j * 16);
      }

      // Scale (log2 units), softcap, mask; the online softmax.
      bool ok[2][4];
      float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = base + nt * 8 + 2 * tig + (c & 1);
          const int qpos = c < 2 ? qpos_a : qpos_b;
          const float x = softcap > 0.f ? apply_softcap(s[nt][c] * scale, softcap) * kLog2e
                                        : s[nt][c] * scale2;
          bool good = (c < 2 ? ok_a : ok_b) && key < sk;
          if (causal) good = good && key <= qpos;
          if (window > 0) good = good && qpos - key < window;
          ok[nt][c] = good;
          s[nt][c] = x;
          if (good) {
            if (c < 2) mx_a = fmaxf(mx_a, x);
            else mx_b = fmaxf(mx_b, x);
          }
        }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const float alpha_a = exp2f(m_a - mn_a);
      const float alpha_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = ok[nt][c] ? exp2f(s[nt][c] - (c < 2 ? mn_a : mn_b)) : 0.f;
          if (c < 2) sum_a += p;
          else sum_b += p;
          s[nt][c] = p;
        }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        acc[n][0] *= alpha_a;
        acc[n][1] *= alpha_a;
        acc[n][2] *= alpha_b;
        acc[n][3] *= alpha_b;
      }

      // acc += P V: the score fragments of the sub-tile's two key n-tiles,
      // rounded to bf16, are exactly the A fragment of a 16 x 16 P.
      uint32_t pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = pack_bf16(s[i >> 1][(i & 1) * 2], s[i >> 1][(i & 1) * 2 + 1]);
      // head_dim % 16 == 0: column tiles come in pairs, one load each.
      if constexpr (kVEarly) {
#pragma unroll
        for (int j = 0; j < kNT / 2; ++j) {
          if (j * 16 < hd) {
            mma_bf16(acc[2 * j], pa, vf[j][0], vf[j][1]);
            mma_bf16(acc[2 * j + 1], pa, vf[j][2], vf[j][3]);
          }
        }
      } else {
#pragma unroll
        for (int j0 = 0; j0 < kNT / 2; j0 += 4) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if ((j0 + j) * 16 < hd) ldsm_x4_trans(vf[j], va + (j0 + j) * 16);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if ((j0 + j) * 16 < hd) {
              mma_bf16(acc[2 * (j0 + j)], pa, vf[j][0], vf[j][1]);
              mma_bf16(acc[2 * (j0 + j) + 1], pa, vf[j][2], vf[j][3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  // The 4 key splits: weigh each by exp2(m - max m) and sum in shared
  // memory (over the ring, free now); warp 0 writes the rows.
  __syncthreads();  // every warp is past its last read of the ring
  float* my_ml = ml_s + warp * 32;  // (m, l) of rows 0..15 of this warp
  if (tig == 0) {
    my_ml[2 * gid] = m_a;
    my_ml[2 * gid + 1] = l_a;
    my_ml[2 * (gid + 8)] = m_b;
    my_ml[2 * (gid + 8) + 1] = l_b;
  }
  __syncthreads();
  float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
  for (int j = 0; j < kTcWarps; ++j) {
    const float* o = ml_s + j * 32;
    mx_a = fmaxf(mx_a, o[2 * gid]);
    mx_b = fmaxf(mx_b, o[2 * (gid + 8)]);
  }
  float lsum_a = 0.f, lsum_b = 0.f;
#pragma unroll
  for (int j = 0; j < kTcWarps; ++j) {
    const float* o = ml_s + j * 32;
    lsum_a += exp2f(o[2 * gid] - mx_a) * o[2 * gid + 1];
    lsum_b += exp2f(o[2 * (gid + 8)] - mx_b) * o[2 * (gid + 8) + 1];
  }
  const float f_a = exp2f(m_a - mx_a), f_b = exp2f(m_b - mx_b);
  l_a = lsum_a;
  l_b = lsum_b;
  const int cstride = hd + 8;  // f32 row of the combine buffer
  float* cbuf = reinterpret_cast<float*>(kv_s);
  if (warp > 0) {
    float* c = cbuf + static_cast<size_t>(warp - 1) * 16 * cstride;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int d = n * 8 + 2 * tig;
      if (d < hd) {
        *reinterpret_cast<float2*>(c + gid * cstride + d) =
            make_float2(acc[n][0] * f_a, acc[n][1] * f_a);
        *reinterpret_cast<float2*>(c + (gid + 8) * cstride + d) =
            make_float2(acc[n][2] * f_b, acc[n][3] * f_b);
      }
    }
  }
  __syncthreads();
  if (warp > 0) return;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    acc[n][0] *= f_a;
    acc[n][1] *= f_a;
    acc[n][2] *= f_b;
    acc[n][3] *= f_b;
  }
#pragma unroll
  for (int j = 1; j < kTcWarps; ++j) {
    const float* c = cbuf + static_cast<size_t>(j - 1) * 16 * cstride;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int d = n * 8 + 2 * tig;
      if (d < hd) {
        const float2 x = *reinterpret_cast<const float2*>(c + gid * cstride + d);
        const float2 y = *reinterpret_cast<const float2*>(c + (gid + 8) * cstride + d);
        acc[n][0] += x.x;
        acc[n][1] += x.y;
        acc[n][2] += y.x;
        acc[n][3] += y.y;
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = h ? rb : ra;
    if (rr >= nr) continue;
    const float l = h ? l_b : l_a;
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    bf16* o = out + row_offset(rr);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int d = n * 8 + 2 * tig;
      if (d < hd)
        *reinterpret_cast<__nv_bfloat162*>(o + d) =
            __floats2bfloat162_rn(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
    }
  }
}

template <int kNT>
cudaError_t launch_tc_nt(const void* q, const void* k, const void* v, void* out, int batch,
                         int sq, int sk, int n_heads, int n_kv, int head_dim, int q_offset,
                         int causal, int window, float softcap, float scale,
                         cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<kNT>(head_dim);
  auto kernel = flash_attention_tc_kernel<kNT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int rows = sq * (n_heads / n_kv);
  const dim3 grid((rows + 15) / 16, n_kv, batch);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), sq, sk, n_heads, n_kv, head_dim, q_offset, causal, window,
      softcap, scale);
  return cudaGetLastError();
}

// head_dim / 8 accumulator tiles, rounded up to 4, 8, 16 or 32.
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, int batch,
                      int sq, int sk, int n_heads, int n_kv, int head_dim, int q_offset,
                      int causal, int window, float softcap, float scale,
                      cudaStream_t stream) {
  const int tiles = head_dim / 8;
  if (tiles <= 4)
    return launch_tc_nt<4>(q, k, v, out, batch, sq, sk, n_heads, n_kv, head_dim,
                           q_offset, causal, window, softcap, scale, stream);
  if (tiles <= 8)
    return launch_tc_nt<8>(q, k, v, out, batch, sq, sk, n_heads, n_kv, head_dim,
                           q_offset, causal, window, softcap, scale, stream);
  if (tiles <= 16)
    return launch_tc_nt<16>(q, k, v, out, batch, sq, sk, n_heads, n_kv, head_dim,
                            q_offset, causal, window, softcap, scale, stream);
  return launch_tc_nt<32>(q, k, v, out, batch, sq, sk, n_heads, n_kv, head_dim,
                          q_offset, causal, window, softcap, scale, stream);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// tc: 1 runs the tensor-core body (bf16 and head_dim % 16 == 0 only, as the
// wrapper's plan_flash picks it), 0 the SIMT body.
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v,
                               void* out, int batch, int sq, int sk, int n_heads,
                               int n_kv, int head_dim, int q_offset, int causal,
                               int window, float softcap, float scale, int tc,
                               void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || head_dim > 32 * kMaxDPerLane || head_dim < 1 ||
      sq < 1 || sk < 1 || batch < 1 || batch > 65535 ||
      (sq + kBlockQ - 1) / kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tc) {
    if (dtype != DTYPE_BF16 || head_dim % 16 != 0 || n_kv > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    err = launch_tc(q, k, v, out, batch, sq, sk, n_heads, n_kv, head_dim, q_offset, causal,
                    window, softcap, scale, s);
  } else if (dtype == DTYPE_BF16) {
    err = launch_simt<__nv_bfloat16>(q, k, v, out, batch, sq, sk, n_heads, n_kv, head_dim,
                                     q_offset, causal, window, softcap, scale, s);
  } else {
    err = launch_simt<float>(q, k, v, out, batch, sq, sk, n_heads, n_kv, head_dim, q_offset,
                             causal, window, softcap, scale, s);
  }
  return static_cast<int>(err);
}
