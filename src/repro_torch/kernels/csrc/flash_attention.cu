// Prefill (chunked) attention for Hopper (sm_90a): a query chunk at absolute
// positions q_offset .. q_offset + Sq - 1 attends keys at 0 .. Sk - 1.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (flash_attention_kernel / ops.flash_attention) and covers what the
// reference model path runs as the jnp flash_attention_ref for a prefill
// chunk: q_offset, GQA (kv head = h / g, indexed directly, no broadcast
// copy), window, softcap, a bidirectional prefix (prefix_len: with causal,
// key j is seen by query position p when j <= p or j < prefix_len, the
// prefix-LM mask of paligemma's image prefix), non-causal attention (an
// encoder, cross-attention), and lengths that are not multiples of the
// tile (masked here).
//
//   q    (B, Sq, H, hd)     f32 or bf16
//   k/v  (B, Sk, Hkv, hd)
//   out  (B, Sq, H, hd)
//   lse  (B, Sq, H) f32, or null: the natural-log logsumexp of each row's
//        visible scaled (and softcapped) scores, which the training path's
//        backward recomputes P from (exp(s - lse)); serving passes null.
//        A row that sees no key gets NEG_INF, finite.
//
// Three bodies share the entry; the wrapper (kernels/flash_attention.py,
// plan_flash) picks one from the shape and type and passes its tiling:
// * flash_attention_wg_kernel: bf16 with head_dim 64, 128 or 256 (every
//   configuration's) where the call has at least 512 keys or a kv head at
//   least 2^17 query rows (Sq * g) x keys: whisper's encoder and
//   cross-attention, paligemma's prefix chunk, the training forward, a
//   one-shot prefill, a long context.  On wgmma with TMA copies; its note
//   follows the tensor-core body's.
// * flash_attention_tc_kernel: the other bf16 calls with head_dim a
//   multiple of 16 (the serve's chunks of 64), on mma.sync.  Its note is
//   below.
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
//   row, or at prefix_len when that is further (every row sees the whole
//   prefix); a warp skips each sub-tile that none of its rows may see, so
//   only the edge sub-tiles are masked.

// The wgmma body (flash_attention_wg_kernel).  The tensor-core body was
// designed for the serve's chunk and loses to SDPA at long query
// blocks: each staged K/V tile serves one 16-row m-tile, so whisper's
// encoder (Sq = Sk 1500, hd 64, g 1, 16 heads) streams each head's K/V 94
// times from L2, and mma.sync with a quad-shuffle softmax every 16 keys
// runs at ~4% of the card.  What bounds the shapes this body serves:
// operations for the encoder (9.2 GFLOP, 9.3 us at 989 TFLOP/s, against
// 12.3 MB, 3.7 us); bytes for the training forward (B 4 x 512, H 32 / 8,
// hd 128, causal: 42.2 MB, 12.6 us, against 8.6 GFLOP, 8.7 us) and for
// whisper's cross-attention (Sq 64 over 1500 frames: 6.4 MB, 1.9 us).
// * Rows.  The Sq * g rows of a (b, kv head) in the tc body's order (r =
//   i * g + j), so one staged K/V tile serves all g heads.  A consumer
//   warpgroup owns 64 rows, wgmma's M; a block is 1, 2 or 3 consumer
//   warpgroups (64-192 rows, the wrapper's block_rows) and one producer
//   warp, so each staged K/V tile serves up to 192 rows.  At head_dim 256
//   one warpgroup a block: its accumulator alone is 128 registers a thread
//   (204 in all), and a second warpgroup would not fit the SM's registers;
//   at 128, two (168 registers); three only at head_dim 64 (416 threads at
//   128 registers, a few spilled): whisper's encoder in 128 blocks, one
//   wave, where two warpgroups a block need two (192 blocks).
// * Copies.  K and V stream into a ring of shared-memory stages, key tiles
//   of 128 (64 at head_dim 256; 4 stages at head_dim 64, else 2), loaded by
//   the producer warp's one thread with TMA (cp.async.bulk.tensor over a
//   4-D map (hd, Hkv, Sk, B) built on the host through the driver entry
//   point cuTensorMapEncodeTiled, passed as __grid_constant__ kernel
//   parameters so that a CUDA graph keeps them), 64 columns (128 bytes) a
//   box, 128-byte swizzled.  K and V have full barriers of their own (Q K^T
//   starts before V lands) and share an empty barrier that each consumer
//   warp arrives on.  Keys past Sk are zero-filled by TMA and masked.  Q is
//   copied once a block by cp.async into the same swizzled layout
//   (g * hd is 2048 at paligemma's g 8, more than one TMA box row).
// * Products.  S = Q K^T by wgmma m64n{128|64}k16 with Q and K from shared
//   memory (K-major, 128-byte swizzle descriptors, 32 bytes a k-step).  The
//   softmax runs on the accumulator fragments: exp2 with scale * log2(e)
//   folded in after the softcap, the row max and sum over a quad.  P is
//   rounded to bf16 in registers (per 128- or 64-key tile) and is wgmma's
//   register A operand for O += P V, with V from shared memory as an
//   MN-major B operand (the transpose bit; descriptor lbo = the stride
//   between 64-column blocks of V, sbo = 8 keys).  O stays in f32
//   registers.  Each product group is waited on before the next step: one
//   warpgroup's softmax is not overlapped with its own products (the other
//   warpgroups' products run meanwhile).
// * Skipping and masks.  A block starts at the window's start of its first
//   row and stops at the causal limit of its last row, or at prefix_len
//   when that is later; a warpgroup skips the products of a tile none of
//   its rows sees, and masks only a tile that some key of it is hidden
//   from some row of it (-inf scores: p = 0, not in the max).
// * A key split across blocks where the m-tiles' blocks would leave more
//   than half the SMs idle (whisper's cross-attention: 16 blocks; the long
//   context: 16): the key tiles are cut into runs, one a block (grid x =
//   m-tiles x splits), each writing its rows' (acc, m, l) in f32 to a
//   workspace the wrapper allocates, and combine_wg_splits_kernel writes
//   out and lse.  The split comes from the shape alone.
// * Epilogue.  O / l to bf16 in place; lse = (m + log2 l) ln 2; a row that
//   sees no key gets NEG_INF and a zero output, as in the other bodies.

#include <cuda.h>

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
    T* __restrict__ out, float* __restrict__ lse, int sq, int sk, int n_heads, int n_kv,
    int head_dim, int q_offset, int causal, int prefix_len, int window, float softcap,
    float scale) {
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
  // to the causal limit of its last row (or the end of the prefix).
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + kBlockQ, sq) - 1;
  const int k_end = causal ? min(sk, max(q_hi + 1, prefix_len)) : sk;
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
      if (causal) ok = ok && (kj <= qpos || kj < prefix_len);
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
    const size_t row = (static_cast<size_t>(b) * sq + qi) * n_heads + h;
    // m and l are the same in every lane of the warp (warp_max / warp_sum).
    if (lse != nullptr && lane == 0) lse[row] = l[rr] == 0.f ? NEG_INF : m[rr] + logf(l[rr]);
    T* o = out + row * hd;
#pragma unroll
    for (int c = 0; c < kMaxDPerLane; ++c) {
      const int d = lane + 32 * c;
      if (c < nd && d < hd) o[d] = from_f32<T>(acc[rr][c] / denom);
    }
  }
}

template <typename T>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* out, float* lse,
                        int batch, int sq, int sk, int n_heads, int n_kv, int head_dim,
                        int q_offset, int causal, int prefix_len, int window, float softcap,
                        float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBlockQ) * head_dim +
                       static_cast<size_t>(kBlockK) * (head_dim + 1) +
                       static_cast<size_t>(kBlockK) * head_dim + kBlockQ * kBlockK);
  cudaError_t err = allow_smem(flash_attention_simt_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_heads, (sq + kBlockQ - 1) / kBlockQ);
  flash_attention_simt_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, sq, sk, n_heads, n_kv, head_dim, q_offset, causal,
      prefix_len, window, softcap, scale);
  return cudaGetLastError();
}

// ---- The tensor-core body (bf16, head_dim % 16 == 0) ------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kStageKeys = 64;                 // keys a cp.async stage holds
constexpr int kSubKeys = 16;                   // keys a softmax step takes
constexpr int kSubs = kStageKeys / kSubKeys;   // sub-tiles a stage
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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
    bf16* __restrict__ out, float* __restrict__ lse, int sq, int sk, int n_heads, int n_kv,
    int head_dim, int q_offset, int causal, int prefix_len, int window, float softcap,
    float scale) {
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

  auto row_index = [&](int r) -> size_t {  // of block row r in lse (times hd: q, out)
    const int i = (r0 + r) / g;
    return (static_cast<size_t>(b) * sq + i) * n_heads + kvh * g + (r0 + r - i * g);
  };
  auto row_offset = [&](int r) -> size_t { return row_index(r) * hd; };

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
  // down to a stage) to the causal limit of its youngest, or to the end of
  // the prefix when that is further.
  const int pos_lo = q_offset + r0 / g;
  const int pos_hi = q_offset + (r0 + nr - 1) / g;
  const int k_end = causal ? min(sk, max(pos_hi + 1, prefix_len)) : sk;
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
  const int w_hi = causal ? min(sk - 1, max(pos_hi, prefix_len - 1)) : sk - 1;
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
          if (causal) good = good && (key <= qpos || key < prefix_len);
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
    // m is in log2 units of the scaled scores: lse = (m + log2 l) ln 2.
    if (lse != nullptr && tig == 0)
      lse[row_index(rr)] = l == 0.f ? NEG_INF : ((h ? mx_b : mx_a) + log2f(l)) * kLn2;
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
cudaError_t launch_tc_nt(const void* q, const void* k, const void* v, void* out, float* lse,
                         int batch, int sq, int sk, int n_heads, int n_kv, int head_dim,
                         int q_offset, int causal, int prefix_len, int window, float softcap,
                         float scale, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<kNT>(head_dim);
  auto kernel = flash_attention_tc_kernel<kNT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int rows = sq * (n_heads / n_kv);
  const dim3 grid((rows + 15) / 16, n_kv, batch);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, sq, sk, n_heads, n_kv, head_dim, q_offset, causal,
      prefix_len, window, softcap, scale);
  return cudaGetLastError();
}

// head_dim / 8 accumulator tiles, rounded up to 4, 8, 16 or 32.
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, float* lse,
                      int batch, int sq, int sk, int n_heads, int n_kv, int head_dim,
                      int q_offset, int causal, int prefix_len, int window, float softcap,
                      float scale, cudaStream_t stream) {
  const int tiles = head_dim / 8;
  if (tiles <= 4)
    return launch_tc_nt<4>(q, k, v, out, lse, batch, sq, sk, n_heads, n_kv, head_dim,
                           q_offset, causal, prefix_len, window, softcap, scale, stream);
  if (tiles <= 8)
    return launch_tc_nt<8>(q, k, v, out, lse, batch, sq, sk, n_heads, n_kv, head_dim,
                           q_offset, causal, prefix_len, window, softcap, scale, stream);
  if (tiles <= 16)
    return launch_tc_nt<16>(q, k, v, out, lse, batch, sq, sk, n_heads, n_kv, head_dim,
                            q_offset, causal, prefix_len, window, softcap, scale, stream);
  return launch_tc_nt<32>(q, k, v, out, lse, batch, sq, sk, n_heads, n_kv, head_dim,
                          q_offset, causal, prefix_len, window, softcap, scale, stream);
}

// ---- The wgmma body (bf16, head_dim 64 / 128 / 256) -------------------------

// Hopper's asynchronous products, the Tensor Memory Accelerator and mbarriers.

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand (the layout
// TMA's CU_TENSOR_MAP_SWIZZLE_128B writes: rows of 64 bf16, the 16-byte
// chunk j of row r stored at j ^ (r % 8), 8-row groups 1024 bytes apart).
// K-major: sbo 1024 (next 8 rows), lbo unused.  MN-major: lbo the stride
// from one 64-wide column block to the next, sbo 1024 (next 8 rows of K).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Waits until the phase of parity `parity` of the barrier has completed.  A
// wait that never ends is a fault of the pipeline: it traps (the launch
// fails with an error) rather than hold the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// One box of a 4-D tensor map, global -> shared, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127"
      "}, {%128,%129,%130,%131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// S (64 x N f32 a warpgroup) (+)= A (64 x 16, shared, K-major) B^T (N x 16,
// shared, K-major): N = the key tile.
template <int N>
__device__ __forceinline__ void wgmma_qk(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}
// O (64 x N f32) += P (64 x 16 bf16, registers) V (16 x N, shared,
// MN-major): N = head_dim.
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, 1);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db, 1);
  else wgmma_rs_n256(d, a, db, 1);
}

// The body's fixed sizes: a key tile of 128 (64 at head_dim 256, for its
// registers), the ring's depth, and the shared memory they take.
template <int kHD>
struct WgTile {
  static constexpr int kKeys = kHD <= 128 ? 128 : 64;
  static constexpr int kStages = kHD == 64 ? 4 : 2;
  static constexpr int kChunks = kHD / 64;                // 128-byte column blocks a row
  static constexpr uint32_t kQBytes = 64u * kHD * 2;      // one warpgroup's Q
  static constexpr uint32_t kKVBytes = 1u * kKeys * kHD * 2;  // one K (or V) stage
  static size_t smem(int wgs) {
    return 1024 + wgs * kQBytes + 2 * kStages * kKVBytes + 3 * kStages * sizeof(uint64_t);
  }
};

// Accumulator layout (wgmma m64nN, f32): warp w of a warpgroup holds rows
// 16 w .. 16 w + 15; lane 4 gid + tig holds, of each 8-column chunk n,
// d[4n + c] = (row 16 w + gid + 8 (c / 2), column 8 n + 2 tig + c % 2), the
// mma.sync m16n8 layout.  The scores of keys 16 t .. 16 t + 15 (chunks 2t,
// 2t + 1), rounded to bf16 in pairs, are exactly the A fragment of wgmma's
// k-step t: {d[8t], d[8t+1]}, {d[8t+2], d[8t+3]}, {d[8t+4], d[8t+5]},
// {d[8t+6], d[8t+7]}.
template <int kHD, int kWG>
__global__ void __launch_bounds__(128 * kWG + 32, 1) flash_attention_wg_kernel(
    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
    const bf16* __restrict__ q, bf16* __restrict__ out, float* __restrict__ lse,
    float* __restrict__ ws, int sq, int sk, int n_heads, int n_kv, int q_offset, int causal,
    int prefix_len, int window, float softcap, float scale, int m_tiles, int n_splits,
    int tiles_per_split) {
  using T = WgTile<kHD>;
  constexpr int kKeys = T::kKeys;
  constexpr int kStages = T::kStages;
  constexpr int kRows = 64 * kWG;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* base = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* q_s = base;
  unsigned char* k_s = q_s + kWG * T::kQBytes;
  unsigned char* v_s = k_s + kStages * T::kKVBytes;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(v_s + kStages * T::kKVBytes);
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = n_heads / n_kv;
  const int rows = sq * g;
  const int split = blockIdx.x / m_tiles;
  const int mt = m_tiles - 1 - (blockIdx.x - split * m_tiles);  // the longest causal tiles first
  const int r0 = mt * kRows;
  const int nr = min(kRows, rows - r0);

  // The block's keys: the window's start of its oldest row (rounded down to
  // a tile) to the causal limit of its youngest, or the end of the prefix,
  // cut to its split's tiles.
  const int pos_lo = q_offset + r0 / g;
  const int pos_hi = q_offset + (r0 + nr - 1) / g;
  int k_end = causal ? min(sk, max(pos_hi + 1, prefix_len)) : sk;
  int k_begin = window > 0 ? max(0, pos_lo - window + 1) : 0;
  k_begin = (k_begin / kKeys) * kKeys;
  k_begin = max(k_begin, split * tiles_per_split * kKeys);
  k_end = min(k_end, (split + 1) * tiles_per_split * kKeys);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys : 0;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 4 * kWG);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kWG) {
    // The producer: one thread keeps the ring full by TMA, K and V of a
    // stage on barriers of their own so that Q K^T starts before V lands.
    if (lane == 0) {
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) - 1) & 1);
        const int key0 = k_begin + it * kKeys;
        mbar_expect_tx(&full_k[st], T::kKVBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load_4d(k_s + st * T::kKVBytes + c * kKeys * 128, &k_map, &full_k[st], c * 64, kvh,
                      key0, b);
        mbar_expect_tx(&full_v[st], T::kKVBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load_4d(v_s + st * T::kKVBytes + c * kKeys * 128, &v_map, &full_v[st], c * 64, kvh,
                      key0, b);
      }
    }
    return;
  }

  // A consumer warpgroup: rows wr0 .. wr0 + 63 of the block.
  const int wg = warp >> 2;
  const int wtid = tid & 127;
  const int wr0 = r0 + 64 * wg;
  const int wnr = min(64, rows - wr0);  // <= 0: a warpgroup of pad rows
  auto row_index = [&](int r) -> size_t {  // of Sq * g row r in lse (times hd: q, out)
    const int i = r / g;
    return (static_cast<size_t>(b) * sq + i) * n_heads + kvh * g + (r - i * g);
  };

  // Q by 16-byte cp.async into the swizzled layout (rows past the last
  // zero-filled), made visible to wgmma, shared within the warpgroup only.
  unsigned char* qw = q_s + wg * T::kQBytes;
  constexpr int kCpr = kHD / 8;  // 16-byte chunks a row
  for (int i = wtid; i < 64 * kCpr; i += 128) {
    const int rr = i / kCpr;
    const int ch = i - rr * kCpr;
    const bool ok = rr < wnr;
    const bf16* src = ok ? q + row_index(wr0 + rr) * kHD + ch * 8 : q;
    cp_async16(qw + (ch >> 3) * 8192 + rr * 128 + (((ch & 7) ^ (rr & 7)) << 4), src, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  named_barrier(1 + wg, 128);

  const int w4 = warp & 3;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int ra = wr0 + 16 * w4 + gid;  // this thread's two rows
  const int rb = ra + 8;
  const int qpos_a = q_offset + ra / g;
  const int qpos_b = q_offset + rb / g;
  // The keys some row of the warpgroup may see, and those all its rows see.
  const int wpos_lo = q_offset + wr0 / g;
  const int wpos_hi = q_offset + (wr0 + max(wnr, 1) - 1) / g;
  const int w_lo = window > 0 ? wpos_lo - window + 1 : 0;
  const int w_hi = causal ? min(sk, max(wpos_hi + 1, prefix_len)) - 1 : sk - 1;
  const float scale2 = scale * kLog2e;

  float o[kHD / 2];
#pragma unroll
  for (int i = 0; i < kHD / 2; ++i) o[i] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;  // l: this thread's part
  const uint32_t q_addr = smem_u32(qw);
  const uint32_t k_addr = smem_u32(k_s);
  const uint32_t v_addr = smem_u32(v_s);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const uint32_t par = (it / kStages) & 1;
    const int t0 = k_begin + it * kKeys;
    mbar_wait(&full_k[st], par);
    if (wnr > 0 && t0 <= w_hi && t0 + kKeys - 1 >= w_lo) {
      // S = Q K^T over head_dim, 16 columns a product.
      float s[kKeys / 2];
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_qk<kKeys>(
              s, sw128_desc(q_addr + c * 8192 + kk * 32, 16, 1024),
              sw128_desc(k_addr + st * T::kKVBytes + c * kKeys * 128 + kk * 32, 16, 1024),
              c | kk);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) keep(s[i]);

      // Scale (log2 units), softcap; masked keys -inf (p = 0, not in the
      // max), on the edge tiles only.
      if (softcap > 0.f) {
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) s[i] = apply_softcap(s[i] * scale, softcap) * kLog2e;
      } else {
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) s[i] *= scale2;
      }
      const bool edge = t0 + kKeys > sk ||
                        (causal && t0 + kKeys - 1 > wpos_lo && t0 + kKeys > prefix_len) ||
                        (window > 0 && wpos_hi - t0 >= window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) {
          const int key = t0 + 8 * (i >> 2) + 2 * tig + (i & 1);
          const int qpos = (i & 2) ? qpos_b : qpos_a;
          bool good = key < sk;
          if (causal) good = good && (key <= qpos || key < prefix_len);
          if (window > 0) good = good && qpos - key < window;
          if (!good) s[i] = -INFINITY;
        }
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        if (i & 2) mx_b = fmaxf(mx_b, s[i]);
        else mx_a = fmaxf(mx_a, s[i]);
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const float alpha_a = exp2f(m_a - mn_a);
      const float alpha_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const float p = exp2f(s[i] - ((i & 2) ? mn_b : mn_a));
        if (i & 2) sum_b += p;
        else sum_a += p;
        s[i] = p;
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int n = 0; n < kHD / 8; ++n) {
        o[4 * n] *= alpha_a;
        o[4 * n + 1] *= alpha_a;
        o[4 * n + 2] *= alpha_b;
        o[4 * n + 3] *= alpha_b;
      }
      // P in bf16, the A operand of each 16-key step of O += P V.
      uint32_t pa[kKeys / 16][4];
#pragma unroll
      for (int t = 0; t < kKeys / 16; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) pa[t][j] = pack_bf16(s[8 * t + 2 * j], s[8 * t + 2 * j + 1]);

      mbar_wait(&full_v[st], par);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < kKeys / 16; ++t)
        wgmma_pv<kHD>(o, pa[t],
                      sw128_desc(v_addr + st * T::kKVBytes + t * 16 * 128, kKeys * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kHD / 2; ++i) keep(o[i]);
#pragma unroll
      for (int t = 0; t < kKeys / 16; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) keep(pa[t][j]);
    } else {
      mbar_wait(&full_v[st], par);  // no row of this warpgroup sees the tile
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? rb : ra;
    if (r >= rows || r - wr0 >= wnr) continue;
    const float m = h ? m_b : m_a;
    const float l = h ? l_b : l_a;
    if (n_splits == 1) {
      const float inv = 1.f / (l == 0.f ? 1.f : l);
      // m is in log2 units of the scaled scores: lse = (m + log2 l) ln 2.
      if (lse != nullptr && tig == 0)
        lse[row_index(r)] = l == 0.f ? NEG_INF : (m + log2f(l)) * kLn2;
      bf16* dst = out + row_index(r) * kHD;
#pragma unroll
      for (int n = 0; n < kHD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n + 2 * tig) =
            __floats2bfloat162_rn(o[4 * n + 2 * h] * inv, o[4 * n + 2 * h + 1] * inv);
    } else {
      // This split's (acc, m, l) of the row, for combine_wg_splits_kernel.
      float* w = ws + ((static_cast<size_t>(b * n_kv + kvh) * n_splits + split) * rows + r) *
                          (kHD + 2);
#pragma unroll
      for (int n = 0; n < kHD / 8; ++n)
        *reinterpret_cast<float2*>(w + 8 * n + 2 * tig) =
            make_float2(o[4 * n + 2 * h], o[4 * n + 2 * h + 1]);
      if (tig == 0) *reinterpret_cast<float2*>(w + kHD) = make_float2(m, l);
    }
  }
}

// The second pass of a split call: out = sum_s w_s acc_s / sum_s w_s l_s,
// w_s = 2^(m_s - max m) (l == 0 -> 1), and lse = (max m + log2 sum_s w_s
// l_s) ln 2.  One thread an output row and column pair; grid (row column
// pairs / 256, Hkv, B).
constexpr int kCombineThreads = 256;

__global__ void __launch_bounds__(kCombineThreads) combine_wg_splits_kernel(
    const float* __restrict__ ws, bf16* __restrict__ out, float* __restrict__ lse, int sq,
    int n_heads, int n_kv, int head_dim, int n_splits) {
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = n_heads / n_kv;
  const int hd = head_dim;
  const int rows = sq * g;
  const int i = blockIdx.x * kCombineThreads + threadIdx.x;
  if (i >= rows * (hd / 2)) return;
  const int r = i / (hd / 2);
  const int d = 2 * (i - r * (hd / 2));
  const size_t step = static_cast<size_t>(rows) * (hd + 2);  // from one split to the next
  const float* p = ws + (static_cast<size_t>(b * n_kv + kvh) * n_splits * rows + r) * (hd + 2);
  float mx = NEG_INF;
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, p[s * step + hd]);
  float l = 0.f, o0 = 0.f, o1 = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float* ps = p + s * step;
    const float w = exp2f(ps[hd] - mx);
    const float2 a = *reinterpret_cast<const float2*>(ps + d);
    l += w * ps[hd + 1];
    o0 += w * a.x;
    o1 += w * a.y;
  }
  const int t = r / g;
  const size_t row = (static_cast<size_t>(b) * sq + t) * n_heads + kvh * g + (r - t * g);
  if (lse != nullptr && d == 0) lse[row] = l == 0.f ? NEG_INF : (mx + log2f(l)) * kLn2;
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  *reinterpret_cast<__nv_bfloat162*>(out + row * hd + d) =
      __floats2bfloat162_rn(o0 * inv, o1 * inv);
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// K or V (B, Sk, Hkv, hd) as a 4-D tensor map (hd, Hkv, Sk, B): a box is
// 64 columns of one kv head over `keys` keys, 128-byte swizzled; keys past
// Sk are zero-filled.
bool kv_map(CUtensorMap* map, const void* p, int batch, int sk, int n_kv, int head_dim,
            int keys) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim), static_cast<cuuint64_t>(n_kv),
                              static_cast<cuuint64_t>(sk), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(head_dim) * 2;
  const cuuint64_t strides[3] = {row, row * n_kv, row * n_kv * sk};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(keys), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct WgArgs {
  const void *q, *k, *v;
  void* out;
  float *lse, *ws;
  int batch, sq, sk, n_heads, n_kv, head_dim, q_offset, causal, prefix_len, window;
  float softcap, scale;
  int block_rows, n_splits, tiles_per_split;
  cudaStream_t stream;
};

template <int kHD, int kWG>
cudaError_t launch_wg_t(const WgArgs& a) {
  using T = WgTile<kHD>;
  CUtensorMap km, vm;
  if (!kv_map(&km, a.k, a.batch, a.sk, a.n_kv, kHD, T::kKeys) ||
      !kv_map(&vm, a.v, a.batch, a.sk, a.n_kv, kHD, T::kKeys))
    return cudaErrorInvalidValue;
  const size_t smem = T::smem(kWG);
  auto kernel = flash_attention_wg_kernel<kHD, kWG>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int rows = a.sq * (a.n_heads / a.n_kv);
  const int m_tiles = (rows + 64 * kWG - 1) / (64 * kWG);
  const dim3 grid(m_tiles * a.n_splits, a.n_kv, a.batch);
  kernel<<<grid, 128 * kWG + 32, smem, a.stream>>>(
      km, vm, static_cast<const bf16*>(a.q), static_cast<bf16*>(a.out),
      a.n_splits > 1 ? nullptr : a.lse, a.ws, a.sq, a.sk, a.n_heads, a.n_kv, a.q_offset,
      a.causal, a.prefix_len, a.window, a.softcap, a.scale, m_tiles, a.n_splits,
      a.tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return err;
  const dim3 cgrid((rows * (kHD / 2) + kCombineThreads - 1) / kCombineThreads, a.n_kv, a.batch);
  combine_wg_splits_kernel<<<cgrid, kCombineThreads, 0, a.stream>>>(
      a.ws, static_cast<bf16*>(a.out), a.lse, a.sq, a.n_heads, a.n_kv, kHD, a.n_splits);
  return cudaGetLastError();
}

cudaError_t launch_wg(const WgArgs& a) {
  const int keys = a.head_dim <= 128 ? 128 : 64;
  const long long covered = static_cast<long long>(a.n_splits) * a.tiles_per_split * keys;
  if (a.n_splits < 1 || a.tiles_per_split < 1 || covered < a.sk ||
      covered - static_cast<long long>(a.tiles_per_split) * keys >= a.sk ||
      (a.n_splits > 1 && a.ws == nullptr) ||
      (reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v)) % 16 != 0)
    return cudaErrorInvalidValue;
  const int wgs = a.block_rows / 64;
  if (a.block_rows % 64 != 0 || wgs < 1 || wgs > 3) return cudaErrorInvalidValue;
  switch (a.head_dim * 4 + wgs) {
    case 64 * 4 + 1: return launch_wg_t<64, 1>(a);
    case 64 * 4 + 2: return launch_wg_t<64, 2>(a);
    case 64 * 4 + 3: return launch_wg_t<64, 3>(a);
    case 128 * 4 + 1: return launch_wg_t<128, 1>(a);
    case 128 * 4 + 2: return launch_wg_t<128, 2>(a);
    case 256 * 4 + 1: return launch_wg_t<256, 1>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// lse: a (B, Sq, H) f32 output, or null.  body: 0 the SIMT body, 1 the
// tensor-core body (bf16 and head_dim % 16 == 0), 2 the wgmma body (bf16,
// head_dim 64 / 128 / 256) with its block of block_rows (64, 128 or 192) rows
// and its keys in n_splits splits of tiles_per_split key tiles; with more
// than one split, ws is its f32 workspace of B * Hkv * n_splits * Sq * g
// rows of head_dim + 2 (the wrapper's plan_flash picks all of these).
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v,
                               void* out, void* lse, int batch, int sq, int sk, int n_heads,
                               int n_kv, int head_dim, int q_offset, int causal,
                               int prefix_len, int window, float softcap, float scale,
                               int body, int block_rows, int n_splits, int tiles_per_split,
                               void* ws, void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || head_dim > 32 * kMaxDPerLane || head_dim < 1 ||
      prefix_len < 0 ||
      sq < 1 || sk < 1 || batch < 1 || batch > 65535 ||
      (sq + kBlockQ - 1) / kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  if (body == 2) {
    if (dtype != DTYPE_BF16 || n_kv > 65535) return static_cast<int>(cudaErrorInvalidValue);
    WgArgs a{q, k, v, out, l, static_cast<float*>(ws), batch, sq, sk, n_heads, n_kv, head_dim,
             q_offset, causal, prefix_len, window, softcap, scale, block_rows, n_splits,
             tiles_per_split, s};
    err = launch_wg(a);
  } else if (body == 1) {
    if (dtype != DTYPE_BF16 || head_dim % 16 != 0 || n_kv > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    err = launch_tc(q, k, v, out, l, batch, sq, sk, n_heads, n_kv, head_dim, q_offset, causal,
                    prefix_len, window, softcap, scale, s);
  } else if (dtype == DTYPE_BF16) {
    err = launch_simt<__nv_bfloat16>(q, k, v, out, l, batch, sq, sk, n_heads, n_kv, head_dim,
                                     q_offset, causal, prefix_len, window, softcap, scale, s);
  } else {
    err = launch_simt<float>(q, k, v, out, l, batch, sq, sk, n_heads, n_kv, head_dim, q_offset,
                             causal, prefix_len, window, softcap, scale, s);
  }
  return static_cast<int>(err);
}
