// Paged decode attention for Hopper (sm_90a): keys and values read from the
// paged KV pool through the page table, for a block of q_len >= 1 new tokens
// per sequence, over full-precision or quantized (int8 / fp8 e4m3) pages.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::_paged_kernel in
// all four of its uses: ops.paged_attention (q_len 1, the decode tick),
// paged_attention_multi (q_len > 1, the speculative verify step), and their
// fused-dequant twins paged_attention_quant / paged_attention_multi_quant.
// There the page stream was the sequential innermost grid axis and the
// online softmax state lived in VMEM scratch across it; here blocks run in
// parallel and in no order.
//
// Two bodies share the arguments and the dtype dispatch:
// * paged_attention_split_kernel + combine_splits_kernel (split-KV on
//   tensor cores; its note is above it, further down) serves all four
//   entries wherever head_dim is a multiple of 16: every configuration of
//   the zoo (64, 128, 256) and the smoke configurations (16).  A
//   single-token call is a call with q_len 1, whose rows are the g query
//   heads of a kv head.
// * paged_attention_walk_kernel serves the single-token entries for any
//   other head_dim (no configuration has one): one block per (sequence,
//   kv head) walks its pages in f32.
// The wrapper (kernels/paged_attention.py) picks the body by shape
// (single_token_body) and cuts the split (plan_split); a single-token
// entry given pages_per_split 0 runs the walk body.
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
// q[b, t, kvh*g + i, :]: no transposed copy.
//
// Masking is by position, never by page id: table entries past a sequence's
// pages point at trash block 0, whose contents are garbage, and a shielded
// or free slot (cur_len 0, all-trash row) reads one key and comes out
// finite.  The output divides by l, guarded l == 0 -> 1.  A quantized pool's
// k_scale[page, kvh] and v_scale[page, kvh] are read through the same
// page_table[b, j] as the codes.
//
// Precision, as the reference's: scores and the softmax in f32; for a bf16
// q, P V with P rounded to bf16 over bf16 pages (the reference's
// p.astype(v.dtype)) and at f32 accuracy over code pages, whose dequantized
// V is f32 there; for an f32 q, P in f32.
//
// What bounds both bodies: memory (4 * q_len * g * hd flops per key against
// 2 * hd elements of K and V, far below the ~295 flops a byte at which the
// H100's compute binds).  At the serving shapes the bound is under a
// microsecond, so latency is the cost: launches and each block's chain of
// loads.
//
// The walk body.  One thread block owns one (sequence b, kv head), holds its
// g <= kWalkRows query heads (at one position, cur_len) and walks the pages
// up to cur_len, skipping those behind the window; each page's bs x hd
// slice of K and V is staged in f32 shared memory (code * scale for a
// quantized pool), one warp per (row, key) score, the online softmax on one
// thread per row, P V on one thread per column.  B x Hkv blocks (32 at the
// serving shape) and four barriers a page: slow, and kept only for the
// head_dims the split body cannot take.

#include <cuda_fp8.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

// The quantized pools' code types (f32 and bf16 are in common.cuh; beside
// them, outside the namespace below, so that one overload set is found).
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kWalkRows = 16;      // query heads per kv head the walk body takes
constexpr int kMaxDPerThread = 2;  // head_dim <= kThreads * 2 = 256

// T: the type of q and out.  C: the pool's element type.  kQuant: C holds
// codes to be multiplied by the per-(page, kv head) scales.
template <typename T, typename C, bool kQuant>
__global__ void __launch_bounds__(kThreads) paged_attention_walk_kernel(
    const T* __restrict__ q, const C* __restrict__ k_pool, const C* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ page_table, const int* __restrict__ cur_len,
    T* __restrict__ out, int n_heads, int n_kv, int head_dim, int block_size, int n_pages,
    int window, float softcap, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = n_heads / n_kv;  // rows: this kv head's query heads
  const int hd = head_dim;
  const int bs = block_size;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* q_s = smem;           // g * hd
  float* k_s = q_s + g * hd;   // bs * hd
  float* v_s = k_s + bs * hd;  // bs * hd
  float* p_s = v_s + bs * hd;  // g * bs: scores, then probabilities
  float* m_s = p_s + g * bs;   // g
  float* l_s = m_s + g;        // g
  float* alpha_s = l_s + g;    // g

  // The g rows are contiguous in q and out: heads kvh * g ... of sequence b.
  const size_t q0 = (static_cast<size_t>(b) * n_heads + kvh * g) * hd;
  for (int i = tid; i < g * hd; i += kThreads) q_s[i] = to_f32(q[q0 + i]);
  const int cur = cur_len[b];
  if (tid < g) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[kWalkRows][kMaxDPerThread];
#pragma unroll
  for (int r = 0; r < kWalkRows; ++r)
#pragma unroll
    for (int c = 0; c < kMaxDPerThread; ++c) acc[r][c] = 0.f;

  const int last_page = min(n_pages - 1, cur / bs);
  const int* row = page_table + static_cast<size_t>(b) * n_pages;

  for (int j = 0; j <= last_page; ++j) {
    if (window > 0 && cur - (j * bs + bs - 1) >= window) continue;  // behind the window
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
    for (int idx = warp; idx < g * bs; idx += kWarps) {
      const int r = idx / bs;
      const int t = idx - r * bs;
      float part = 0.f;
      for (int d = lane; d < hd; d += 32) part += q_s[r * hd + d] * k_s[t * hd + d];
      const float dot = warp_sum(part);
      if (lane == 0) {
        const float s = apply_softcap(dot * scale, softcap);
        const int pos = j * bs + t;
        const bool ok = pos <= cur && (window <= 0 || cur - pos < window);
        p_s[idx] = ok ? s : NEG_INF;
      }
    }
    __syncthreads();

    // Online softmax update, one thread per query row.
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
      for (int r = 0; r < kWalkRows; ++r)
        if (r < g) acc[r][c] *= alpha_s[r];
      for (int t = 0; t < bs; ++t) {
        const float vv = v_s[t * hd + d];
#pragma unroll
        for (int r = 0; r < kWalkRows; ++r)
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
    for (int r = 0; r < kWalkRows; ++r) {
      if (r >= g) continue;
      const float l = l_s[r] == 0.f ? 1.f : l_s[r];
      out[q0 + r * hd + d] = from_f32<T>(acc[r][c] / l);
    }
  }
}

// ---- The split body: split-KV on tensor cores ---------------------------
//
// paged_attention_split_kernel serves all four entries (head_dim a multiple
// of 16): the decode tick's single-token calls (q_len 1, rows = the g query
// heads of a kv head) and the speculative verify step's draft blocks (q_len
// = k + 1 tokens, q_len * g rows).  Two shapes set its design: the decode
// tick (B = 4, q_len 1, H = 32 / 8, hd 128, 9 pages of 16), where the walk
// body runs B x Hkv = 32 blocks on 132 SMs, each walking every page in
// series with four barriers a page, and the verify step (q_len 5, 20 rows),
// where a walk over row tiles of 10 would run 64 blocks and read each page
// twice.
//
// * Split-KV.  Grid (B, Hkv, row tiles x splits): the page table is cut
//   into splits of pages_per_split pages (the wrapper's plan_split picks it
//   from the shape: about 528 blocks, at least 2 pages a split; 5 splits of
//   2 pages, 160 blocks, at both serving shapes; 16 splits of 8 pages, 512
//   blocks, at 128 pages).  Each block writes its rows' unnormalized acc
//   and their m and l, in f32, to a workspace; a second launch from the
//   same C entry (combine_splits_kernel, launched as a programmatic
//   dependent of the first so that its launch overlaps the first's tail)
//   rescales the partials by exp(m - max m) and sums them.  A split none
//   of whose keys a row may see leaves that row m = NEG_INF, l = 0,
//   acc = 0, so it has no weight in the sum.  With one split the block
//   writes the output itself.
// * One block holds all q_len * g rows of its kv head, up to kMaxTileRows
//   (64) rows, so each page is read once; beyond that the rows are cut into
//   balanced tiles along grid z.
// * Tensor cores for a bf16 q: Q K^T and P V run as mma.sync m16n8k16 bf16
//   with f32 accumulators, fragments read by ldmatrix (V by
//   ldmatrix.trans).  A warp takes one 16-row m-tile (20 rows pad to 2) and
//   one column group of P V (see "Warps" below), so every warp of the block
//   works and each holds a fraction of the accumulator.  wgmma is not used:
//   its 64-row minimum would be two-thirds padding at 20 rows.  At q_len 1
//   the one m-tile holds g = 4 real rows and 12 zero rows; the tensor-core
//   work they waste does not bind (all products of a decode call, padding
//   included, are ~105 MFLOP: ~0.1 us at the H100's 989 TFLOP/s, against a
//   bound of ~0.55 us for its bytes), and a tiling made for one
//   token (keys as the mma's M, rows as its N) would need the score
//   fragments transposed through shared memory before P V, one more
//   barrier in the chain that does bind.  So q_len 1 is one more row count
//   of the same body.
// * Codes.  int8 codes (|x| <= 127) and fp8 e4m3 values are exact in bf16:
//   the thread that copied a 16-byte chunk of codes converts it to bf16 in
//   shared memory (double-buffered, before the tile's one barrier); the
//   key's page k scale multiplies the f32 scores and its v scale is folded
//   into P.  P V then keeps P at f32 accuracy, as the reference does over
//   its f32-dequantized V: P is split into P_hi = bf16(P) and P_lo =
//   bf16(P - P_hi), and both go through the tensor cores into the same f32
//   accumulator against the exact codes, carrying ~16 bits of P.  Over bf16
//   pages P is rounded to bf16 once, as the reference's p.astype(v.dtype).
//   An f32 q (the card-vs-CPU checks) keeps the same tiling and fragment
//   layout with f32 FMA products (not TF32).
// * Pages in flight.  K and V arrive in their stored type (bf16 or 1-byte
//   codes) in a ring of kStages = 3 tiles of kKeys = 16 key rows, by
//   16-byte cp.async copies (a key row of one kv head is hd contiguous
//   elements at a stride of Hkv * hd), so tiles i + 1 and i + 2 stream in
//   while tile i computes; one barrier per tile.  Rows are addressed one by
//   one through the table, so any block_size works.  Each thread owns one
//   key row of every tile and fixed 16-byte columns of it, K and V share
//   its address, and the row's page and in-page offset advance by kKeys a
//   tile without a division.
// * Softmax in registers, on the accumulator fragments: each quad of lanes
//   holds two rows, whose max and sum are quad shuffles.
//
// What bounds it: memory (see the top), and at the serving shapes, whose
// bound is under a microsecond, the two launches and each block's chain of
// latencies (table, then pages, then products).  Integer work is not free
// at these sizes: runtime divisions per copy address, or byte-wise code
// conversion, cost more than the loads and the products together, hence
// the fixed copy rows and the 16-code conversions.

constexpr int kSplitThreads = 128;  // at most 4 warps
constexpr int kMaxTileRows = 64;
constexpr int kKeys = 16;           // key rows per tile: one k-step of P V
constexpr int kKN = kKeys / 8;      // 8-wide n-tiles of a tile's scores
constexpr int kStages = 3;          // tiles in the cp.async ring

// x0, x1 as packed bf16 (the high part) and their remainders as packed
// bf16 (the low part): high + low carries ~16 bits of each value.
__device__ __forceinline__ void pack_bf16_split(float x0, float x1, uint32_t& hi,
                                                uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}
// Programmatic dependent launch: the split kernel lets the combine pass
// launch once its blocks are past their loads; the combine pass waits
// for the split grid to finish (and its writes to be visible) before it
// reads the workspace.
__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Fragment layout (m16n8, as mma.sync returns it): lane = 4 * gid + tig
// holds rows gid and gid + 8, columns 2 * tig and 2 * tig + 1 of each 8-wide
// n-tile: element c of a fragment is (row gid + 8 * (c / 2), column
// 2 * tig + c % 2).  Scores s[nt][c] cover keys nt * 8 + 2 * tig + c % 2;
// acc[n][c] covers head_dim columns (hc * kNT + n) * 8 + 2 * tig + c % 2.
//
// Warps.  Warp w takes m-tile w % nm (16 rows) and column group
// hc = w / nm of P V: the block has nm * nc warps, nc = max(1, 4 / nm), and
// each warp keeps kNT 8-wide column tiles of acc (kNT * nc * 8 >= hd).  The
// warps of one m-tile each compute its (small) scores and softmax, then
// their own columns of P V: all warps work, and acc takes a fraction of
// the registers.
template <typename T, typename C, bool kQuant, int kNT>
__global__ void __launch_bounds__(kSplitThreads) paged_attention_split_kernel(
    const T* __restrict__ q, const C* __restrict__ k_pool, const C* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ page_table, const int* __restrict__ cur_len, T* __restrict__ out,
    float* __restrict__ ws, int q_len, int n_heads, int n_kv, int head_dim, int block_size,
    int n_pages, int tile_rows, int pages_per_split, int n_splits, int window, float softcap,
    float scale) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tile = blockIdx.z / n_splits;
  const int split = blockIdx.z - tile * n_splits;
  const int g = n_heads / n_kv;
  const int hd = head_dim;
  const int bs = block_size;
  const int rows = q_len * g;
  const int r0 = tile * tile_rows;               // first row of this tile
  const int nr = min(tile_rows, rows - r0);      // rows of this tile
  const int nm = (tile_rows + 15) / 16;          // m-tiles
  const int nthreads = blockDim.x;               // 32 * nm * nc
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int mt = warp % nm;                      // this warp's m-tile
  const int n0 = (warp / nm) * kNT;              // and its first column tile

  // Shared memory: Q (nm * 16 rows, zero past nr), the K/V ring, the ring's
  // per-key scales, the split's page ids.  Rows are padded by 16 bytes so
  // that the fragment loads of 8 rows fall in distinct banks.
  const int qstride = hd + 16 / static_cast<int>(sizeof(T));
  const int kvstride = hd + 16 / static_cast<int>(sizeof(C));
  T* q_s = reinterpret_cast<T*>(smem_raw);
  C* kv_s = reinterpret_cast<C*>(smem_raw + static_cast<size_t>(nm) * 16 * qstride * sizeof(T));
  float* sc_s =
      reinterpret_cast<float*>(kv_s + static_cast<size_t>(kStages) * 2 * kKeys * kvstride);
  // Two tiles of codes converted to bf16 for the tensor cores (code pools):
  // tile it is converted into buffer it % 2 while tile it - 1 may still be
  // read from the other.
  constexpr bool kCodes = kMma && !std::is_same<C, __nv_bfloat16>::value;
  const int bstride = hd + 8;
  __nv_bfloat16* kvb_s = reinterpret_cast<__nv_bfloat16*>(sc_s + kStages * 2 * kKeys);
  int* pages_s = reinterpret_cast<int*>(kvb_s + (kCodes ? 2 * 2 * kKeys * bstride : 0));

  auto row_offset = [&](int rr) -> size_t {  // of tile row rr in q and out
    const int r = r0 + rr;
    const int t = r / g;
    return ((static_cast<size_t>(b) * q_len + t) * n_heads + kvh * g + (r - t * g)) * hd;
  };

  // Q by 16-byte copies, one warp per row (rows past nr zero-filled); they
  // join the first tile's copy group.
  constexpr int kQChunk = 16 / sizeof(T);
  const int qcpr = hd / kQChunk;
  for (int rr = warp; rr < nm * 16; rr += nthreads / 32) {
    const bool ok = rr < nr;
    const T* src = ok ? q + row_offset(rr) : q;
    for (int ch = lane; ch < qcpr; ch += 32)
      cp_async16(q_s + rr * qstride + ch * kQChunk, ok ? src + ch * kQChunk : q, ok);
  }
  // The split's page ids (they do not depend on cur_len: both loads fly
  // together).
  const int page0 = split * pages_per_split;
  const int split_pages = min(pages_per_split, n_pages - page0);
  for (int i = tid; i < split_pages; i += nthreads)
    pages_s[i] = page_table[static_cast<size_t>(b) * n_pages + page0 + i];

  // This block's keys: its split's positions, cut to what some row of the
  // tile may see (behind the youngest row, inside the oldest row's window,
  // inside the table).
  const int cur = cur_len[b];
  const int oldest = cur + r0 / g;
  const int youngest = cur + (r0 + nr - 1) / g;
  int k_lo = page0 * bs;
  if (window > 0) k_lo = max(k_lo, oldest - window + 1);
  const int k_hi = min((page0 + split_pages) * bs - 1, youngest);
  const int n_tiles = k_hi >= k_lo ? (k_hi - k_lo) / kKeys + 1 : 0;

  // Copies: thread tid owns key row my_kk of every tile, its 16-byte
  // chunks my_ch0, my_ch0 + tpr, ... in K and in V alike (one address), and
  // that row's two scales; the row's page (an index into pages_s) and
  // in-page offset advance by kKeys positions a tile without a division.
  constexpr int kChunk = 16 / sizeof(C);  // elements per 16-byte copy
  const int cpr = hd / kChunk;            // copies per key row
  const int tpr = nthreads / kKeys;       // threads per key row
  const int my_kk = tid / tpr;
  const int my_ch0 = tid - my_kk * tpr;
  int my_pg = (k_lo + my_kk) / bs - page0;
  int my_off = (k_lo + my_kk) % bs;
  __syncthreads();  // pages_s ready

  // Issue tile `it` (keys k_lo + it * kKeys ...) into ring stage it % kStages
  // (tiles are issued in order, one a call); always commits a group, empty
  // past the last tile.
  auto issue = [&](int it) {
    if (it < n_tiles) {
      const bool ok = k_lo + it * kKeys + my_kk <= k_hi;
      const int st = it % kStages;
      const size_t page = ok ? static_cast<size_t>(pages_s[my_pg]) : 0;
      const size_t row = (page * bs + my_off) * n_kv + kvh;
      C* k_dst = kv_s + (static_cast<size_t>(st) * 2 * kKeys + my_kk) * kvstride;
      C* v_dst = k_dst + kKeys * kvstride;
      for (int ch = my_ch0; ch < cpr; ch += tpr) {
        cp_async16(k_dst + ch * kChunk, k_pool + row * hd + ch * kChunk, ok);
        cp_async16(v_dst + ch * kChunk, v_pool + row * hd + ch * kChunk, ok);
      }
      if constexpr (kQuant) {
        if (my_ch0 == 0) {
          cp_async4(sc_s + st * 2 * kKeys + my_kk, k_scale + page * n_kv + kvh, ok);
          cp_async4(sc_s + st * 2 * kKeys + kKeys + my_kk, v_scale + page * n_kv + kvh, ok);
        }
      }
      my_off += kKeys;
      while (my_off >= bs) {
        my_off -= bs;
        ++my_pg;
      }
    }
    cp_async_commit();
  };

  const int ra = mt * 16 + gid;  // this thread's two tile rows
  const int rb = ra + 8;
  const int qpos_a = ra < nr ? cur + (r0 + ra) / g : -1;  // -1: a pad row sees nothing
  const int qpos_b = rb < nr ? cur + (r0 + rb) / g : -1;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;  // l: this thread's part
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) issue(it);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of tile it landed
    if constexpr (kCodes) {
      // Each thread converts the 16-byte chunks it copied: 16 codes, exact
      // in bf16, into the tile's bf16 buffer.
      const C* src = kv_s + (static_cast<size_t>(st) * 2 * kKeys + my_kk) * kvstride;
      __nv_bfloat16* dst = kvb_s + ((it & 1) * 2 * kKeys + my_kk) * bstride;
      for (int ch = my_ch0; ch < cpr; ch += tpr) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {  // K, then V
          const uint4 raw = *reinterpret_cast<const uint4*>(src + m * kKeys * kvstride + ch * 16);
          const C* c = reinterpret_cast<const C*>(&raw);
          uint32_t o[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = pack_bf16(to_f32(c[2 * e]), to_f32(c[2 * e + 1]));
          uint4* d = reinterpret_cast<uint4*>(dst + m * kKeys * bstride + ch * 16);
          d[0] = make_uint4(o[0], o[1], o[2], o[3]);
          d[1] = make_uint4(o[4], o[5], o[6], o[7]);
        }
      }
    }
    __syncthreads();  // everyone's copies (and conversions) of tile it are in;
                      // tile it - 1 is consumed
    issue(it + kStages - 1);
    const int base = k_lo + it * kKeys;
    const C* k_t = kv_s + static_cast<size_t>(st) * 2 * kKeys * kvstride;
    const C* v_t = k_t + kKeys * kvstride;
    const float* ks_t = sc_s + st * 2 * kKeys;
    const float* vs_t = ks_t + kKeys;
    // The bf16 K and V tiles the tensor cores read: the ring's own for a
    // bf16 pool, the converted buffer for codes.
    const __nv_bfloat16* kb_t = nullptr;
    if constexpr (kCodes) {
      kb_t = kvb_s + (it & 1) * 2 * kKeys * bstride;
    } else if constexpr (kMma) {
      kb_t = k_t;
    }

    // Scores of rows ra, rb against the tile's kKeys keys (kKN n-tiles of 8).
    float s[kKN][4];
#pragma unroll
    for (int nt = 0; nt < kKN; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
    if constexpr (kMma) {
      // ldmatrix addresses: Q rows (lane & 15) at column half lane >> 4;
      // K keys (lane & 7) + 8 * (lane >> 4) at column half (lane >> 3) & 1.
      const T* qa = q_s + (mt * 16 + (lane & 15)) * qstride + (lane >> 4) * 8;
      const int kbs = kCodes ? bstride : kvstride;
      const __nv_bfloat16* ka = kb_t + ((lane & 7) + (lane >> 4) * 8) * kbs + ((lane >> 3) & 1) * 8;
#pragma unroll 4
      for (int kb = 0; kb < hd / 16; ++kb) {
        uint32_t a[4], kf[4];
        ldsm_x4(a, qa + kb * 16);
        ldsm_x4(kf, ka + kb * 16);
        mma_bf16(s[0], a, kf[0], kf[1]);
        mma_bf16(s[1], a, kf[2], kf[3]);
      }
    } else {
      const T* qa = q_s + ra * qstride;
      const T* qb = qa + 8 * qstride;
#pragma unroll
      for (int nt = 0; nt < kKN; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const C* kr = k_t + (nt * 8 + 2 * tig + j) * kvstride;
          float sa = 0.f, sb = 0.f;
          for (int d = 0; d < hd; ++d) {
            const float kv = to_f32(kr[d]);
            sa += to_f32(qa[d]) * kv;
            sb += to_f32(qb[d]) * kv;
          }
          s[nt][j] = sa;
          s[nt][2 + j] = sb;
        }
    }

    // Scale, softcap, mask by position; the online softmax on the fragments.
    bool ok[kKN][4];
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < kKN; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = nt * 8 + 2 * tig + (c & 1);
        const int pos = base + key;
        const int qpos = c < 2 ? qpos_a : qpos_b;
        float v = s[nt][c] * scale;
        if constexpr (kQuant) v *= ks_t[key];
        v = apply_softcap(v, softcap);
        ok[nt][c] = pos <= k_hi && pos <= qpos && (window <= 0 || qpos - pos < window);
        s[nt][c] = v;
        if (ok[nt][c]) {
          if (c < 2) mx_a = fmaxf(mx_a, v);
          else mx_b = fmaxf(mx_b, v);
        }
      }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float alpha_a = expf(m_a - mn_a);
    const float alpha_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < kKN; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[nt][c] ? expf(s[nt][c] - (c < 2 ? mn_a : mn_b)) : 0.f;
        if (c < 2) sum_a += p;
        else sum_b += p;
        // P as P V consumes it: the key's v scale folded in.
        s[nt][c] = kQuant ? p * vs_t[nt * 8 + 2 * tig + (c & 1)] : p;
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

    // acc += P V over this warp's columns.  The score fragments of the
    // tile's two key n-tiles are exactly the A fragment of a 16 x 16 P.
    if constexpr (kMma) {
      // Over code pools P also as its bf16 remainder (a_lo): P at f32
      // accuracy, as the reference's f32 dequantized V keeps it.
      uint32_t a[4], a_lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* x = &s[i >> 1][(i & 1) * 2];
        if constexpr (kQuant) pack_bf16_split(x[0], x[1], a[i], a_lo[i]);
        else a[i] = pack_bf16(x[0], x[1]);
      }
      // V by ldmatrix.trans, two column tiles at a time: keys (lane & 7) +
      // 8 * ((lane >> 3) & 1), column tile + (lane >> 4).
      const int vbs = kCodes ? bstride : kvstride;
      const __nv_bfloat16* va = kb_t + kKeys * vbs +
                                ((lane & 7) + ((lane >> 3) & 1) * 8) * vbs + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        if ((n0 + n) * 8 < hd) {  // head_dim % 16 == 0: column tiles come in pairs
          uint32_t vf[4];
          ldsm_x4_trans(vf, va + (n0 + n) * 8);
          mma_bf16(acc[n], a, vf[0], vf[1]);
          mma_bf16(acc[n + 1], a, vf[2], vf[3]);
          if constexpr (kQuant) {
            mma_bf16(acc[n], a_lo, vf[0], vf[1]);
            mma_bf16(acc[n + 1], a_lo, vf[2], vf[3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kKeys; ++kk) {
        const int src = (lane & ~3) | ((kk & 7) >> 1);  // the lane holding key kk
        const float pa = __shfl_sync(0xffffffffu, s[kk >> 3][kk & 1], src);
        const float pb = __shfl_sync(0xffffffffu, s[kk >> 3][2 + (kk & 1)], src);
        const C* vr = v_t + kk * kvstride + 2 * tig;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          if ((n0 + n) * 8 < hd) {
            const float v0 = to_f32(vr[(n0 + n) * 8]);
            const float v1 = to_f32(vr[(n0 + n) * 8 + 1]);
            acc[n][0] += pa * v0;
            acc[n][1] += pa * v1;
            acc[n][2] += pb * v0;
            acc[n][3] += pb * v1;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  grid_dep_launch();

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = h ? rb : ra;
    if (rr >= nr) continue;
    const float m = h ? m_b : m_a;
    const float l = h ? l_b : l_a;
    if (n_splits == 1) {
      const float inv = 1.f / (l == 0.f ? 1.f : l);
      T* o = out + row_offset(rr);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int d = (n0 + n) * 8 + 2 * tig;
        if (d < hd) {
          o[d] = from_f32<T>(acc[n][2 * h] * inv);
          o[d + 1] = from_f32<T>(acc[n][2 * h + 1] * inv);
        }
      }
    } else {
      float* w = ws + ((static_cast<size_t>(b * n_kv + kvh) * n_splits + split) * rows + r0 + rr) *
                          (hd + 2);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int d = (n0 + n) * 8 + 2 * tig;
        if (d < hd) *reinterpret_cast<float2*>(w + d) = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      }
      if (n0 == 0 && tig == 0) *reinterpret_cast<float2*>(w + hd) = make_float2(m, l);
    }
  }
}

// The second pass of a split call: out = sum_s w_s acc_s / sum_s w_s l_s
// with w_s = exp(m_s - max m), l == 0 -> 1.  Grid (B, Hkv, row column
// pairs / kSplitThreads): one thread per output row and column pair, its
// loop over the splits unrolled so that their loads are in flight together.
template <typename T>
__global__ void __launch_bounds__(kSplitThreads) combine_splits_kernel(
    const float* __restrict__ ws, T* __restrict__ out, int q_len, int n_heads, int n_kv,
    int head_dim, int n_splits) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = n_heads / n_kv;
  const int hd = head_dim;
  const int rows = q_len * g;
  const int i = blockIdx.z * kSplitThreads + threadIdx.x;
  grid_dep_wait();
  if (i >= rows * (hd / 2)) return;
  const int r = i / (hd / 2);
  const int d = 2 * (i - r * (hd / 2));
  const size_t step = static_cast<size_t>(rows) * (hd + 2);  // from one split to the next
  const float* p = ws + (static_cast<size_t>(b * n_kv + kvh) * n_splits * rows + r) * (hd + 2);
  float mx = NEG_INF;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, p[s * step + hd]);
  float l = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s) {
    const float* ps = p + s * step;
    const float w = expf(ps[hd] - mx);
    const float2 a = *reinterpret_cast<const float2*>(ps + d);
    l += w * ps[hd + 1];
    o0 += w * a.x;
    o1 += w * a.y;
  }
  if (l == 0.f) l = 1.f;
  const int t = r / g;
  T* o = out + ((static_cast<size_t>(b) * q_len + t) * n_heads + kvh * g + (r - t * g)) * hd + d;
  o[0] = from_f32<T>(o0 / l);
  o[1] = from_f32<T>(o1 / l);
}

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *page_table, *cur_len;
  void* out;
  int batch, q_len, n_heads, n_kv, head_dim, block_size, n_pages, window;
  float softcap, scale;
  cudaStream_t stream;
  // The split body's split (plan_split in the wrapper) and its f32
  // workspace (null with one split); pages_per_split 0 selects the walk
  // body.
  int tile_rows = 0, pages_per_split = 0;
  void* ws = nullptr;
};

template <typename T, typename C, bool kQuant>
cudaError_t launch_walk(const Args& a) {
  const int g = a.n_heads / a.n_kv;
  const size_t smem = sizeof(float) * (static_cast<size_t>(g) * a.head_dim +
                                       2u * a.block_size * a.head_dim +
                                       static_cast<size_t>(g) * a.block_size +
                                       3u * g);  // m, l, alpha
  auto kernel = paged_attention_walk_kernel<T, C, kQuant>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.batch, a.n_kv), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const C*>(a.k_pool),
      static_cast<const C*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.page_table),
      static_cast<const int*>(a.cur_len), static_cast<T*>(a.out), a.n_heads, a.n_kv,
      a.head_dim, a.block_size, a.n_pages, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename T, typename C, bool kQuant, int kNT>
cudaError_t launch_split(const Args& a, int nm, int nc) {
  const int rows = a.q_len * (a.n_heads / a.n_kv);
  const int tiles = (rows + a.tile_rows - 1) / a.tile_rows;
  const int n_splits = (a.n_pages + a.pages_per_split - 1) / a.pages_per_split;
  const size_t smem = static_cast<size_t>(nm) * 16 * (a.head_dim * sizeof(T) + 16) +
                      static_cast<size_t>(kStages) * 2 * kKeys * (a.head_dim * sizeof(C) + 16) +
                      sizeof(float) * kStages * 2 * kKeys + sizeof(int) * a.pages_per_split +
                      (std::is_same<T, __nv_bfloat16>::value && !std::is_same<C, T>::value
                           ? sizeof(__nv_bfloat16) * 2 * 2 * kKeys * (a.head_dim + 8)
                           : 0);
  auto kernel = paged_attention_split_kernel<T, C, kQuant, kNT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int threads = 32 * nm * nc;
  kernel<<<dim3(a.batch, a.n_kv, tiles * n_splits), threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const C*>(a.k_pool),
      static_cast<const C*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.page_table),
      static_cast<const int*>(a.cur_len), static_cast<T*>(a.out), static_cast<float*>(a.ws),
      a.q_len, a.n_heads, a.n_kv, a.head_dim, a.block_size, a.n_pages, a.tile_rows,
      a.pages_per_split, n_splits, a.window, a.softcap, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  const int pairs = rows * (a.head_dim / 2);
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.batch, a.n_kv, (pairs + kSplitThreads - 1) / kSplitThreads);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.stream = a.stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, combine_splits_kernel<T>, static_cast<const float*>(a.ws),
                            static_cast<T*>(a.out), a.q_len, a.n_heads, a.n_kv, a.head_dim,
                            n_splits);
}

// The warps: nm m-tiles times nc = max(1, 4 / nm) column groups of P V,
// each kNT 8-wide column tiles wide (the least of 4, 8, 16, 32 that
// covers head_dim).
template <typename T, typename C, bool kQuant>
cudaError_t launch_split_hd(const Args& a) {
  const int nm = (a.tile_rows + 15) / 16;
  const int nc = nm >= 4 ? 1 : 4 / nm;
  const int need = (a.head_dim / 8 + nc - 1) / nc;  // column tiles per warp
  if (need <= 4) return launch_split<T, C, kQuant, 4>(a, nm, nc);
  if (need <= 8) return launch_split<T, C, kQuant, 8>(a, nm, nc);
  if (need <= 16) return launch_split<T, C, kQuant, 16>(a, nm, nc);
  return launch_split<T, C, kQuant, 32>(a, nm, nc);
}

// One body's launch for q's type (dtype: DTYPE_F32 or DTYPE_BF16, also the
// pools' type when code < 0) and the pools' code type (code: DTYPE_INT8 or
// DTYPE_FP8, or -1 for a full-precision pool).
template <template <typename, typename, bool> class Body>
cudaError_t dispatch(int dtype, int code, const Args& a) {
  if (dtype == DTYPE_F32) {
    if (code < 0) return Body<float, float, false>::launch(a);
    if (code == DTYPE_INT8) return Body<float, int8_t, true>::launch(a);
    if (code == DTYPE_FP8) return Body<float, __nv_fp8_e4m3, true>::launch(a);
  } else if (dtype == DTYPE_BF16) {
    if (code < 0) return Body<__nv_bfloat16, __nv_bfloat16, false>::launch(a);
    if (code == DTYPE_INT8) return Body<__nv_bfloat16, int8_t, true>::launch(a);
    if (code == DTYPE_FP8) return Body<__nv_bfloat16, __nv_fp8_e4m3, true>::launch(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename C, bool kQuant>
struct Split {
  static cudaError_t launch(const Args& a) { return launch_split_hd<T, C, kQuant>(a); }
};
template <typename T, typename C, bool kQuant>
struct Walk {
  static cudaError_t launch(const Args& a) { return launch_walk<T, C, kQuant>(a); }
};

bool shape_ok(const Args& a) {
  return a.n_kv > 0 && a.n_heads % a.n_kv == 0 && a.head_dim >= 1 && a.head_dim <= 256 &&
         a.block_size >= 1 && a.n_pages >= 1 && a.batch >= 1 && a.q_len >= 1;
}

// The split body: head_dim a multiple of 16, the wrapper's split.
int run_split(int dtype, int code, const Args& a) {
  if (!shape_ok(a) || a.head_dim % 16 != 0 || a.tile_rows < 1 ||
      a.tile_rows > kMaxTileRows || a.pages_per_split < 1 ||
      (a.pages_per_split < a.n_pages && a.ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<Split>(dtype, code, a));
}

// A single-token entry: the split body, or with pages_per_split 0 the walk
// body (one token, at most kWalkRows query heads per kv head).
int run_single(int dtype, int code, const Args& a) {
  if (a.pages_per_split > 0) return run_split(dtype, code, a);
  if (!shape_ok(a) || a.n_heads / a.n_kv > kWalkRows)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<Walk>(dtype, code, a));
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success).  The split arguments (workspace, tile_rows, pages_per_split)
// come from the wrapper's plan_split; a single-token entry given
// pages_per_split 0 runs the walk body.

extern "C" int paged_attention(int dtype, const void* q, const void* k_pool,
                               const void* v_pool, const void* page_table,
                               const void* cur_len, void* out, void* ws, int batch,
                               int tile_rows, int pages_per_split, int n_heads, int n_kv,
                               int head_dim, int block_size, int n_pages, int window,
                               float softcap, float scale, void* stream) {
  return run_single(dtype, -1, Args{q, k_pool, v_pool, nullptr, nullptr, page_table, cur_len,
                                    out, batch, 1, n_heads, n_kv, head_dim, block_size,
                                    n_pages, window, softcap, scale,
                                    static_cast<cudaStream_t>(stream), tile_rows,
                                    pages_per_split, ws});
}

extern "C" int paged_attention_multi(int dtype, const void* q, const void* k_pool,
                                     const void* v_pool, const void* page_table,
                                     const void* cur_len, void* out, void* ws, int batch,
                                     int q_len, int tile_rows, int pages_per_split,
                                     int n_heads, int n_kv, int head_dim, int block_size,
                                     int n_pages, int window, float softcap, float scale,
                                     void* stream) {
  return run_split(dtype, -1, Args{q, k_pool, v_pool, nullptr, nullptr, page_table, cur_len,
                                   out, batch, q_len, n_heads, n_kv, head_dim, block_size,
                                   n_pages, window, softcap, scale,
                                   static_cast<cudaStream_t>(stream), tile_rows,
                                   pages_per_split, ws});
}

extern "C" int paged_attention_quant(int dtype, int code, const void* q, const void* k_pool,
                                     const void* v_pool, const void* k_scale,
                                     const void* v_scale, const void* page_table,
                                     const void* cur_len, void* out, void* ws, int batch,
                                     int tile_rows, int pages_per_split, int n_heads,
                                     int n_kv, int head_dim, int block_size, int n_pages,
                                     int window, float softcap, float scale, void* stream) {
  if (code < 0) return static_cast<int>(cudaErrorInvalidValue);
  return run_single(dtype, code, Args{q, k_pool, v_pool, k_scale, v_scale, page_table,
                                      cur_len, out, batch, 1, n_heads, n_kv, head_dim,
                                      block_size, n_pages, window, softcap, scale,
                                      static_cast<cudaStream_t>(stream), tile_rows,
                                      pages_per_split, ws});
}

extern "C" int paged_attention_multi_quant(int dtype, int code, const void* q,
                                           const void* k_pool, const void* v_pool,
                                           const void* k_scale, const void* v_scale,
                                           const void* page_table, const void* cur_len,
                                           void* out, void* ws, int batch, int q_len,
                                           int tile_rows, int pages_per_split, int n_heads,
                                           int n_kv, int head_dim, int block_size,
                                           int n_pages, int window, float softcap,
                                           float scale, void* stream) {
  if (code < 0) return static_cast<int>(cudaErrorInvalidValue);
  return run_split(dtype, code, Args{q, k_pool, v_pool, k_scale, v_scale, page_table, cur_len,
                                     out, batch, q_len, n_heads, n_kv, head_dim, block_size,
                                     n_pages, window, softcap, scale,
                                     static_cast<cudaStream_t>(stream), tile_rows,
                                     pages_per_split, ws});
}
