// Needleman-Wunsch DP tiles for Hopper (sm_90a): a run of anti-diagonals
// [d0, d1) of the tile grid -- a whole task's grid, or one diagonal -- in
// one launch.
//
// Replaces the TPU kernel repro/kernels/nw_tile.py::nw_tile (body
// _nw_kernel, ladder _row_chain_max; driven by ops.nw_wavefront through
// core/wavefront.wavefront_scan, whose loop over diagonals the reference
// runs inside one compiled program).  The TPU kernel computes one tile from
// a north row, a west column and a corner gathered for it.  Here one launch
// walks the tiles (i, j) with d0 <= i + j < d1 (and i0 <= i < i1 when the
// run is one diagonal's) strip by strip, a strip being one tile column j:
//
//   * a block owns a strip and walks its tiles i top to bottom, row after
//     row: a tile's north row and corner are the strip's previous row and
//     west value, kept on the chip, so the strip is one band of B columns
//     and rows*B rows, and a tile's only outside input is its west column;
//   * the west column of tile (i, j) is tile (i, j - 1)'s east column.
//     When this launch computes that tile (j >= 1 and i + j - 1 >= d0), the
//     strip to the left publishes it row by row: one 64-bit store a row,
//     the value's bits beside a tag (the global row + 1), into a zeroed
//     link buffer.  The strip on the right loads the words of 4 rows
//     together, 4 rows ahead of their use, checks their tags with one warp
//     vote and polls until they match.  A strip lags its left neighbour by
//     a few rows, not a tile, and no fence is needed (a 64-bit access is
//     single-copy atomic).  Every other input was written before the launch
//     (the wavefront's state);
//   * blocks run in no order, so a block takes its strip from an atomic
//     ticket, in strip order: strip j - 1 is always held by a running or
//     finished block, and nothing deadlocks whatever the grid.  A block
//     that finishes a strip takes the next ticket.  The grid is the number
//     of strips, capped by what the card holds (occupancy x SMs);
//   * a tile's B x B scores are loaded before its rows run (B <= 32: a
//     register per row and lane; the next tile's are in flight while this
//     tile's rows run), so no row waits on a global load.
//
// The boundary I/O is the wavefront's state on the card
// (core/wavefront.py::WavefrontState, state indices = tile indices + 1):
//   north  = south[i][j + 1][:]   west = east[i + 1][j][:]   corner = corners[i][j]
//   writes south[i + 1][j + 1][:], east[i + 1][j + 1][:], corners[i + 1][j + 1]
//   and the tile into out (n, m) at rows i*B.., columns j*B..
// for the tiles of the run (a strip reads north and corner from it only at
// its first tile).
//
// In-tile recurrence (linear gap g), rows in order, one thread per column c:
//   tmp[c] = max(H[i-1][c-1] + sub[i][c], H[i-1][c] - g)
//   tmp[0] = max(tmp[0], west[i] - g)
//   H[i][c] = max_{c' <= c}(tmp[c'] - (c - c') g)     -- the shift-max ladder:
//   for shift = 1, 2, 4, ..: x[c] = max(x[c], x[c - shift] - g * shift)
// (columns c < shift take the reference's NEG = -1e9, which never wins).
// For B <= 32 the ladder is warp shuffles, and the next row's H[i][c - 1]
// comes out of the last step (lane c also finishes lane c - 1's value from
// the same two shuffled inputs) instead of one more shuffle; above B = 32,
// shared-memory ping-pong buffers with a __syncthreads per step.  Every
// value is the same f32 operation as in the plain version (g * shift is
// exact for a power-of-two shift), so kernel and plain agree bit for bit.
//
//   scores, out (n, m) f32 contiguous, n = rows * B, m = cols * B
//   south, east (rows + 1, cols + 1, B) f32; corners (rows + 1, cols + 1) f32
//   link (cols, n) uint64, zeroed: strip j's east column, row by row,
//        where strip j + 1 takes it in this launch (a run of one diagonal
//        links nothing and may pass no buffer)
//   ticket int32, zeroed
//   B a power of two, 1 <= B <= 1024
//
// What bounds it at the paper path's shape (2048 x 2048, B = 32, 64 x 64
// tiles): bytes, the scores read and the tiles written once (2 x 16 MB,
// ~0.010 ms at 3.35 TB/s) -- far below the design's latency chain: the last
// strip ends after its 2048 rows, each log2(B) dependent shuffle steps, plus
// 63 strip-to-strip lags of a few rows.  One launch a task takes the host
// out of that chain.

#include "common.cuh"

namespace {

constexpr float kNeg = -1e9f;
constexpr int kMaxBlock = 1024;
constexpr int kChunk = 8;  // rows unrolled together above B = 32
constexpr int kChunkAhead = kChunk / 2;  // and their west words in flight
constexpr int kGroup = 4;  // rows of west values loaded and checked together, at most

struct Run {
  const float* scores;
  float* out;
  float* south;
  float* east;
  float* corners;
  unsigned long long* link;
  int* ticket;
  int m, rows, cols, d0, d1, i0, i1, j_lo, n_strips;
  float gap;
};

__device__ __forceinline__ unsigned long long load_link(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void store_link(unsigned long long* p, float x, int grow) {
  const unsigned long long v = (static_cast<unsigned long long>(grow + 1) << 32) |
                               static_cast<unsigned int>(__float_as_uint(x));
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v));
}

// Whether tile (i, j)'s west column comes from the strip on the left in
// this launch (tile (i, j - 1) is in the run), else from the state.
__device__ __forceinline__ bool linked(const Run& r, int i, int j) {
  return j >= 1 && i + j - 1 >= r.d0;
}

// The west value of strip j's global row g from the state (tile (g / B,
// j - 1) was computed before the launch).
__device__ __forceinline__ float state_west(const Run& r, int j, int g, int block) {
  const int i = g / block;
  return __ldcg(&r.east[(static_cast<size_t>(i + 1) * (r.cols + 1) + j) * block + (g - i * block)]);
}

// The link word of strip j's global row g, published by strip j - 1.
__device__ __forceinline__ unsigned long long link_word(const Run& r, int j, int g, int block) {
  return load_link(r.link + static_cast<size_t>(j - 1) * r.rows * block + g);
}

__device__ __forceinline__ bool tagged(unsigned long long word, int g) {
  return static_cast<int>(word >> 32) == g + 1;
}

__device__ __forceinline__ int take_ticket(const Run& r) { return atomicAdd(r.ticket, 1); }

// B <= 32: one block of B threads (part of one warp) a strip.  The west
// values come in groups of kG rows: lanes 0 .. kG - 1 load one row's word
// each (one coalesced load a group), a group ahead of its use; at the
// group's first row a warp vote checks every tag (link words only), and
// shuffles hand the kG values to lane 0, the only lane that reads them.
template <int kB>
__global__ void __launch_bounds__(32) nw_warp_kernel(Run r, int) {
  constexpr unsigned mask = kB >= 32 ? 0xffffffffu : ((1u << kB) - 1u);
  constexpr int kG = kB < kGroup ? kB : kGroup;  // rows a group; divides kB
  constexpr int kLast = kB / 2;                  // the ladder's last shift
  const int c = threadIdx.x;
  const int sc = r.cols + 1;  // state row stride, in tiles
  const float gap = r.gap;
  const size_t n = static_cast<size_t>(r.rows) * kB;
  for (;;) {
    int t = 0;
    if (c == 0) t = take_ticket(r);
    t = __shfl_sync(mask, t, 0, kB);
    if (t >= r.n_strips) return;
    const int j = r.j_lo + t;
    const int i_beg = max(r.i0, r.d0 - j);
    const int i_end = min(r.i1, r.d1 - j);
    const int g_end = i_end * kB;
    const float* src = r.scores + static_cast<size_t>(j) * kB + c;
    float* dst = r.out + static_cast<size_t>(j) * kB + c;
    unsigned long long* link = r.link + static_cast<size_t>(j) * n;
    // Lane c < kG's word (link) or value (state) of row c of the group in
    // flight; a tile's groups are all linked or all not.
    unsigned long long word = 0;
    float value = 0.f;
    auto fetch = [&](int g0, bool lk) {
      if (c < kG) {
        if (lk) word = link_word(r, j, g0 + c, kB);
        else value = state_west(r, j, g0 + c, kB);
      }
    };
    auto all_tagged = [&](unsigned long long w, int g0) {
      return __all_sync(mask, c >= kG || tagged(w, g0 + c));
    };
    float cur[kB], nxt[kB];
#pragma unroll
    for (int k = 0; k < kB; ++k) cur[k] = __ldg(src + static_cast<size_t>(i_beg * kB + k) * r.m);
    fetch(i_beg * kB, linked(r, i_beg, j));
    float up = __ldcg(&r.south[(static_cast<size_t>(i_beg) * sc + j + 1) * kB + c]);
    float diag = __shfl_up_sync(mask, up, 1, kB);  // H[-1][c - 1]; the corner for column 0
    if (c == 0) diag = __ldcg(&r.corners[static_cast<size_t>(i_beg) * sc + j]);
    for (int i = i_beg; i < i_end; ++i) {
      if (i + 1 < i_end) {
#pragma unroll
        for (int k = 0; k < kB; ++k)
          nxt[k] = __ldg(src + static_cast<size_t>((i + 1) * kB + k) * r.m);
      }
      const bool lk = linked(r, i, j), lk_next = linked(r, i + 1, j);
      const bool publish = j + 1 < r.cols && i + j + 1 < r.d1;  // strip j + 1 takes this tile's rows
      float x = 0.f, east = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < kB; k0 += kG) {
        const int g0 = i * kB + k0;
        unsigned long long gw = word;  // this group's
        const float gv = value;
        const bool next_lk = k0 + kG < kB ? lk : lk_next;
        if (g0 + kG < g_end) fetch(g0 + kG, next_lk);
        if (lk && !all_tagged(gw, g0)) {
          // The left strip has not published these rows: poll them, then
          // wait for the next group too and load it again (it was read too
          // early), so that this strip falls back to the lag at which its
          // loads find their rows published.
          do {
            if (c < kG) gw = link_word(r, j, g0 + c, kB);
          } while (!all_tagged(gw, g0));
          if (g0 + kG < g_end && next_lk) {
            do {
              fetch(g0 + kG, true);
            } while (!all_tagged(word, g0 + kG));
          }
        }
        const float gwv = lk ? __uint_as_float(static_cast<unsigned int>(gw)) : gv;
        float ws[kG];
#pragma unroll
        for (int k = 0; k < kG; ++k) ws[k] = __shfl_sync(mask, gwv, k, kB);
#pragma unroll
        for (int kk = 0; kk < kG; ++kk) {
          const int k = k0 + kk;
          const int g = g0 + kk;
          const float w = ws[kk];
          x = fmaxf(diag + cur[k], up - gap);
          if (c == 0) x = fmaxf(x, w - gap);
#pragma unroll
          for (int shift = 1; shift < kLast; shift *= 2) {
            const float left = __shfl_up_sync(mask, x, shift, kB);
            x = fmaxf(x, c >= shift ? left - gap * static_cast<float>(shift) : kNeg);
          }
          if (kB > 1) {
            // The last step, and lane c - 1's result of it for the next
            // row's diagonal term: the same operations on the same
            // shuffled values.
            const float gs = gap * static_cast<float>(kLast);
            const float left = __shfl_up_sync(mask, x, kLast, kB);
            const float x1 = __shfl_up_sync(mask, x, 1, kB);
            const float left1 = __shfl_up_sync(mask, x, kLast + 1, kB);
            x = fmaxf(x, c >= kLast ? left - gs : kNeg);
            diag = fmaxf(x1, c - 1 >= kLast ? left1 - gs : kNeg);
          }
          if (c == 0) diag = w;
          up = x;
          dst[static_cast<size_t>(g) * r.m] = x;
          if (publish && c == kB - 1) store_link(link + g, x, g);
          const float e = __shfl_sync(mask, x, kB - 1, kB);
          if (c == k) east = e;
        }
      }
      const size_t out_tile = static_cast<size_t>(i + 1) * sc + j + 1;
      r.south[out_tile * kB + c] = x;
      r.east[out_tile * kB + c] = east;
      if (c == kB - 1) r.corners[out_tile] = x;
#pragma unroll
      for (int k = 0; k < kB; ++k) cur[k] = nxt[k];
    }
  }
}

// Above B = 32, the west value of strip j's global row g as a link word,
// the state's tagged as ready.
__device__ __forceinline__ unsigned long long block_west(const Run& r, int j, int g, int block) {
  if (linked(r, g / block, j)) return link_word(r, j, g, block);
  return (static_cast<unsigned long long>(g + 1) << 32) | __float_as_uint(state_west(r, j, g, block));
}

// B > 32: one block of B threads a strip, the ladder in shared memory;
// thread 0 keeps the west words of kChunk rows in flight.
__global__ void __launch_bounds__(kMaxBlock) nw_block_kernel(Run r, int block) {
  extern __shared__ float sm[];
  __shared__ int ticket;
  float* buf = sm;               // 2 * block: ladder ping-pong
  float* east = sm + 2 * block;  // block: the tile's east column
  const int c = threadIdx.x;
  const int sc = r.cols + 1;
  const float gap = r.gap;
  const size_t n = static_cast<size_t>(r.rows) * block;
  for (;;) {
    __syncthreads();  // the previous strip's readers of ticket are done
    if (c == 0) ticket = take_ticket(r);
    __syncthreads();
    const int t = ticket;
    if (t >= r.n_strips) return;
    const int j = r.j_lo + t;
    const int i_beg = max(r.i0, r.d0 - j);
    const int i_end = min(r.i1, r.d1 - j);
    const int g_beg = i_beg * block, g_end = i_end * block;
    const float* src = r.scores + static_cast<size_t>(j) * block + c;
    float* dst = r.out + static_cast<size_t>(j) * block + c;
    unsigned long long* link = r.link + static_cast<size_t>(j) * n;
    float cur[kChunk], nxt[kChunk];
    unsigned long long words[kChunk];  // thread 0's west values in flight, as link words
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      cur[k] = __ldg(src + static_cast<size_t>(g_beg + k) * r.m);
      if (c == 0 && k < kChunkAhead) words[k] = block_west(r, j, g_beg + k, block);
    }
    float up = __ldcg(&r.south[(static_cast<size_t>(i_beg) * sc + j + 1) * block + c]);
    buf[c] = up;
    __syncthreads();
    float diag = c > 0 ? buf[c - 1] : __ldcg(&r.corners[static_cast<size_t>(i_beg) * sc + j]);
    __syncthreads();  // buf is free
    float x = 0.f;
    for (int g0 = g_beg; g0 < g_end; g0 += kChunk) {
      if (g0 + kChunk < g_end) {
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
          nxt[k] = __ldg(src + static_cast<size_t>(g0 + kChunk + k) * r.m);
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int grow = g0 + k;
        float w = 0.f;
        if (c == 0) {
          if (grow + kChunkAhead < g_end)
            words[(k + kChunkAhead) % kChunk] = block_west(r, j, grow + kChunkAhead, block);
          while (!tagged(words[k], grow)) words[k] = block_west(r, j, grow, block);
          w = __uint_as_float(static_cast<unsigned int>(words[k]));
        }
        x = fmaxf(diag + cur[k], up - gap);
        if (c == 0) x = fmaxf(x, w - gap);
        int ping = 0;
        buf[c] = x;
        __syncthreads();
        for (int shift = 1; shift < block; shift *= 2) {
          const float left =
              c >= shift ? buf[ping * block + c - shift] - gap * static_cast<float>(shift) : kNeg;
          x = fmaxf(x, left);
          buf[(ping ^ 1) * block + c] = x;
          __syncthreads();
          ping ^= 1;
        }
        diag = c > 0 ? buf[ping * block + c - 1] : w;
        up = x;
        dst[static_cast<size_t>(grow) * r.m] = x;
        if (c == block - 1) {
          const int i = grow / block;
          if (j + 1 < r.cols && i + j + 1 < r.d1) store_link(link + grow, x, grow);
          east[grow % block] = x;
        }
        __syncthreads();  // every read of buf is done before the next row writes it
        if ((grow + 1) % block == 0) {  // the tile's last row: its boundary out
          const size_t out_tile = static_cast<size_t>(grow / block + 1) * sc + j + 1;
          r.south[out_tile * block + c] = x;
          r.east[out_tile * block + c] = east[c];
          if (c == block - 1) r.corners[out_tile] = x;
        }
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) cur[k] = nxt[k];
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Run& run, int block, size_t smem, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, smem);
  if (err != cudaSuccess) return err;
  kernel<<<max(1, min(run.n_strips, per_sm * sms)), block, smem, stream>>>(run, block);
  return cudaGetLastError();
}

}  // namespace

// The tiles (i, j) with d0 <= i + j < d1 and i0 <= i < i1 (i0 > 0 or
// i1 < rows only for a run of one diagonal).  Returns the first CUDA error
// of the launch.
extern "C" int nw_run(const float* scores, float* out, float* south, float* east,
                      float* corners, unsigned long long* link, int* ticket, int m, int rows,
                      int cols, int block, int d0, int d1, int i0, int i1, float gap,
                      void* stream) {
  if (block < 1 || block > kMaxBlock || (block & (block - 1)) != 0 || rows < 1 || cols < 1 ||
      d0 < 0 || d1 <= d0 || d1 > rows + cols - 1 || i0 < 0 || i1 <= i0 || i1 > rows ||
      ((i0 > 0 || i1 < rows) && d1 != d0 + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Run run{scores, out, south, east, corners, link, ticket, m, rows, cols, d0, d1, i0, i1,
          0, 0, gap};
  run.j_lo = max(0, d0 - (i1 - 1));
  const int j_hi = min(cols - 1, d1 - 1 - i0);
  run.n_strips = j_hi - run.j_lo + 1;
  if (run.n_strips < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (block) {
    case 1: err = launch(nw_warp_kernel<1>, run, block, 0, s); break;
    case 2: err = launch(nw_warp_kernel<2>, run, block, 0, s); break;
    case 4: err = launch(nw_warp_kernel<4>, run, block, 0, s); break;
    case 8: err = launch(nw_warp_kernel<8>, run, block, 0, s); break;
    case 16: err = launch(nw_warp_kernel<16>, run, block, 0, s); break;
    case 32: err = launch(nw_warp_kernel<32>, run, block, 0, s); break;
    default:
      err = launch(nw_block_kernel, run, block, 3 * static_cast<size_t>(block) * sizeof(float), s);
  }
  return static_cast<int>(err);
}
