// Walsh-Hadamard transform for Hopper (sm_90a): the unnormalized WHT over
// the last axis of a (rows, block) matrix (fwt_block, the row pass) and
// over the first axis of a (b1, b2) matrix (fwt_columns, the column pass),
// block and b1 powers of two, log2 butterfly stages in f32, the result in
// the input's type.
//
// Replaces the TPU kernel repro/kernels/fwt.py::fwt_block (body
// _fwt_block_kernel).  The reference's ops.fwt runs that kernel twice over
// a flat vector of N = B1 * B2 elements, with a transpose before and after
// the second pass; the port's ops.fwt runs the row pass on (B1, B2) and
// the column pass on its output, in place, with no transpose.
//
// Bound: bytes.  A 2^22 f32 task is 16 MB in and 16 MB out a pass, ~0.010
// ms a pass at 3.35 TB/s (0.010 ms for the whole task if the row pass's
// output stays in L2); its 10 + 12 adds an element are far below the
// card's rate.
//
// Exactness.  Stage h pairs a = (p / h) * 2h + p % h with a + h and writes
// (x[a] + x[a+h], x[a] - x[a+h]).  Every body runs the stages in the plain
// version's order h = 1, 2, 4, ..., so each output is the same f32
// operations, bit for bit.  Rows then columns is the flat transform's own
// stage order: the row pass owns the index's low bits.
//
// Row pass, VEC <= block <= 1024 (fwt_rows_kernel): a warp takes 32 * VEC
// * G consecutive elements: one row in G register groups, or several rows
// of a smaller block.  Each lane loads 16 bytes a group (VEC = 4 f32 or 8
// bf16).  Element e's bits go, low to high, to the vector slot, the lane
// (5 bits) and the group, so the stages run in registers, then by
// __shfl_xor_sync, then in registers again: no shared memory, no barrier.
// Blocks under VEC (f32 1 and 2, bf16 1, 2 and 4; 32 / block rows a warp)
// take the same body with VEC = 1: 4- or 2-byte loads, stages by shuffle.
//
// Row pass, 2048 <= block <= 2^15 (fwt_rows_smem_kernel): one block a row.
// Its warps run the low 10 bits of each 1024-element chunk as above and
// store the chunk as f32 in shared memory.  After one barrier each thread
// takes a column of the (block / 1024, 1024) view and runs the high stages
// in registers, writing the row out.  The f32 row needs the dynamic
// shared-memory opt-in above 48 KB (allow_smem).
//
// Column pass (fwt_columns_kernel): a block of 512 threads takes a strip
// of W columns (W = kStripWidth, halved while the strip's b1 x W f32 would
// pass 128 KB; at b1 = 4096, 128 blocks of 128 KB) and all b1 rows.  Seen
// as one flat index e = row * W + column, the strip's stages are the bits
// [log2 W, log2 W + log2 b1) of e.  Phase 1: a warp loads 1024 consecutive
// words of the strip straight into registers, 16 bytes a lane a load (a
// strip row is W * 4 = 32 bytes of one sector), laid out as in the row
// pass (vector slot, lane, group), runs the stages on e's bits 0-9 and
// stores them as f32 in shared memory.  Phase 2, after the block's one
// barrier: a warp's lanes take 32 consecutive words (e's bits 0-4, no stage
// left there), its registers e's bits 10-14; it runs those stages and
// writes out.  The loads go to registers, not through cp.async or TMA into
// shared memory: phase 1 needs the values in registers, so a copy to
// shared memory first would add a pass and a barrier and hold every
// butterfly back until the whole strip had landed; here the 16 warps of a
// block load and compute in turn.  Each block starts phase 1 at a
// different 1024-word item: blocks that run in step would otherwise all
// read the same rows of y at once, which the card serves more slowly than
// reads spread over the matrix.  Shared-memory accesses of f32 strips are
// 16 or 4 consecutive bytes a lane: no bank conflict, no padding (bf16's
// phase-1 stores, 32 bytes a lane, are 2-way).  A strip row
// under 16 bytes, a b2 that is not a multiple of 16 bytes, or a y that is
// not 16-byte aligned takes the same body with one element a load.  A
// strip of at most 1024 words needs no phase 2 and no shared memory.  out
// may alias y: every value of a block's strip is read before the barrier
// (in phase 1, each warp's own words before it writes them when there is
// no phase 2), and strips are disjoint.
//
//   fwt_block:   x, out (rows, block), contiguous, x 16-byte aligned
//   fwt_columns: y, out (b1, b2), contiguous (out may alias y)
//   f32 or bf16; block and b1 at most 2^15 (the wrappers raise above).

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLog = 15;  // block and b1 up to 2^15; a strip up to 2^15 f32 words
constexpr int kStripWidth = 8;  // columns a block in the column pass (f32: 32 bytes a row)
constexpr int kColumnThreads = 512;

__host__ __device__ constexpr int log2i(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// Stage h over values held in one thread's registers, v[k] with v[k + h].
template <int N>
__device__ __forceinline__ void reg_stage(float (&v)[N], int h) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k & h) continue;
    const float a = v[k], b = v[k + h];
    v[k] = a + b;
    v[k + h] = a - b;
  }
}

// The stage whose partner is lane ^ m: the lower lane keeps x[a] + x[a+h],
// the upper x[a] - x[a+h], each the plain version's one f32 operation.
template <int N>
__device__ __forceinline__ void lane_stage(float (&v)[N], int lane, int m) {
  const bool upper = lane & m;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float p = __shfl_xor_sync(0xffffffffu, v[k], m);
    v[k] = upper ? p - v[k] : v[k] + p;
  }
}

// The stages on bits [lo, hi) of a warp's chunk, whose element (g * 32 +
// lane) * VEC + i is v[g * VEC + i]: vector bits, lane bits, group bits.
template <int VEC, int G>
__device__ __forceinline__ void chunk_stages(float (&v)[G * VEC], int lane, int lo, int hi) {
  constexpr int kLv = log2i(VEC);
#pragma unroll
  for (int j = 0; (1 << j) < VEC; ++j)
    if (j >= lo && j < hi) reg_stage(v, 1 << j);
#pragma unroll
  for (int j = 0; j < 5; ++j)
    if (kLv + j >= lo && kLv + j < hi) lane_stage(v, lane, 1 << j);
#pragma unroll
  for (int j = 0; (1 << j) < G; ++j)
    if (kLv + 5 + j >= lo && kLv + 5 + j < hi) reg_stage(v, VEC << j);
}

// VEC consecutive elements as f32: one 16-byte access for VEC > 1.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  if constexpr (VEC == 1) {
    v[0] = to_f32(*p);
  } else if constexpr (std::is_same_v<T, float>) {
    static_assert(VEC == 4);
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    static_assert(VEC == 8);
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  if constexpr (VEC == 1) {
    *p = from_f32<T>(v[0]);
  } else if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
}

// ---- Row pass -------------------------------------------------------------

// n = rows * block elements, a multiple of VEC; lb = log2(block) <= log2(32
// VEC G).
template <typename T, int VEC, int G>
__global__ void __launch_bounds__(kThreads) fwt_rows_kernel(const T* __restrict__ x,
                                                            T* __restrict__ out, size_t n,
                                                            int lb) {
  constexpr int kChunk = 32 * VEC * G;
  const int lane = threadIdx.x & 31;
  const size_t base =
      (static_cast<size_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kChunk;
  if (base >= n) return;
  float v[G * VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t e = base + static_cast<size_t>(g * 32 + lane) * VEC;
    if (e < n) {
      load_vec<T, VEC>(x + e, v + g * VEC);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[g * VEC + i] = 0.f;
    }
  }
  chunk_stages<VEC, G>(v, lane, 0, lb);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t e = base + static_cast<size_t>(g * 32 + lane) * VEC;
    if (e < n) store_vec<T, VEC>(out + e, v + g * VEC);
  }
}

// One block a row of 2^lb > 1024 elements; 32 * VEC * G == 1024.
template <typename T, int VEC, int G>
__global__ void __launch_bounds__(kThreads) fwt_rows_smem_kernel(const T* __restrict__ x,
                                                                 T* __restrict__ out, int lb) {
  extern __shared__ float4 smem4[];
  float* row = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int chunks = 1 << (lb - 10);
  const size_t base = static_cast<size_t>(blockIdx.x) << lb;
  for (int c = threadIdx.x >> 5; c < chunks; c += kWarps) {
    float v[G * VEC];
#pragma unroll
    for (int g = 0; g < G; ++g)
      load_vec<T, VEC>(x + base + (c << 10) + (g * 32 + lane) * VEC, v + g * VEC);
    chunk_stages<VEC, G>(v, lane, 0, 10);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < VEC; i += 4)
        *reinterpret_cast<float4*>(row + (c << 10) + (g * 32 + lane) * VEC + i) =
            make_float4(v[g * VEC + i], v[g * VEC + i + 1], v[g * VEC + i + 2],
                        v[g * VEC + i + 3]);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 1024; j += kThreads) {
    float v[1 << (kMaxLog - 10)];
#pragma unroll
    for (int k = 0; k < (1 << (kMaxLog - 10)); ++k) v[k] = k < chunks ? row[(k << 10) + j] : 0.f;
#pragma unroll
    for (int s = 0; s < kMaxLog - 10; ++s)
      if ((1 << s) < chunks) reg_stage(v, 1 << s);
#pragma unroll
    for (int k = 0; k < (1 << (kMaxLog - 10)); ++k)
      if (k < chunks) out[base + (k << 10) + j] = from_f32<T>(v[k]);
  }
}

template <typename T, int VEC, int G>
cudaError_t launch_rows(const void* x, void* out, size_t n, int lb, cudaStream_t stream) {
  constexpr size_t kChunk = 32 * VEC * G;
  const size_t warps = (n + kChunk - 1) / kChunk;
  const unsigned grid = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  fwt_rows_kernel<T, VEC, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, lb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_block(const void* x, void* out, int rows, int block, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kMaxG = 1024 / (32 * kVec);
  const int lb = log2i(block);
  const size_t n = static_cast<size_t>(rows) * block;
  if (block > 1024) {
    const size_t smem = static_cast<size_t>(block) * sizeof(float);
    auto kernel = fwt_rows_smem_kernel<T, kVec, kMaxG>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<rows, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(out),
                                              lb);
    return cudaGetLastError();
  }
  if (block < kVec) return launch_rows<T, 1, 1>(x, out, n, lb, stream);
  const int g = block / (32 * kVec);
  if (g <= 1) return launch_rows<T, kVec, 1>(x, out, n, lb, stream);
  if (g == 2) return launch_rows<T, kVec, 2>(x, out, n, lb, stream);
  if (g == 4) return launch_rows<T, kVec, 4>(x, out, n, lb, stream);
  if constexpr (kMaxG == 8) return launch_rows<T, kVec, 8>(x, out, n, lb, stream);
  return cudaErrorInvalidValue;
}

// ---- Column pass ----------------------------------------------------------

// lb1 = log2(b1), w = log2(W); the strip holds 2^(lb1 + w) <= 2^15 words.
// VEC: elements a load (16 bytes: W * sizeof(T) >= 16, b2 * sizeof(T) % 16
// == 0 and y 16-byte aligned; else 1).
template <typename T, int VEC>
__global__ void __launch_bounds__(kColumnThreads) fwt_columns_kernel(const T* y, T* out,
                                                                     int lb1, int w, int b2) {
  constexpr int kG = 1024 / (32 * VEC);
  constexpr int kColumnWarps = kColumnThreads / 32;
  extern __shared__ float4 smem4[];
  float* work = reinterpret_cast<float*>(smem4);
  const int sb = lb1 + w;  // the strip's index bits; stages on [w, sb)
  const int words = 1 << sb;
  const int col0 = blockIdx.x << w;
  const int lane = threadIdx.x & 31;
  const bool two = sb > 10;
  // Strip word e = row * W + column sits at y[row * b2 + col0 + column].  A
  // lane's column is the same for every word it touches (32 VEC and 1024
  // are multiples of W), so its offsets step by whole rows.
  const int cols = (1 << w) - 1;
  // Phase 1: e = i * 1024 + (g * 32 + lane) * VEC + k, e's bits 0-9 in
  // registers, loaded straight from y.
  const bool in1 = col0 + ((lane * VEC) & cols) < b2;
  const size_t o1 = static_cast<size_t>((lane * VEC) >> w) * b2 + col0 + ((lane * VEC) & cols);
  const size_t g_step = static_cast<size_t>((32 * VEC) >> w) * b2;  // rows a group
  const size_t i_step = static_cast<size_t>(1024 >> w) * b2;  // rows an item
  // Blocks start their items at staggered rows: in step, every block would
  // read the same few rows of y at once.
  for (int i0 = threadIdx.x >> 5; (i0 << 10) < words; i0 += kColumnWarps) {
    const int i = words > 1024 ? (i0 + blockIdx.x) & ((words >> 10) - 1) : i0;
    float v[kG * VEC];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (in1 && (i << 10) + (g * 32 + lane) * VEC < words) {
        load_vec<T, VEC>(y + o1 + i * i_step + g * g_step, v + g * VEC);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[g * VEC + k] = 0.f;
      }
    }
    chunk_stages<VEC, kG>(v, lane, w, sb < 10 ? sb : 10);
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int e = (i << 10) + (g * 32 + lane) * VEC;
      if (e >= words) continue;
      if (two) {
        if constexpr (VEC == 1) {
          work[e] = v[g];
        } else {
#pragma unroll
          for (int k = 0; k < VEC; k += 4)
            *reinterpret_cast<float4*>(work + e + k) =
                make_float4(v[g * VEC + k], v[g * VEC + k + 1], v[g * VEC + k + 2],
                            v[g * VEC + k + 3]);
        }
      } else if (in1) {
        store_vec<T, VEC>(out + o1 + i * i_step + g * g_step, v + g * VEC);
      }
    }
  }
  if (!two) return;
  __syncthreads();
  // Phase 2: e = k * 1024 + i * 32 + lane, e's bits 10-14 in registers.
  const int groups = words >> 10;  // 2 .. 32
  const bool in2 = col0 + (lane & cols) < b2;
  for (int i = threadIdx.x >> 5; i < 32; i += kColumnWarps) {
    float v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] = k < groups ? work[(k << 10) + i * 32 + lane] : 0.f;
#pragma unroll
    for (int j = 0; j < 5; ++j)
      if (10 + j < sb) reg_stage(v, 1 << j);
    if (!in2) continue;
    T* o = out + static_cast<size_t>((i * 32 + lane) >> w) * b2 + col0 + (lane & cols);
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (k < groups) o[k * i_step] = from_f32<T>(v[k]);
  }
}

template <typename T, int VEC>
cudaError_t launch_strips(const void* y, void* out, int lb1, int w, int b2,
                               cudaStream_t stream) {
  const size_t smem = (sizeof(float) << (lb1 + w)) * (lb1 + w > 10);
  auto kernel = fwt_columns_kernel<T, VEC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((b2 + (1 << w) - 1) >> w);
  kernel<<<grid, kColumnThreads, smem, stream>>>(static_cast<const T*>(y),
                                                  static_cast<T*>(out), lb1, w, b2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_columns(const void* y, void* out, int b1, int b2, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int lb1 = log2i(b1);
  int w = log2i(kStripWidth);
  while (w > 0 && lb1 + w > kMaxLog) --w;
  if ((1 << w) >= kVec && b2 % kVec == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0)
    return launch_strips<T, kVec>(y, out, lb1, w, b2, stream);
  return launch_strips<T, 1>(y, out, lb1, w, b2, stream);
}

bool pow2_upto_max(int v) { return v > 0 && (v & (v - 1)) == 0 && v <= (1 << kMaxLog); }

}  // namespace

static_assert(kStripWidth >= 1 && kStripWidth <= 16 && (kStripWidth & (kStripWidth - 1)) == 0);

// dtype: DTYPE_F32 or DTYPE_BF16.  Each returns cudaGetLastError() after
// its one launch.
extern "C" int fwt_block(int dtype, const void* x, void* out, int rows, int block,
                         void* stream) {
  if (rows <= 0 || !pow2_upto_max(block)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return static_cast<int>(launch_block<float>(x, out, rows, block, s));
  if (dtype == DTYPE_BF16)
    return static_cast<int>(launch_block<__nv_bfloat16>(x, out, rows, block, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int fwt_columns(int dtype, const void* y, void* out, int b1, int b2, void* stream) {
  if (b2 <= 0 || !pow2_upto_max(b1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return static_cast<int>(launch_columns<float>(y, out, b1, b2, s));
  if (dtype == DTYPE_BF16)
    return static_cast<int>(launch_columns<__nv_bfloat16>(y, out, b1, b2, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
