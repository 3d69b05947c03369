// Tiled matmul for Hopper (sm_90a) on the tensor cores: out = x @ y with an
// f32 accumulator, out in result_type(x, y).
//
// Replaces the TPU kernel repro/kernels/streamed_matmul.py::streamed_matmul
// (body _mm_kernel, reached through ops.matmul).  There the (i, j, k) grid is
// sequential on one core and the k axis streams HBM->VMEM blocks into a VMEM
// f32 accumulator; the block sizes are VMEM sizes and every dimension must
// divide by them.  Here the k stream is a loop inside the block (blocks run
// in parallel, in no order), and edges are masked, so any (m, k) @ (k, n)
// works.
//
//   x (m, k), y (k, n): f32 or bf16, row-major, contiguous
//   out (m, n): f32 unless both inputs are bf16
//
// Numerics.  f32 means f32 accuracy: one TF32 product keeps ~11 bits of
// each operand (about three decimal digits), far from the 1e-5 the paper
// path's f32 tasks are held to.  So an f32 operand a is split into big =
// tf32(a) (cvt.rna: round to nearest, ties away) and small = tf32(a - big),
// and f32 x f32 runs three TF32 products per k-step into one f32
// accumulator, the small terms first: x_small y_big + x_big y_small +
// x_big y_big (3xTF32; the dropped x_small y_small is ~2^-22 of the
// product).  A bf16 value is exact in TF32 (its small part is 0), so f32 x
// bf16 and bf16 x f32 take two products, and bf16 x bf16 one bf16 product
// with f32 accumulation, rounded to bf16 at the end.  The tensor cores add
// into their accumulator with fewer than f32's bits of alignment (the low
// bits are cut, not rounded): summed over the 2048 k-steps of the paper
// path's task in one accumulator, that bias reached 1.6e-5 of the output's
// magnitude on the H100, past the f32 tolerance.  So the TF32 body sums
// each 32-deep k stage from zero on the tensor cores and adds it into the
// f32 accumulator with ordinary (rounded) f32 adds: 5.7e-7 then.
//
// Both bodies: a block computes a 128 x 128 tile of out with 8 warps, and the
// k stream goes through shared memory 32 at a time, in a ring of 3 stages
// filled by 16-byte cp.async copies (a row that is not a multiple of 16
// bytes, or a bf16 x of a TF32 product, by plain loads converted to f32),
// so the next two stages are in flight while one computes.
//
// The TF32 body (f32 x f32 and the mixed types) runs on wgmma.  Each of the
// two warpgroups computes 64 x 128 by m64n128k8 products: A, x's 64 rows,
// from registers (each warp loads and splits its own 16 rows: no element is
// split twice), B, y's stage, from shared memory.  wgmma's TF32 form takes
// only a K-major B, and y arrives row-major (k, n), so y does not go
// through cp.async: each thread loads 4 k-groups of 4 values of one column
// into registers one stage ahead (a warp reads 32 consecutive columns of a
// row), splits them and stores big and small as 16-byte vectors into
// [k / 4][n][4] tiles, K-major core matrices without swizzle (a warp's
// stores are 512 contiguous bytes: no bank conflict), while the tensor cores
// work on the stage before.  (The first version of this body ran the same
// split on mma.sync m16n8k8 with y read row-major: on an H100 SXM at 700
// W, 0.3597 ms at 2048^3, 7% slower than torch.matmul's SIMT SGEMM; its
// TF32 products ran at ~160 TFLOP/s, a third of the card's 495.  This one:
// 0.27 ms.)
//
// The bf16 body (bf16 x bf16) runs mma.sync m16n8k16, a warp 64 x 32 (4 m16
// by 4 n8 tiles); both tiles are read by ldmatrix (.trans for y), rows
// padded by 16 bytes so that the 8 row addresses fall in distinct banks.
//
// What bounds it at the paper path's shape (2048^3, f32): operations.  Three
// TF32 products of 2 * 2048^3 flops each over the H100's 495 TFLOP/s of
// dense TF32 take 0.104 ms (one product in full f32 FMA outside the tensor
// cores, 67 TFLOP/s: 0.256 ms); the 48 MB read and written take 0.014 ms at
// 3.35 TB/s.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps: 2 along m, 4 along n
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kWM = 64;  // the bf16 body's warp tile
constexpr int kWN = 32;
constexpr int kMT = kWM / 16;  // m16 tiles a warp
constexpr int kNT = kWN / 8;   // n8 tiles a warp

using bf16 = __nv_bfloat16;

// The TF32 value nearest to x, ties away from zero (low 13 bits zero).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// One stage of a (rows x cols) tile of a row-major (n_rows, n_cols) source
// into shared memory (row stride sstride elements of S): rows r0.., columns
// c0.., zero past the edges.  kVec: 16-byte cp.async copies (the source's
// rows are 16-byte multiples and it is 16-byte aligned; S == G), else
// element loads converted to S.
template <typename G, typename S, bool kVec, int kRows, int kCols>
__device__ __forceinline__ void load_tile(S* dst, int sstride, const G* __restrict__ src,
                                          int n_rows, int n_cols, int r0, int c0, int tid) {
  if constexpr (kVec) {
    constexpr int kPer = 16 / sizeof(G);     // elements a copy
    constexpr int kChunks = kCols / kPer;    // copies a row
    constexpr int kRowsPass = kThreads / kChunks;
    const int ch = tid % kChunks;
    const int c = c0 + ch * kPer;
#pragma unroll
    for (int rr = tid / kChunks; rr < kRows; rr += kRowsPass) {
      const int r = r0 + rr;
      const bool ok = r < n_rows && c < n_cols;
      cp_async16(dst + rr * sstride + ch * kPer,
                 ok ? src + static_cast<size_t>(r) * n_cols + c : src, ok);
    }
  } else {
    constexpr int kRowsPass = kThreads / kCols;
    const int cc = tid % kCols;
    const int c = c0 + cc;
#pragma unroll 4
    for (int rr = tid / kCols; rr < kRows; rr += kRowsPass) {
      const int r = r0 + rr;
      float val = 0.f;
      if (r < n_rows && c < n_cols) val = to_f32(src[static_cast<size_t>(r) * n_cols + c]);
      dst[rr * sstride + cc] = from_f32<S>(val);
    }
  }
}

template <typename TO>
__device__ __forceinline__ void store_pair(TO* __restrict__ out, int m, int n, int r, int c,
                                           float v0, float v1) {
  if (r >= m) return;
  TO* o = out + static_cast<size_t>(r) * n + c;
  if (c + 1 < n) {
    o[0] = from_f32<TO>(v0);
    o[1] = from_f32<TO>(v1);
  } else if (c < n) {
    o[0] = from_f32<TO>(v0);
  }
}

// ---- TF32 body on wgmma: f32 x f32 (3 products), f32 x bf16 and bf16 x f32 (2)

// d (64 x 128 per warpgroup, f32) += a (64 x 8 tf32, registers, the m16n8k8
// A fragment of each warp's 16 rows) * b (8 x 128 tf32, shared memory, K-major,
// by descriptor); scale_d 0: d = a * b.  Asynchronous: wgmma_commit / wgmma_wait.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %69, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc_b));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps a register live, unchanged, past this point (after wgmma_wait: the
// asynchronous products wrote or read it).
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void keep(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
// Shared-memory stores made by threads become visible to wgmma's reads (the
// async proxy) after this fence and a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma shared-memory descriptor of a K-major operand without swizzle:
// 8-row x 16-byte core matrices, lbo bytes apart along K, sbo bytes apart
// along N.
__device__ __forceinline__ uint64_t kmajor_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

static_assert(kBN == 128 && kBM == 128 && kThreads == 256,
              "the TF32 body: two warpgroups of m64n128k8 products");
constexpr int kAStride = kBK + 4;  // floats: a0 = x[gid][tig] hits banks 4 gid + tig
constexpr int kATile = kBM * kAStride;
constexpr int kBtTile = kBK * kBN;  // y's stage, K-major: [kBK / 4][kBN][4]
// The x ring, then two stages of y's big and small tiles (stage it in
// buffer it % 2: stage it + 1 is written while stage it is read).
constexpr size_t kTf32Smem = (kStages * kATile + 2 * 2 * kBtTile) * sizeof(float);

template <typename TX, typename TY, bool kVecX>
__global__ void __launch_bounds__(kThreads) matmul_tf32_kernel(
    const TX* __restrict__ x, const TY* __restrict__ y, float* __restrict__ out, int m, int n,
    int k) {
  constexpr bool kSplitX = std::is_same<TX, float>::value;  // x has a small part
  constexpr bool kSplitY = std::is_same<TY, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* a_ring = reinterpret_cast<float*>(smem_raw);
  float* bt = a_ring + kStages * kATile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wg = warp >> 2;  // warpgroup: rows 64 wg .. 64 wg + 63 of the tile
  const int wr = warp & 3;   // the warp's 16 rows within them
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int n_k = (k + kBK - 1) / kBK;

  auto issue_a = [&](int it) {
    if (it < n_k)
      load_tile<TX, float, kVecX, kBM, kBK>(a_ring + (it % kStages) * kATile, kAStride, x, m, k,
                                            row0, it * kBK, tid);
    cp_async_commit();
  };
  // y: this thread owns column bn of the tile and its k-groups bg0 + 2 j
  // (4 k each): plain loads into registers one stage ahead (a warp reads 32
  // consecutive columns of a row), split, and 16-byte stores of each
  // k-group's 4 values, K-major: a warp stores 512 contiguous bytes.
  const int bn = tid % kBN;
  const int bg0 = tid / kBN;
  const bool col_ok = col0 + bn < n;
  float breg[4][4];
  auto load_b = [&](int it) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = it * kBK + 4 * (bg0 + 2 * j) + e;
        breg[j][e] = (it < n_k && kk < k && col_ok)
                         ? to_f32(y[static_cast<size_t>(kk) * n + col0 + bn]) : 0.f;
      }
  };
  auto store_b = [&](int buf) {
    float* big = bt + buf * 2 * kBtTile;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = __uint_as_float(tf32_rna(breg[j][e]));
        lo[e] = __uint_as_float(tf32_rna(breg[j][e] - hi[e]));
      }
      const int off = ((bg0 + 2 * j) * kBN + bn) * 4;
      *reinterpret_cast<float4*>(big + off) = make_float4(hi[0], hi[1], hi[2], hi[3]);
      if constexpr (kSplitY)
        *reinterpret_cast<float4*>(big + kBtTile + off) = make_float4(lo[0], lo[1], lo[2], lo[3]);
    }
  };

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) issue_a(it);
  load_b(0);
  store_b(0);
  load_b(1);
  for (int it = 0; it < n_k; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of x's stage it landed
    fence_proxy_async();           // its stores of y's stage it, for wgmma
    __syncthreads();
    issue_a(it + kStages - 1);
    // A fragments of the warp's 16 rows for the stage's 4 k-steps, split:
    // (gid, tig), (gid + 8, tig), (gid, tig + 4), (gid + 8, tig + 4).
    const float* a_s =
        a_ring + (it % kStages) * kATile + (wg * 64 + wr * 16 + gid) * kAStride + tig;
    uint32_t ab[4][4], as[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = a_s[(e & 1) * 8 * kAStride + s * 8 + (e >> 1) * 4];
        ab[s][e] = tf32_rna(v);
        as[s][e] = kSplitX ? tf32_rna(v - __uint_as_float(ab[s][e])) : 0u;
      }
    // The stage's products from zero (its first has scale_d 0), the small
    // terms first; each k-step reads two 16-byte k-groups of y's tile.
    const float* b_big = bt + (it & 1) * 2 * kBtTile;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t d_big = kmajor_desc(b_big + 2 * s * kBN * 4, kBN * 16, 128);
      const uint64_t d_small = kmajor_desc(b_big + kBtTile + 2 * s * kBN * 4, kBN * 16, 128);
      if constexpr (kSplitX) wgmma_m64n128k8_tf32(part, as[s], d_big, s > 0);
      if constexpr (kSplitY) wgmma_m64n128k8_tf32(part, ab[s], d_small, s > 0 || kSplitX);
      wgmma_m64n128k8_tf32(part, ab[s], d_big, s > 0 || kSplitX || kSplitY);
    }
    wgmma_commit();
    // y's next stage while the tensor cores work.
    if (it + 1 < n_k) {
      store_b((it + 1) & 1);
      load_b(it + 2);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        keep(ab[s][e]);
        keep(as[s][e]);
      }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      keep(part[i]);
      acc[i] += part[i];
    }
  }
  cp_async_wait<0>();

  // The accumulator fragment: element 4 j + c is row gid + 8 (c / 2), column
  // 8 j + 2 tig + c % 2 of the warp's 16 rows.
  const int r = row0 + wg * 64 + wr * 16 + gid;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = col0 + 8 * j + 2 * tig;
    store_pair(out, m, n, r, c, acc[4 * j], acc[4 * j + 1]);
    store_pair(out, m, n, r + 8, c, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---- bf16 body: bf16 x bf16, one bf16 product --------------------------------

constexpr int kHAStride = kBK + 8;  // bf16
constexpr int kHBStride = kBN + 8;
constexpr size_t kBf16StageElems = kBM * kHAStride + kBK * kHBStride;
constexpr size_t kBf16Smem = kStages * kBf16StageElems * sizeof(bf16);

template <bool kVecX, bool kVecY>
__global__ void __launch_bounds__(kThreads, 2) matmul_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ y, bf16* __restrict__ out, int m,
    int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int n_k = (k + kBK - 1) / kBK;

  auto issue = [&](int it) {
    if (it < n_k) {
      bf16* a_s = smem + (it % kStages) * kBf16StageElems;
      bf16* b_s = a_s + kBM * kHAStride;
      load_tile<bf16, bf16, kVecX, kBM, kBK>(a_s, kHAStride, x, m, k, row0, it * kBK, tid);
      load_tile<bf16, bf16, kVecY, kBK, kBN>(b_s, kHBStride, y, k, n, it * kBK, col0, tid);
    }
    cp_async_commit();
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) issue(it);
  for (int it = 0; it < n_k; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(it + kStages - 1);
    const bf16* a_s = smem + (it % kStages) * kBf16StageElems;
    const bf16* b_s = a_s + kBM * kHAStride;
    // ldmatrix addresses: x rows (lane & 15) at column half lane >> 4; y
    // (.trans) k rows (lane & 7) + 8 * ((lane >> 3) & 1), n tile + (lane >> 4).
    const bf16* aa = a_s + (wm * kWM + (lane & 15)) * kHAStride + (lane >> 4) * 8;
    const bf16* ba = b_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * kHBStride + wn * kWN +
                     (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t bf[kNT / 2][4];
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) ldsm_x4_trans(bf[j], ba + kk * kHBStride + j * 16);
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        uint32_t a[4];
        ldsm_x4(a, aa + i * 16 * kHAStride + kk);
#pragma unroll
        for (int j = 0; j < kNT / 2; ++j) {
          mma_bf16(acc[i][2 * j], a, bf[j][0], bf[j][1]);
          mma_bf16(acc[i][2 * j + 1], a, bf[j][2], bf[j][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int r = row0 + wm * kWM + i * 16 + gid;
      const int c = col0 + wn * kWN + j * 8 + 2 * tig;
      store_pair(out, m, n, r, c, acc[i][j][0], acc[i][j][1]);
      store_pair(out, m, n, r + 8, c, acc[i][j][2], acc[i][j][3]);
    }
}

template <typename TX, typename TY, bool kVecX>
cudaError_t launch_tf32(const void* x, const void* y, void* out, int m, int n, int k,
                        cudaStream_t stream) {
  auto kernel = matmul_tf32_kernel<TX, TY, kVecX>;
  cudaError_t err = allow_smem(kernel, kTf32Smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kTf32Smem, stream>>>(static_cast<const TX*>(x),
                                                 static_cast<const TY*>(y),
                                                 static_cast<float*>(out), m, n, k);
  return cudaGetLastError();
}

template <bool kVecX, bool kVecY>
cudaError_t launch_bf16(const void* x, const void* y, void* out, int m, int n, int k,
                        cudaStream_t stream) {
  auto kernel = matmul_bf16_kernel<kVecX, kVecY>;
  cudaError_t err = allow_smem(kernel, kBf16Smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kBf16Smem, stream>>>(static_cast<const bf16*>(x),
                                                 static_cast<const bf16*>(y),
                                                 static_cast<bf16*>(out), m, n, k);
  return cudaGetLastError();
}

}  // namespace

// x_dtype / y_dtype: DTYPE_F32 or DTYPE_BF16; the output is bf16 only when
// both are.  An operand's stages are 16-byte cp.async copies when it starts
// on a 16-byte boundary with rows of a multiple of 16 bytes, and is the
// bf16 body's x or y or the TF32 body's f32 x (a bf16 x of a TF32 product
// is converted to f32 on the way, and the TF32 body's y goes through
// registers); else plain loads.  Returns cudaGetLastError() after the
// launch.
extern "C" int streamed_matmul(int x_dtype, int y_dtype, const void* x, const void* y,
                               void* out, int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool xb = x_dtype == DTYPE_BF16, yb = y_dtype == DTYPE_BF16;
  if ((x_dtype != DTYPE_F32 && !xb) || (y_dtype != DTYPE_F32 && !yb))
    return static_cast<int>(cudaErrorInvalidValue);
  auto fits = [](const void* p, int row, bool b16) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && row % (b16 ? 8 : 4) == 0;
  };
  const bool vx = fits(x, k, xb) && (!xb || yb);
  const bool vy = xb && yb && fits(y, n, yb);
  cudaError_t err;
  if (xb && yb) {
    err = vx ? (vy ? launch_bf16<true, true>(x, y, out, m, n, k, s)
                   : launch_bf16<true, false>(x, y, out, m, n, k, s))
             : (vy ? launch_bf16<false, true>(x, y, out, m, n, k, s)
                   : launch_bf16<false, false>(x, y, out, m, n, k, s));
  } else if (xb) {
    err = launch_tf32<bf16, float, false>(x, y, out, m, n, k, s);
  } else if (yb) {
    err = vx ? launch_tf32<float, bf16, true>(x, y, out, m, n, k, s)
             : launch_tf32<float, bf16, false>(x, y, out, m, n, k, s);
  } else {
    err = vx ? launch_tf32<float, float, true>(x, y, out, m, n, k, s)
             : launch_tf32<float, float, false>(x, y, out, m, n, k, s);
  }
  return static_cast<int>(err);
}
