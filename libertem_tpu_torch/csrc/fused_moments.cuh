// Fused moments + mask projection for one (D, P) block of frames: the
// kernels and their launchers, shared by `fused_moments.cu` and
// `fused_moments_wide.cu` (the production entry points for the 1- and
// 2-byte and for the 4- and 8-byte input types) and
// `fused_moments_ablation.cu` (the stage ablation), which nvcc builds
// apart and at once.
//
// Replaces the TPU kernel `_fused_moments_pallas`
// (libertem_tpu/ops/moments.py:135).  One read of x gives
//   y[d, m]   = sum_p x[d, p] * masks[m, p]            (D, M)
//   colsum[p] = sum_d x[d, p]                          (P)
//   colvar[p] = sum_{d < valid} (x[d, p] - mean[p])^2  (P)
// with x of any of u8/i8/u16/i16/i32/u32/f32/f16/bf16/f64/i64/u64, cast
// to f32 once, for any mask count M.
//
// Bound on the H100: memory, for the paths' M.  x is read once at its
// raw width (2 bytes a pixel for u16 counts); the product is 2*D*P*M
// FLOPs, on the tensor cores as up to three TF32 passes (3 * 2*D*P*M
// over 495 TFLOP/s: below the bytes' time up to M = 40 for u16).  The
// moments are ~5 FLOPs a pixel on the CUDA cores.  `mma.sync` reaches
// about a quarter of the TF32 rate (measured: ~512 FLOP a clock an
// SM), so at M = 6 two passes take about as long as a fp32 FMA
// product would; from M = 12 on it is the cheaper product by far.
// What the design does about it:
//   * x streams through a ring of sub-tiles in shared memory (cp.async,
//     16 bytes a copy), each sub-tile `rows` rows x SUB_PX = 128
//     pixels; the ring keeps one or two sub-tiles in flight while the
//     CTA computes on one.  Each warp loads its own 32-pixel band of x
//     and of the masks and reads only that, so a warp barrier orders
//     the ring and the warps of a CTA run apart.  A CTA takes the
//     sub-tiles of its pixel chunk in order.  Each element is read
//     from shared memory once, into the registers of the warp that owns its
//     pixels, and cast to f32 there once (8- and 16-bit integers in
//     two full-rate ops).
//   * The product runs on the tensor cores, `mma.sync.m16n8k8` in TF32
//     with f32 accumulators: frames are the MMA's rows, pixels its k,
//     masks its n (zero-padded to a multiple of 8).  TF32 alone keeps
//     ~11 bits; the 3xTF32 form splits each operand into hi =
//     tf32(v) (rounded, in two integer ops) and lo = v - hi, which the
//     MMA reads truncated, and accumulates x_hi m_hi + x_hi m_lo +
//     x_lo m_hi, about as exact as an f32 product (the counterpart of
//     the JAX kernel's bf16 split terms).  The passes a sub-tile needs
//     are decided once a step from its data: x_hi m_lo where a mask
//     value is not TF32 already, x_lo m_hi unless x is (1-byte, f16
//     and bf16 input always, u16 when no value of the sub-tile is
//     2^11 or more): counts and 0/1 masks take one pass.  A call may
//     ask for one pass outright (`passes` = 1, the precision "default"):
//     an instantiation of its own (ONE_PASS) with no votes, x and the
//     masks rounded to TF32 and x_hi m_hi alone, within 2^-9 of
//     |x| @ |m|; where the data needs no lo pass it gives the
//     three-pass call's bits.  A compile-time mode leaves the
//     three-pass kernel's code as it was (a run-time one cost it 1-3%).
//   * The k order inside a warp's 32-pixel unit is permuted so that a
//     thread's A values of 4 k-steps are 8 neighbouring pixels of two
//     rows: one 16-byte shared load a row for u16.  Rows of a sub-tile
//     are padded so those loads are free of bank conflicts.
//   * The column moments come from the same registers: a thread sums
//     its 8 pixels over its rows (the shifted two-moment form about the
//     row chunk's first row: exact 0 for constant data, stable for a
//     large mean with a narrow spread), and the 8 lanes that share
//     pixels fold their sums once a sub-tile (halving shuffles).
//   * Each warp keeps its B fragments (the masks of its 32 pixels,
//     split) in registers while it walks the rows of the sub-tile, and
//     its accumulators for every row and mask of the CTA across all
//     sub-tiles; the four warps' accumulators are summed once a CTA in
//     a fixed order.
// Every mask count takes one read of x up to M = 128 (NT = 16 n-tiles
// of accumulators); beyond that the CTA walks x again for each further
// 128 masks (the accumulators would not fit the registers, and 128
// pixels a CTA would make y's partials larger than x).
//
// Work split.  The TPU kernel carries colsum/colvar across a
// sequential grid.  Here CTAs run in no order, so the work is two
// launches, each a single launch a call for any M:
//   1. `moments_partials`, a 2-D grid of (pixel chunks x row chunks).
//      Each CTA covers `rows` rows (a multiple of 16 up to 128 for one
//      n-tile of masks, 64 up to 32 masks, fewer beyond) x about
//      `chunk` pixels (a multiple of 128), from the caller's grid plan
//      (ops/moments.py `plan_grid`).  It writes its
//      row chunk's sum and the shifted moments of each pixel, and its
//      pixel chunk's partial projections of each row, (n_pc, D, M).
//   2. `moments_combine` folds the row-chunk partials of each pixel
//      with the Chan/Golub/LeVeque update and sums the pixel-chunk
//      partials of y, 8 lanes per output, each over every 8th chunk,
//      then a shuffle tree in a fixed order.  It is a programmatic
//      dependent launch: the partials kernel lets it be scheduled as
//      soon as all its CTAs have started, and its CTAs wait, beside
//      them, for that grid's results.  The chunk means enter
//      the update relative to chunk 0's shift, (c_j - c_0) +
//      mean_j(x - c_j): small numbers whose differences keep their
//      digits when the data's mean is large against its spread.
// No float atomics anywhere and a fixed order of every sum: two runs
// give identical bits.  Folding the combine into the partials kernel
// was measured slower on the H100 twice: the CTA that draws a pixel
// chunk's last ticket combining it alone (1.59x), and clusters of 8
// CTAs folding the moments through distributed shared memory with a
// last-CTA tail for y (2x at M = 6).
//
// The launch allocates nothing (the caller passes outputs and
// scratch), runs on the caller's stream and returns
// cudaGetLastError().
//
// Stage ablation.  `moments_partials` takes a compile-time STAGE; the
// production kernel is STAGE_FULL, and each lower stage drops the
// pieces above it (`if constexpr`), so the cost of a piece is the
// difference between successive stages of the code the main path
// runs.  `fused_moments_ablation_launch` replaces the TPU kernel
// `ablated` (benchmarks/bench_kernel_ablation.py:48), a stage
// ablation of `_fused_moments_pallas`:
//   load_min  the cp.async ring moves every byte; the first and last
//             row of each row chunk enter colsum
//   load      + every element read from shared memory, the raw widen:
//             an integer colsum per chunk (float input: the f32 colsum)
//   cast      + to_float and the f32 colsum of the production code
//   dot       + the 3xTF32 split and the tensor-core product into y
//   var       + the shifted moments with row masking: the production
//             partials kernel
//   full      + moments_combine: fused_moments itself
// The JAX stages `dec` and `dot2` (the split of x and the passes after
// the first) are not gated apart: the split's passes are skipped by
// the data, not by a stage, so `dot` holds all of them.  Each launch
// also runs the combine (stages below dot with M = 0, below var with
// the variance off) unless told to skip it, so every stage's outputs
// can be held against a plain version; the ablation takes u8, u16 and
// f32 input.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int PX = 8;                   // pixels a thread holds of a unit
constexpr int THREADS = 128;            // threads per CTA
constexpr int WARPS = THREADS / 32;
constexpr int UNIT_PX = 32;             // pixels of a warp's unit: 4 k-steps
constexpr int SUB_PX = UNIT_PX * WARPS; // pixels of a sub-tile
constexpr int TILE_ROWS = 16;           // rows of an MMA tile
constexpr int MAX_CHUNK_PX = 8192;      // pixels per CTA, at most
constexpr int COMBINE_THREADS = 256;
constexpr int LANES = 8;                // combine lanes per output
constexpr int SMEM_LIMIT = 232448;      // shared memory a CTA may use

// stages of the partials kernel (see the header); `var` launches the
// STAGE_FULL partials and skips the combine
constexpr int STAGE_LOAD_MIN = 0;
constexpr int STAGE_LOAD = 1;
constexpr int STAGE_CAST = 2;
constexpr int STAGE_DOT = 3;
constexpr int STAGE_VAR = 4;
constexpr int STAGE_FULL = 5;

// n-tiles of 8 masks a CTA accumulates at once (NT) and the row tiles
// of 16 rows that leaves room for in the registers (one n-tile: 8, so
// that a CTA of 128 rows writes half the moment partials of one of 64)
__host__ __device__ constexpr int row_tiles_for(int nt) {
  return nt == 1 ? 8 : nt <= 4 ? 4 : nt == 8 ? 2 : 1;
}

// 8 raw elements: one thread's pixels of one row
template <typename T>
struct alignas(sizeof(T) * PX) Raw8 {
  T v[PX];
};

// bytes of a sub-tile row in shared memory: 128 pixels and a pad that
// puts the rows a thread group reads at once on distinct banks
template <typename T>
constexpr int kStride =
    SUB_PX * static_cast<int>(sizeof(T)) +
    (sizeof(T) == 1 ? 32 : sizeof(T) == 2 ? 64 : 16);

// bytes of a sub-tile's mask row (128 f32 pixels): the pad puts the
// two rows a quarter warp reads at once on distinct banks
constexpr int MSTRIDE = SUB_PX * 4 + 16;

// sub-tiles in the ring: three (two in flight); two for 8-byte types,
// for one n-tile of masks (whose CTAs take up to 128 rows: 32 KB a u16
// slot) and for 16 n-tiles
__host__ __device__ constexpr int ring_stages(int itemsize, int nt) {
  return itemsize == 8 || nt == 1 || nt == 16 ? 2 : 3;
}

// types whose values all fit TF32's 11 significant bits: no x_lo pass
template <typename T>
constexpr bool kExactTf32 =
    sizeof(T) == 1 || std::is_same<T, __half>::value ||
    std::is_same<T, __nv_bfloat16>::value;

template <typename T>
__device__ __forceinline__ float to_float(T v) {
  return static_cast<float>(v);
}
// 8- and 16-bit integers: the value in the low mantissa bits of 2^23,
// minus 2^23 (and the sign offset): exact, and two full-rate ops
// instead of a conversion
template <>
__device__ __forceinline__ float to_float<uint8_t>(uint8_t v) {
  return __uint_as_float(0x4b000000u | v) - 8388608.f;
}
template <>
__device__ __forceinline__ float to_float<uint16_t>(uint16_t v) {
  return __uint_as_float(0x4b000000u | v) - 8388608.f;
}
template <>
__device__ __forceinline__ float to_float<int8_t>(int8_t v) {
  return __uint_as_float(0x4b000000u | (static_cast<uint8_t>(v) ^ 0x80u)) -
         8388736.f;
}
template <>
__device__ __forceinline__ float to_float<int16_t>(int16_t v) {
  return __uint_as_float(0x4b000000u |
                         (static_cast<uint16_t>(v) ^ 0x8000u)) -
         8421376.f;
}
template <>
__device__ __forceinline__ float to_float<__half>(__half v) {
  return __half2float(v);
}
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T zero_of() {
  return T(0);
}
template <>
__device__ __forceinline__ __half zero_of<__half>() {
  return __float2half(0.f);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// the load stage's accumulator: exact integer sums of a 64-row chunk
// for 1- and 2-byte integers, float otherwise
template <typename T>
using Widen = typename std::conditional<
    std::is_integral<T>::value && sizeof(T) <= 2, int, float>::type;

template <typename T>
__device__ __forceinline__ Widen<T> widen(T v) {
  if constexpr (std::is_integral<T>::value && sizeof(T) <= 2)
    return static_cast<int>(v);
  else
    return to_float(v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a thread's 8 pixels of one sub-tile row from shared memory
template <typename T>
__device__ __forceinline__ Raw8<T> lds8(const unsigned char* p) {
  Raw8<T> r;
  if constexpr (sizeof(T) == 1) {
    *reinterpret_cast<uint2*>(&r) = *reinterpret_cast<const uint2*>(p);
  } else {
#pragma unroll
    for (int k = 0; k < static_cast<int>(sizeof(T)) / 2; ++k)
      reinterpret_cast<uint4*>(&r)[k] = reinterpret_cast<const uint4*>(p)[k];
  }
  return r;
}

// TF32 of v, rounded to nearest with ties away from zero (the
// rounding of cvt.rna.tf32.f32, in two integer ops instead of a
// conversion); the MMA itself would truncate v's low 13 bits
__device__ __forceinline__ unsigned tf32_round(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// hi = tf32_round(v), lo = v - hi in f32 (exact); the MMA reads the
// top 19 bits of lo, so lo enters it truncated toward zero
__device__ __forceinline__ void split(float v, unsigned& hi, unsigned& lo) {
  hi = tf32_round(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// How the row tiles take x: its f32 bits as they are (every value is
// TF32 already), rounded to TF32 (the one-pass product), or split
// into hi and lo (the x_lo m_hi pass)
constexpr int X_EXACT = 0;
constexpr int X_ROUND = 1;
constexpr int X_SPLIT = 2;
template <int V>
using XMode = std::integral_constant<int, V>;

// d += a b over one 16 x 8 x 8 tile
__device__ __forceinline__ void mma(float (&d)[4], unsigned a0, unsigned a1,
                                    unsigned a2, unsigned a3, unsigned b0,
                                    unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Sum N values over the 8 lanes of a warp that share lane & 3 (the
// MMA's groups): each step keeps half the values (the lower half on
// lanes with the step's bit clear, the upper half on the others) and
// adds the partner's copy of them.  Lane g (= lane >> 2) ends with the
// K = N / 8 values at g * K.
template <int N, int OFF>
struct GroupSum {
  template <int K>
  __device__ __forceinline__ static void run(const float (&v)[N], int lane,
                                             float (&out)[K]) {
    if constexpr (OFF < 4) {
      static_assert(N == K, "GroupSum ends with N / 8 values a lane");
#pragma unroll
      for (int i = 0; i < N; ++i) out[i] = v[i];
    } else {
      static_assert(N % 2 == 0, "GroupSum halves its values");
      constexpr int H = N / 2;
      const bool upper = lane & OFF;
      float w[H];
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = upper ? v[i] : v[i + H];
        const float keep = upper ? v[i + H] : v[i];
        w[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      GroupSum<H, OFF / 2>::run(w, lane, out);
    }
  }
};

// One mask row's 8 values for this thread's pixels (from the ring
// slot; zeros past M or P), split into hi and lo; returns whether any
// lane of the warp has a nonzero lo (a pass that is needed).
__device__ __forceinline__ bool mask_fragment(const unsigned char* p,
                                              unsigned (&bh)[PX],
                                              unsigned (&bl)[PX]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  const float v[PX] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  unsigned any = 0;
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    split(v[i], bh[i], bl[i]);
    any |= bl[i];
  }
  return __any_sync(0xffffffffu, any != 0);
}

// Whether any lane's 8 mask values are not TF32 already (low 13 bits
// set): the m_lo pass is needed.
__device__ __forceinline__ bool mask_needs_lo(const unsigned char* p) {
  const uint4 a = reinterpret_cast<const uint4*>(p)[0];
  const uint4 b = reinterpret_cast<const uint4*>(p)[1];
  return __any_sync(0xffffffffu, ((a.x | a.y | a.z | a.w | b.x | b.y | b.z |
                                   b.w) & 0x1fffu) != 0);
}

// The same values split without the vote; lo only where a pass needs
// it.
__device__ __forceinline__ void mask_split(const unsigned char* p, bool lo,
                                           unsigned (&bh)[PX],
                                           unsigned (&bl)[PX]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  const float v[PX] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    if (lo)
      split(v[i], bh[i], bl[i]);
    else
      bh[i] = tf32_round(v[i]);
  }
}

// (n, mean, m2) of two disjoint sets of rows, `a` before `b`
__device__ __forceinline__ void chan(float& n, float& mean, float& m2,
                                     float nb, float meanb, float m2b) {
  const float nn = n + nb;
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb, mean = meanb, m2 = m2b;
    return;
  }
  const float delta = meanb - mean;
  mean += delta * (nb / nn);
  m2 += m2b + delta * delta * (n * nb / nn);
  n = nn;
}

template <typename T, int NT, int STAGE = STAGE_FULL, bool ONE_PASS = false>
__global__ void __launch_bounds__(THREADS)
moments_partials(const T* __restrict__ x, const float* __restrict__ masks,
                 int D, int P, int M, int chunk_rows, int chunk,
                 int valid, int vec_ok, int mask_vec, int compute_var,
                 float* __restrict__ ypart, float* __restrict__ psum,
                 float* __restrict__ pshift, float* __restrict__ pm1,
                 float* __restrict__ pm2) {
  constexpr bool kDot = STAGE >= STAGE_DOT;
  constexpr bool kVar = STAGE >= STAGE_VAR;
  constexpr int RT = row_tiles_for(NT);
  constexpr int RING = ring_stages(sizeof(T), NT);
  constexpr int STRIDE = kStride<T>;
  constexpr int BLOCK_M = NT * 8;  // mask columns one walk over x serves
  // B fragments held for the whole sub-tile when they are few
  constexpr bool kHoist = NT <= 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pc = blockIdx.x;
  const int rc = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // the MMA's group: rows g and g + 8
  const int t = lane & 3;   // its thread in the group: pixels 8t .. 8t + 7
  const int r0 = rc * chunk_rows;
  const int rows = min(chunk_rows, D - r0);
  const int row_tiles = (rows + TILE_ROWS - 1) / TILE_ROWS;
  const int nvar =
      kVar && compute_var ? max(0, min(rows, valid - r0)) : 0;
  const float inv_n = 1.f / static_cast<float>(max(nvar, 1));
  // the CTA's sub-tiles: the 128-pixel sub-tiles of its pixel chunk
  const int sub0 = pc * (chunk / SUB_PX);
  const int n_sub = min(chunk / SUB_PX, (P + SUB_PX - 1) / SUB_PX - sub0);
  const int n_mb = kDot ? (M + BLOCK_M - 1) / BLOCK_M : 1;
  const int steps = n_mb * n_sub;
  // a slot: the sub-tile of x, then its mask rows of one mask block
  const int mrows = kDot ? (min(M, BLOCK_M) + 7) / 8 * 8 : 0;
  const size_t x_bytes = (size_t)chunk_rows * STRIDE;
  const size_t slot_bytes = x_bytes + (size_t)mrows * MSTRIDE;
  unsigned char* ring = smem;
  // the warps' accumulators of a mask block: after the ring when x is
  // walked again for a further block, else in the ring, which the last
  // step leaves idle
  float* red = reinterpret_cast<float*>(n_mb > 1 ? smem + RING * slot_bytes
                                                 : smem);

  // Step s: this warp's band (its 32-pixel unit) of sub-tile s % n_sub
  // and of its masks (mask block s / n_sub) into ring slot s % RING.
  // Each warp loads what it reads, so a warp barrier orders the ring:
  // the warps of a CTA run apart until its last step.  Whole aligned
  // 16-byte pieces go by cp.async; the ragged edge, unaligned rows and
  // rows past the block or past M are element loads and zeros, stored
  // directly.  A lane's pieces are the same every step.
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements a piece
  constexpr int PPR = UNIT_PX / EPC;      // pieces of a row of the band
  constexpr int RSTEP = 32 / PPR;         // rows a round of the warp
  constexpr int MPR = UNIT_PX / 4;        // pieces of a mask row of it
  const int band = warp * UNIT_PX;        // the band's first pixel
  const int xq = lane % PPR;
  const int xrow0 = lane / PPR;
  const T* xsrc = x + (size_t)(r0 + xrow0) * P + band + xq * EPC;
  const size_t xstep = (size_t)RSTEP * P;
  auto load_step = [&](int step) {
    unsigned char* slot = ring + (step % RING) * slot_bytes;
    const int px0 = (sub0 + step % n_sub) * SUB_PX;
    const int bx = px0 + band;
    unsigned char* xdst = slot + band * sizeof(T);
    if (vec_ok && bx + UNIT_PX <= P) {
      unsigned char* dst = xdst + xrow0 * STRIDE + xq * 16;
      const T* src = xsrc + px0;
      for (int row = xrow0; row < chunk_rows; row += RSTEP) {
        if (row < rows)
          copy16(dst, src);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
        dst += RSTEP * STRIDE;
        src += xstep;
      }
    } else {
      for (int c = lane; c < chunk_rows * PPR; c += 32) {
        const int row = c / PPR;
        const int px = bx + c % PPR * EPC;
        const T* src = x + (size_t)(r0 + row) * P + px;
        alignas(16) T v[EPC];
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          v[e] = (row < rows && px + e < P) ? src[e] : zero_of<T>();
        *reinterpret_cast<uint4*>(xdst + row * STRIDE + c % PPR * 16) =
            *reinterpret_cast<const uint4*>(v);
      }
    }
    const int m0 = step / n_sub * BLOCK_M;
    unsigned char* mdst = slot + x_bytes + band * 4;
    for (int c = lane; c < mrows * MPR; c += 32) {
      const int m = m0 + c / MPR;
      const int px = bx + c % MPR * 4;
      unsigned char* dst = mdst + (c / MPR) * MSTRIDE + c % MPR * 16;
      const float* src = masks + (size_t)m * P + px;
      if (m < M && mask_vec && px + 4 <= P) {
        copy16(dst, src);
      } else {
        float4 v;
        v.x = (m < M && px < P) ? src[0] : 0.f;
        v.y = (m < M && px + 1 < P) ? src[1] : 0.f;
        v.z = (m < M && px + 2 < P) ? src[2] : 0.f;
        v.w = (m < M && px + 3 < P) ? src[3] : 0.f;
        *reinterpret_cast<float4*>(dst) = v;
      }
    }
  };

  float acc[RT][NT][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[rt][nt][k] = 0.f;
  float s[PX], c[PX], s1[PX], s2[PX];
  Widen<T> ws[PX];  // the load stage's colsum
#pragma unroll
  for (int i = 0; i < PX; ++i) s[i] = c[i] = s1[i] = s2[i] = 0.f, ws[i] = 0;

#pragma unroll
  for (int k = 0; k < RING - 1; ++k) {
    if (k < steps) load_step(k);
    commit_async();
  }
  // the combine may be scheduled as soon as every CTA has started: its
  // CTAs wait in griddepcontrol.wait, beside these, for this grid's
  // results
  asm volatile("griddepcontrol.launch_dependents;\n");
  for (int i = 0; i < steps; ++i) {
    // step i has landed in this warp's band, and the warp is done with
    // step i - 1's slot, whose band step i + RING - 1 now fills
    wait_async<RING - 2>();
    __syncwarp();
    if (i + RING - 1 < steps) load_step(i + RING - 1);
    commit_async();
    const int mb = i / n_sub;
    const int j = i - mb * n_sub;
    const bool moments = mb == 0;
    const unsigned char* slot = ring + (i % RING) * slot_bytes;
    const int upx = warp * UNIT_PX + t * PX;  // the thread's first pixel
    const int p0 = (sub0 + j) * SUB_PX + upx;
    // this thread's mask values: row nt * 8 + g of the slot's block
    const unsigned char* mrow =
        slot + x_bytes + (size_t)g * MSTRIDE + upx * 4;

    // B fragments: all of them split once a step when they are few,
    // else one n-tile at a time.  The passes a step needs are decided
    // once a step, so that the row tiles run as straight-line code the
    // compiler can interleave: x_hi m_lo where any mask value of the
    // sub-tile is not TF32 already, x_lo m_hi unless x is (1-byte,
    // f16 and bf16 input always; u16 when no value of the sub-tile's
    // rows is 2^11 or more).  One pass asked for: no vote, hi alone.
    unsigned bh[kHoist ? NT : 1][PX], bl[kHoist ? NT : 1][PX];
    bool mlo = false;
    if constexpr (kDot) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt * 8 >= mrows) continue;  // CTA-uniform
        if constexpr (kHoist && ONE_PASS)
          mask_split(mrow + nt * 8 * MSTRIDE, false, bh[nt], bl[nt]);
        else if constexpr (kHoist)
          mlo |= mask_fragment(mrow + nt * 8 * MSTRIDE, bh[nt], bl[nt]);
        else if constexpr (!ONE_PASS)
          mlo |= mask_needs_lo(mrow + nt * 8 * MSTRIDE);
      }
    }
    bool exact = kExactTf32<T>;
    if constexpr (kDot && !ONE_PASS &&
                  std::is_same<T, uint16_t>::value) {
      unsigned big = 0;
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        if (rt >= row_tiles) continue;
        const unsigned char* pa =
            slot + (rt * TILE_ROWS + g) * STRIDE + upx * sizeof(T);
        const uint4 wa = *reinterpret_cast<const uint4*>(pa);
        const uint4 wb = *reinterpret_cast<const uint4*>(pa + 8 * STRIDE);
        big |= wa.x | wa.y | wa.z | wa.w | wb.x | wb.y | wb.z | wb.w;
      }
      exact = !__any_sync(0xffffffffu, (big & 0xf800f800u) != 0);
    }

    // the row tiles of the sub-tile, with x taken as XM says, and with
    // the m_lo pass (ML) or without
    auto run = [&](auto xm, auto ml) {
      constexpr int XM = decltype(xm)::value;
      constexpr bool ML = decltype(ml)::value;
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        if (rt >= row_tiles) continue;  // CTA-uniform
        const int ra = rt * TILE_ROWS + g;  // this thread's rows ra, ra + 8
        const unsigned char* pa = slot + ra * STRIDE + upx * sizeof(T);
        const unsigned char* pb = pa + 8 * STRIDE;
        if constexpr (STAGE == STAGE_LOAD_MIN) {
          // the chunk's first and last rows only (rows == 1: once)
          if (moments) {
            if (ra == 0 || ra == rows - 1) {
              const Raw8<T> a = lds8<T>(pa);
#pragma unroll
              for (int k = 0; k < PX; ++k) s[k] += to_float(a.v[k]);
            }
            if (ra + 8 == rows - 1) {
              const Raw8<T> b = lds8<T>(pb);
#pragma unroll
              for (int k = 0; k < PX; ++k) s[k] += to_float(b.v[k]);
            }
          }
          continue;
        }
        const Raw8<T> a = lds8<T>(pa);
        const Raw8<T> b = lds8<T>(pb);
        if constexpr (STAGE == STAGE_LOAD) {
          if (moments) {
#pragma unroll
            for (int k = 0; k < PX; ++k)
              ws[k] += widen(a.v[k]) + widen(b.v[k]);
          }
          continue;
        }
        float xa[PX], xb[PX];
#pragma unroll
        for (int k = 0; k < PX; ++k) xa[k] = to_float(a.v[k]);
#pragma unroll
        for (int k = 0; k < PX; ++k) xb[k] = to_float(b.v[k]);
        if (moments) {
          if (rt == 0) {
            // the shift: the chunk's first row, held by the group's lane 0
#pragma unroll
            for (int k = 0; k < PX; ++k)
              c[k] = __shfl_sync(0xffffffffu, xa[k], t);
          }
#pragma unroll
          for (int k = 0; k < PX; ++k) s[k] += xa[k] + xb[k];
          if constexpr (kVar) {
            if (ra < nvar) {
#pragma unroll
              for (int k = 0; k < PX; ++k) {
                const float d = xa[k] - c[k];
                s1[k] += d;
                s2[k] = fmaf(d, d, s2[k]);
              }
            }
            if (ra + 8 < nvar) {
#pragma unroll
              for (int k = 0; k < PX; ++k) {
                const float d = xb[k] - c[k];
                s1[k] += d;
                s2[k] = fmaf(d, d, s2[k]);
              }
            }
          }
        }
        if constexpr (kDot) {
          // A fragments: k-step q takes pixels 2q (k = t) and 2q + 1
          // (k = t + 4) of each thread's 8; the B fragments follow the
          // same order
          unsigned ah[2][PX], al[2][PX];
#pragma unroll
          for (int k = 0; k < PX; ++k) {
            if constexpr (XM == X_EXACT) {
              ah[0][k] = __float_as_uint(xa[k]);
              ah[1][k] = __float_as_uint(xb[k]);
            } else if constexpr (XM == X_ROUND) {
              ah[0][k] = tf32_round(xa[k]);
              ah[1][k] = tf32_round(xb[k]);
            } else {
              split(xa[k], ah[0][k], al[0][k]);
              split(xb[k], ah[1][k], al[1][k]);
            }
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (mb * BLOCK_M + nt * 8 >= M) continue;  // CTA-uniform
            unsigned fh[PX], fl[PX];
            if constexpr (kHoist) {
#pragma unroll
              for (int k = 0; k < PX; ++k) {
                fh[k] = bh[nt][k];
                if constexpr (ML) fl[k] = bl[nt][k];
              }
            } else {
              mask_split(mrow + nt * 8 * MSTRIDE, ML, fh, fl);
            }
#pragma unroll
            for (int q = 0; q < PX / 2; ++q) {
              mma(acc[rt][nt], ah[0][2 * q], ah[1][2 * q], ah[0][2 * q + 1],
                  ah[1][2 * q + 1], fh[2 * q], fh[2 * q + 1]);
              if constexpr (ML)
                mma(acc[rt][nt], ah[0][2 * q], ah[1][2 * q],
                    ah[0][2 * q + 1], ah[1][2 * q + 1], fl[2 * q],
                    fl[2 * q + 1]);
              if constexpr (XM == X_SPLIT)
                mma(acc[rt][nt], al[0][2 * q], al[1][2 * q],
                    al[0][2 * q + 1], al[1][2 * q + 1], fh[2 * q],
                    fh[2 * q + 1]);
            }
          }
        }
      }
    };
    using Yes = std::true_type;
    using No = std::false_type;
    using Exact = XMode<X_EXACT>;
    using Split = XMode<X_SPLIT>;
    if constexpr (!kDot) {
      run(Exact{}, No{});
    } else if constexpr (ONE_PASS) {
      if constexpr (kExactTf32<T>)
        run(Exact{}, No{});
      else
        run(XMode<X_ROUND>{}, No{});
    } else if constexpr (kExactTf32<T>) {
      if (mlo) run(Exact{}, Yes{}); else run(Exact{}, No{});
    } else if constexpr (std::is_same<T, uint16_t>::value) {
      if (exact) {
        if (mlo) run(Exact{}, Yes{}); else run(Exact{}, No{});
      } else {
        if (mlo) run(Split{}, Yes{}); else run(Split{}, No{});
      }
    } else {
      if (mlo) run(Split{}, Yes{}); else run(Split{}, No{});
    }

    if (moments) {
      // fold the 8 lanes of each group: lane (g, t) ends with pixel
      // 8t + g of the unit, as (sum, sum of x - c, sum of (x - c)^2)
      if constexpr (STAGE == STAGE_LOAD) {
#pragma unroll
        for (int k = 0; k < PX; ++k) s[k] = static_cast<float>(ws[k]), ws[k] = 0;
      }
      float shift = c[0];
#pragma unroll
      for (int k = 1; k < PX; ++k)
        if (g == k) shift = c[k];
      float v[3 * PX], o[3];
#pragma unroll
      for (int k = 0; k < PX; ++k)
        v[3 * k] = s[k], v[3 * k + 1] = s1[k], v[3 * k + 2] = s2[k];
      GroupSum<3 * PX, 16>::run(v, lane, o);
      const int p = p0 + g;
      if (p < P) {
        const size_t at = (size_t)rc * P + p;
        psum[at] = o[0];
        if (kVar && compute_var) {
          const float m1 = o[1] * inv_n;
          pshift[at] = shift;
          pm1[at] = m1;
          pm2[at] = fmaxf(0.f, o[2] - o[1] * m1);
        }
      }
#pragma unroll
      for (int k = 0; k < PX; ++k) s[k] = s1[k] = s2[k] = 0.f;
    }

    if constexpr (kDot) {
      if (j == n_sub - 1) {
        // the mask block's projections of the CTA's rows: each warp's
        // accumulators into red[warp][row][col], then the warps summed
        // in order
        const int cols = min(BLOCK_M, M - mb * BLOCK_M);
        const int ld = (cols + 7) / 8 * 8;
        __syncthreads();  // every warp is done with the ring
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          if (rt >= row_tiles) continue;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (nt * 8 >= cols) continue;
            float* w = red + ((size_t)warp * chunk_rows + rt * TILE_ROWS + g) *
                                 ld + nt * 8 + 2 * t;
            w[0] = acc[rt][nt][0];
            w[1] = acc[rt][nt][1];
            w[8 * ld] = acc[rt][nt][2];
            w[8 * ld + 1] = acc[rt][nt][3];
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[rt][nt][k] = 0.f;
          }
        }
        __syncthreads();
        for (int k = tid; k < rows * cols; k += THREADS) {
          const int rr = k / cols;
          const int m = k - rr * cols;
          float v = 0.f;
#pragma unroll
          for (int w = 0; w < WARPS; ++w)
            v += red[((size_t)w * chunk_rows + rr) * ld + m];
          ypart[((size_t)pc * D + r0 + rr) * M + mb * BLOCK_M + m] = v;
        }
        // the next use of red comes after the next step's barrier
      }
    }
  }
  wait_async<0>();
}

__global__ void __launch_bounds__(COMBINE_THREADS)
moments_combine(const float* __restrict__ ypart,
                const float* __restrict__ psum,
                const float* __restrict__ pshift,
                const float* __restrict__ pm1,
                const float* __restrict__ pm2, int D, int P, int M,
                int chunk_rows, int n_pc, int n_rc, int valid,
                int compute_var,
                float* __restrict__ y, float* __restrict__ colsum,
                float* __restrict__ colvar) {
  // launched while the partials kernel drains: wait for its results
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long gt = (long)blockIdx.x * COMBINE_THREADS + threadIdx.x;
  const long item = gt / LANES;
  const int g = static_cast<int>(gt % LANES);
  // the 8 lanes of an item share its branch; shuffles stay among them
  const unsigned gmask = 0xffu << (threadIdx.x & 31 & ~(LANES - 1));
  if (item < P) {
    const long t = item;
    float s = 0.f;
    for (int j = g; j < n_rc; j += LANES) s += psum[(size_t)j * P + t];
#pragma unroll
    for (int off = 1; off < LANES; off <<= 1)
      s += __shfl_xor_sync(gmask, s, off);
    // means relative to chunk 0's shift c0; all 0 when compute_var is
    // off or valid == 0
    const int n_var =
        compute_var ? min(n_rc, (valid + chunk_rows - 1) / chunk_rows) : 0;
    const float c0 = n_var > 0 ? pshift[t] : 0.f;
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int j = g; j < n_var; j += LANES) {
      const size_t at = (size_t)j * P + t;
      const int r0 = j * chunk_rows;
      chan(n, mean, m2,
           static_cast<float>(min(min(chunk_rows, D - r0), valid - r0)),
           (pshift[at] - c0) + pm1[at], pm2[at]);
    }
#pragma unroll
    for (int off = 1; off < LANES; off <<= 1) {
      const float nb = __shfl_xor_sync(gmask, n, off);
      const float meanb = __shfl_xor_sync(gmask, mean, off);
      const float m2b = __shfl_xor_sync(gmask, m2, off);
      if (g & off) {
        // both lanes of a pair combine (lower lane, upper lane), so
        // they agree bit for bit
        float na = nb, meana = meanb, m2a = m2b;
        chan(na, meana, m2a, n, mean, m2);
        n = na, mean = meana, m2 = m2a;
      } else {
        chan(n, mean, m2, nb, meanb, m2b);
      }
    }
    if (g == 0) {
      colsum[t] = s;
      colvar[t] = m2;
    }
    return;
  }
  // y[d, m]: the pixel chunks' partials (n_pc, D, M)
  const long k = item - P;
  if (k < (long)D * M) {
    float v = 0.f;
    for (int j = g; j < n_pc; j += LANES) v += ypart[(size_t)j * D * M + k];
#pragma unroll
    for (int off = 1; off < LANES; off <<= 1)
      v += __shfl_xor_sync(gmask, v, off);
    if (g == 0) y[k] = v;
  }
}

// n-tiles a CTA accumulates at once for M masks: 1, 2, 4, 8 or 16
int nt_for(int M) {
  const int nt = (M + 7) / 8;
  return nt <= 1 ? 1 : nt <= 2 ? 2 : nt <= 4 ? 4 : nt <= 8 ? 8 : 16;
}

// Dynamic shared memory of a partials CTA: the ring of sub-tiles of x
// and their masks, and the warps' accumulators of one mask block (in
// the ring unless x is walked more than once).
long smem_bytes(int itemsize, int M, int rows) {
  const int nt = nt_for(M);
  const int stride = SUB_PX * itemsize +
                     (itemsize == 1 ? 32 : itemsize == 2 ? 64 : 16);
  const int mrows = ((M < nt * 8 ? M : nt * 8) + 7) / 8 * 8;
  const long ring =
      (long)ring_stages(itemsize, nt) * ((long)rows * stride +
                                         (long)mrows * MSTRIDE);
  const long red = (long)WARPS * rows * mrows * 4;
  return M > nt * 8 ? ring + red : (ring > red ? ring : red);
}

template <typename T, int NT, int STAGE, bool ONE_PASS>
cudaError_t launch_partials(const void* x, const float* masks, int D, int P,
                            int M, int rows, int chunk, int valid,
                            int compute_var, float* ypart, float* psum,
                            float* pshift, float* pm1, float* pm2,
                            cudaStream_t stream) {
  auto kernel = moments_partials<T, NT, STAGE, ONE_PASS>;
  const long smem = smem_bytes(sizeof(T), M, rows);
  // the opt-in to more than 48 KB is the current card's: asked each call
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int vec_ok =
      (long)P * sizeof(T) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int mask_vec =
      P % 4 == 0 && reinterpret_cast<uintptr_t>(masks) % 16 == 0;
  const dim3 grid((P + chunk - 1) / chunk, (D + rows - 1) / rows);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), masks, D, P, M, rows, chunk, valid, vec_ok,
      mask_vec, compute_var, ypart, psum, pshift, pm1, pm2);
  return cudaGetLastError();
}

// One partials launch for any M: the instantiation whose accumulators
// hold M's n-tiles (M > 128: 16 n-tiles a walk over x).  ONE_PASS: x_hi
// m_hi alone, else the passes the data needs (up to three).
template <typename T, int STAGE = STAGE_FULL, bool ONE_PASS = false>
cudaError_t launch_any(const void* x, const float* masks, int D, int P,
                       int M, int rows, int chunk, int valid,
                       int compute_var, float* ypart, float* psum,
                       float* pshift, float* pm1, float* pm2,
                       cudaStream_t s) {
#define FM_NT(N)                                                          \
  case N:                                                                 \
    return launch_partials<T, N, STAGE, ONE_PASS>(                        \
        x, masks, D, P, M, rows, chunk, valid, compute_var, ypart, psum,  \
        pshift, pm1, pm2, s);
  switch (nt_for(M)) {
    FM_NT(1)
    FM_NT(2)
    FM_NT(4)
    FM_NT(8)
    default:
      return launch_partials<T, 16, STAGE, ONE_PASS>(
          x, masks, D, P, M, rows, chunk, valid, compute_var, ypart, psum,
          pshift, pm1, pm2, s);
  }
#undef FM_NT
}

// One combine launch over every pixel (colsum, colvar) and, for
// M > 0, every y[d, m].
int combine(const float* ypart, const float* psum, const float* pshift,
            const float* pm1, const float* pm2, int D, int P, int M,
            int rows, int n_pc, int n_rc, int valid, int compute_var,
            float* y, float* colsum, float* colvar, cudaStream_t s) {
  const long threads = ((long)P + (long)D * M) * LANES;
  const int blocks =
      static_cast<int>((threads + COMBINE_THREADS - 1) / COMBINE_THREADS);
  // programmatic dependent launch: the combine's launch overlaps the
  // partials kernel's last steps, and it waits for that grid's results
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(COMBINE_THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, moments_combine, ypart, psum, pshift, pm1, pm2, D, P, M, rows,
      n_pc, n_rc, valid, compute_var, y, colsum, colvar);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The scratch of one call: the y partials of every pixel chunk
// ((n_pc, D, M)), padded to 256 bytes; then sum, shift, mean and m2 of
// every row chunk of every pixel.
struct Scratch {
  float *ypart, *psum, *pshift, *pm1, *pm2;
  int n_pc, n_rc;
};

long ypart_floats(int D, int P, int M, int chunk) {
  const long n_pc = (P + chunk - 1) / chunk;
  return (n_pc * D * M + 63) / 64 * 64;
}

Scratch split_scratch(float* scratch, int D, int P, int M, int rows,
                      int chunk) {
  Scratch c;
  c.n_pc = (P + chunk - 1) / chunk;
  c.n_rc = (D + rows - 1) / rows;
  c.ypart = scratch;
  c.psum = scratch + ypart_floats(D, P, M, chunk);
  c.pshift = c.psum + (size_t)c.n_rc * P;
  c.pm1 = c.pshift + (size_t)c.n_rc * P;
  c.pm2 = c.pm1 + (size_t)c.n_rc * P;
  return c;
}

// rows: a multiple of 16 up to the accumulators' room for M (64 up to
// 32 masks, 32 up to 64, 16 beyond); chunk: a multiple of 128 pixels
bool geometry_ok(int itemsize, int D, int P, int M, int rows, int chunk) {
  return D > 0 && P > 0 && M > 0 && rows > 0 &&
         rows <= TILE_ROWS * row_tiles_for(nt_for(M)) &&
         rows % TILE_ROWS == 0 && chunk > 0 && chunk <= MAX_CHUNK_PX &&
         chunk % SUB_PX == 0 && smem_bytes(itemsize, M, rows) <= SMEM_LIMIT;
}

// One production call on input of type T (`fused_moments_launch` of
// the entry points): the partials launch, then the combine.  Returns a
// cudaError_t, or -1 for an unsupported mask count, geometry or pass
// count.
template <typename T>
int launch_call(const void* x, const float* masks, int D, int P, int M,
                int rows, int chunk, int valid, int compute_var,
                int passes, float* scratch, float* y, float* colsum,
                float* colvar, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((passes != 1 && passes != 3) ||
      !geometry_ok(sizeof(T), D, P, M, rows, chunk))
    return -1;
  const Scratch c = split_scratch(scratch, D, P, M, rows, chunk);
  const cudaError_t err =
      passes == 1
          ? launch_any<T, STAGE_FULL, true>(x, masks, D, P, M, rows, chunk,
                                            valid, compute_var, c.ypart,
                                            c.psum, c.pshift, c.pm1, c.pm2,
                                            s)
          : launch_any<T>(x, masks, D, P, M, rows, chunk, valid,
                          compute_var, c.ypart, c.psum, c.pshift, c.pm1,
                          c.pm2, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return combine(c.ypart, c.psum, c.pshift, c.pm1, c.pm2, D, P, M, rows,
                 c.n_pc, c.n_rc, valid, compute_var, y, colsum, colvar, s);
}

}  // namespace

extern "C" {

// Floats of scratch a call needs with `rows` rows and `chunk` pixels a
// CTA.
long fused_moments_scratch_floats(int D, int P, int M, int rows, int chunk) {
  return ypart_floats(D, P, M, chunk) + 4L * ((D + rows - 1) / rows) * P;
}

// Bytes of dynamic shared memory a partials CTA asks for.
long fused_moments_smem_bytes(int itemsize, int M, int rows) {
  return smem_bytes(itemsize, M, rows);
}

const char* fused_moments_error_string(int code) {
  if (code == -1)
    return "unsupported dtype, mask count, geometry, stage or pass count";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
