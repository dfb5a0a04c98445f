// Fused moments + mask projection for one (D, P) block of frames.
//
// Replaces the TPU kernel `_fused_moments_pallas`
// (libertem_tpu/ops/moments.py:135).  One read of x gives
//   y[d, m]   = sum_p x[d, p] * masks[m, p]            (D, M)
//   colsum[p] = sum_d x[d, p]                          (P)
//   colvar[p] = sum_{d < valid} (x[d, p] - mean[p])^2  (P)
// with x of any of u8/i8/u16/i16/i32/u32/f32/f16/bf16/f64/i64/u64, cast
// to f32 in registers, and fp32 FMA on the CUDA cores (a mask group of
// at most 8 rows is far too thin for tensor cores, and TF32 would
// break the 1e-5 contract of the JAX package).
//
// Bound on the H100: memory.  The work is 2*D*P*M + ~5*D*P FLOPs,
// 17 FLOPs per pixel at M = 6: 8.5 FLOPs per byte of u16 input and
// 4.25 of f32, below the card's fp32 balance of 67 TFLOP/s over
// 3.35 TB/s = 20 FLOPs per byte (u8, at 17, comes close to it).  The
// least time is the bytes of x over 3.35 TB/s.  What the design does
// about it:
//   * x is read once, at its raw width, 8 pixels a thread with
//     neighbouring threads on neighbouring addresses, through a
//     per-CTA ring in shared memory that cp.async fills 12 to 28 rows
//     ahead of use (4 for 4-byte types), so the loads stay in flight
//     while the CTA computes;
//   * the mask values of a thread's pixels stay in registers for the
//     whole CTA;
//   * the cross-lane sum of y (4 rows x M values a thread) halves the
//     value count at each shuffle step instead of shuffling every
//     value 5 times;
//   * only small partials go back to memory.
// Types of 8 bytes (f64, i64, u64) take element loads instead of the
// ring: they are rare input (64-bit files), and the ring would hold
// only one row group of them.
//
// Any mask count M: the partials kernel holds at most MASK_GROUP = 8
// mask rows in registers, so M > 8 runs it once per group of 8 rows,
// each launch reading x again.  The first group also takes the column
// moments; later groups skip them (`moments` = 0) and write only their
// projections.  One combine launch serves all groups.  M = 40 reads x
// five times: a tensor-core design for large stacks is later work.
//
// The TPU kernel carries colsum/colvar across a sequential grid.  Here
// CTAs run in no order, so the work is two launches:
//   1. `moments_partials`, a 2-D grid of (pixel chunks x row chunks),
//      once per mask group.
//      Each CTA covers `rows` rows x CHUNK_PX pixels, `rows` a multiple
//      of 4 up to MAX_ROWS from the caller's grid plan (ops/moments.py
//      `plan_grid`: fewer rows a CTA on a block too narrow to fill the
//      card's SMs with CTAs).  Per pixel it keeps
//      the row chunk's sum and the sums of (x - c) and (x - c)^2 with
//      c = the chunk's first row (a shifted two-moment form: exact 0
//      for constant data, stable for a large mean with a narrow
//      spread, and one read of x).  Rows >= valid enter no variance
//      term.  Per row it reduces the M projections across the CTA
//      (warp shuffles, then the warps in a fixed order) into the
//      group's (n_pixel_chunks, D, Mg) partial, Mg its row count.
//   2. `moments_combine` folds the row-chunk partials of each pixel
//      with the Chan/Golub/LeVeque update and sums the pixel-chunk
//      partials of y, 8 lanes per output, each over every 8th chunk,
//      then a shuffle tree in a fixed order.  The chunk means enter
//      the update relative to chunk 0's shift, (c_j - c_0) +
//      mean_j(x - c_j): small numbers whose differences keep their
//      digits when the data's mean is large against its spread.
// No float atomics anywhere: two runs give identical bits.
//
// Why two launches.  Folding the combine into the partials kernel (the
// CTA that draws the last ticket of a chunk combines that chunk) was
// built and measured on the H100: one CTA then reads a pixel chunk's
// partials of every row chunk (256 KiB at the main path's block) from
// L2 alone while the rest of the card idles, and the kernel took
// 0.042 ms against 0.0265 ms with the combine launch, which spreads
// the same reads over every SM.
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
//   load      + the raw widen: an integer colsum per chunk (float
//             input: the f32 colsum)
//   cast      + to_float and the f32 colsum of the production code
//   dot       + the M-column fp32 FMA projections and their
//             shuffle/shared reduction into y
//   var       + the shifted moments with row masking: the production
//             partials kernel
//   full      + moments_combine: fused_moments itself
// The JAX stages `dec` and `dot2` (the bf16 two-term split and the
// second MXU pass) have no counterpart: the port's product is one
// fp32 FMA pass.  Each launch also runs the combine (stages below dot
// with M = 0, below var with the variance off) unless told to skip it,
// so every stage's outputs can be held against a plain version; the
// ablation takes u8, u16 and f32 input.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int PX = 8;                    // pixels per thread
constexpr int THREADS = 128;             // threads per CTA
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK_PX = PX * THREADS;   // pixels per CTA
constexpr int MAX_ROWS = 64;             // rows per CTA, at most
constexpr int GROUP = 4;                 // rows reduced together
constexpr int RING_BYTES = 32 * 1024;    // cp.async ring per CTA
constexpr int COMBINE_THREADS = 256;
constexpr int LANES = 8;                 // combine lanes per output
constexpr int MASK_GROUP = 8;            // mask rows per partials launch

// stages of the partials kernel (see the header); `var` launches the
// STAGE_FULL partials and skips the combine
constexpr int STAGE_LOAD_MIN = 0;
constexpr int STAGE_LOAD = 1;
constexpr int STAGE_CAST = 2;
constexpr int STAGE_DOT = 3;
constexpr int STAGE_VAR = 4;
constexpr int STAGE_FULL = 5;

// 8 raw elements: one thread's pixels of one row
template <typename T>
struct alignas(sizeof(T) * PX) Raw8 {
  T v[PX];
};

// types up to 4 bytes stream through the cp.async ring; 8-byte types
// take element loads and get a one-row placeholder ring
template <typename T>
constexpr bool kRing = sizeof(T) <= 4;

// rows the ring holds: 32 (1-byte types), 16 (2-byte), 8 (4-byte)
template <typename T>
constexpr int kRingRows =
    kRing<T> ? RING_BYTES / (CHUNK_PX * static_cast<int>(sizeof(T))) : 1;

template <typename T>
__device__ __forceinline__ float to_float(T v) {
  return static_cast<float>(v);
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

// 8 elements folded into one word: the lower stages
// fold rows they do not otherwise use into a sink, so that element
// loads (the ragged edge) are not dropped as dead code
template <typename T>
__device__ __forceinline__ unsigned fold_bits(const Raw8<T>& r) {
  unsigned b = 0;
#pragma unroll
  for (int i = 0; i < PX; ++i) b ^= __float_as_uint(to_float(r.v[i]));
  return b;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <typename T>
__device__ __forceinline__ void copy_async(Raw8<T>* dst, const T* src) {
  if constexpr (sizeof(T) == 1) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  } else {
#pragma unroll
    for (int k = 0; k < static_cast<int>(sizeof(T)) / 2; ++k)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(reinterpret_cast<char*>(dst) + 16 * k)),
                   "l"(reinterpret_cast<const char*>(src) + 16 * k)
                   : "memory");
  }
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ragged edge or unaligned rows: element loads, zero past `n`
template <typename T>
__device__ __forceinline__ Raw8<T> load_part(const T* p, int n) {
  Raw8<T> r;
#pragma unroll
  for (int i = 0; i < PX; ++i) r.v[i] = i < n ? p[i] : zero_of<T>();
  return r;
}

// Sum N values over the 32 lanes of a warp and store them at out[0, N).
// While N is even, each step keeps half the values (the lower half on
// lanes with the step's bit clear, the upper half on the others) and
// adds the partner's copy of them: N/2 shuffles instead of N.  Odd
// counts finish with plain butterflies.  Lanes whose plain-step bits
// (DUP) are clear store.
template <int N, int OFF, int DUP>
struct WarpSum {
  __device__ __forceinline__ static void run(const float (&v)[N], int lane,
                                             int idx, float* out) {
    if constexpr (OFF == 0) {
      if ((lane & DUP) == 0) {
#pragma unroll
        for (int i = 0; i < N; ++i) out[idx + i] = v[i];
      }
    } else if constexpr (N % 2 == 0) {
      constexpr int H = N / 2;
      const bool upper = lane & OFF;
      float w[H];
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = upper ? v[i] : v[i + H];
        const float keep = upper ? v[i + H] : v[i];
        w[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      WarpSum<H, OFF / 2, DUP>::run(w, lane, idx + (upper ? H : 0), out);
    } else {
      float w[N];
#pragma unroll
      for (int i = 0; i < N; ++i)
        w[i] = v[i] + __shfl_xor_sync(0xffffffffu, v[i], OFF);
      WarpSum<N, OFF / 2, DUP | OFF>::run(w, lane, idx, out);
    }
  }
};

template <typename T, int MB, int STAGE = STAGE_FULL>
__global__ void __launch_bounds__(THREADS)
moments_partials(const T* __restrict__ x, const float* __restrict__ masks,
                 int D, int P, int M, int chunk_rows, int valid,
                 int vec_ok,
                 int compute_var, int moments, float* __restrict__ ypart,
                 float* __restrict__ psum, float* __restrict__ pshift,
                 float* __restrict__ pm1, float* __restrict__ pm2) {
  constexpr bool kDot = STAGE >= STAGE_DOT;
  constexpr bool kVar = STAGE >= STAGE_VAR;
  constexpr int RR = kRingRows<T>;
  __shared__ Raw8<T> ring[RR][THREADS];
  __shared__ float red[WARPS][kDot ? MAX_ROWS : 1][MB];
  const int pc = blockIdx.x;
  const int rc = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = pc * CHUNK_PX + tid * PX;
  const int r0 = rc * chunk_rows;
  const int rows = min(chunk_rows, D - r0);
  const int nvar =
      kVar && compute_var && moments ? max(0, min(rows, valid - r0)) : 0;
  const int npx = max(0, min(PX, P - p0));
  // aligned rows and a whole chunk: the cp.async ring (CTA-uniform)
  const bool fast = kRing<T> && vec_ok && (pc + 1) * CHUNK_PX <= P;

  float mk[MB][PX];
  if constexpr (kDot) {
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int i = 0; i < PX; ++i)
        mk[m][i] =
            (m < M && i < npx) ? masks[(size_t)m * P + p0 + i] : 0.f;
  }

  float s[PX], c[PX], s1[PX], s2[PX];
#pragma unroll
  for (int i = 0; i < PX; ++i) s[i] = c[i] = s1[i] = s2[i] = 0.f;
  Widen<T> ws[PX];  // the load stage's colsum
#pragma unroll
  for (int i = 0; i < PX; ++i) ws[i] = 0;
  unsigned sink = 0;

  // The ring holds RG groups of GROUP rows.  Group q is copied RG - 1
  // groups ahead of use, one commit group per row group, into the
  // slots of group q - 1: those were read in the previous iteration,
  // whose shuffles and shared stores depend on them, so the reads are
  // done before the copy is issued.
  constexpr int RG = RR / GROUP;
  const T* xcol = x + (size_t)r0 * P + p0;
  if constexpr (kRing<T>) {
    if (fast) {
#pragma unroll
      for (int q = 0; q < RG - 1; ++q) {
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
          const int row = q * GROUP + u;
          if (row < rows)
            copy_async(&ring[row % RR][tid], xcol + (size_t)row * P);
        }
        commit_async();
      }
    }
  }
  for (int r = 0; r < rows; r += GROUP) {
    float xg[GROUP][PX];
    if constexpr (kRing<T>) {
      if (fast) {
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
          const int row = r + (RG - 1) * GROUP + u;
          if (row < rows)
            copy_async(&ring[row % RR][tid], xcol + (size_t)row * P);
        }
        commit_async();
        wait_async<RG - 1>();  // the group of rows r .. r + GROUP - 1
      }
    }
    if constexpr (STAGE < STAGE_CAST) {
      // element loads of the group's rows first, all in flight at
      // once as in the production loop below
      Raw8<T> raw[GROUP];
      if (!fast) {
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
          const int row = r + u;
          raw[u] = load_part(xcol + (size_t)row * P, row < rows ? npx : 0);
        }
      }
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        const int row = r + u;
        // load_min reads the chunk's first and last rows
        const bool used =
            moments && row < rows &&
            (STAGE == STAGE_LOAD || row == 0 || row == rows - 1);
        if (used) {
          if (fast) raw[u] = ring[row % RR][tid];
#pragma unroll
          for (int i = 0; i < PX; ++i) {
            if constexpr (STAGE == STAGE_LOAD)
              ws[i] += widen(raw[u].v[i]);
            else
              s[i] += to_float(raw[u].v[i]);
          }
        } else if (!fast) {
          sink ^= fold_bits(raw[u]);
        }
      }
      continue;
    }
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const int row = r + u;
      const Raw8<T> raw =
          fast ? ring[row % RR][tid]
               : load_part(xcol + (size_t)row * P, row < rows ? npx : 0);
      if constexpr (!kDot) {
        if (!moments && !fast) sink ^= fold_bits(raw);
      }
#pragma unroll
      for (int i = 0; i < PX; ++i)
        xg[u][i] = row < rows ? to_float(raw.v[i]) : 0.f;
    }
    if (r == 0) {
#pragma unroll
      for (int i = 0; i < PX; ++i) c[i] = xg[0][i];
    }
    float acc[GROUP * MB];
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
#pragma unroll
      for (int m = 0; m < MB; ++m) acc[u * MB + m] = 0.f;
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        if (moments) s[i] += xg[u][i];
        if constexpr (kDot) {
#pragma unroll
          for (int m = 0; m < MB; ++m)
            acc[u * MB + m] = fmaf(xg[u][i], mk[m][i], acc[u * MB + m]);
        }
      }
      if (r + u < nvar) {
#pragma unroll
        for (int i = 0; i < PX; ++i) {
          const float d = xg[u][i] - c[i];
          s1[i] += d;
          s2[i] = fmaf(d, d, s2[i]);
        }
      }
    }
    // red[warp][r + u][m] for the group's rows (rows past `rows`
    // store zeros that are never read)
    if constexpr (kDot)
      WarpSum<GROUP * MB, 16, 0>::run(acc, lane, 0, &red[warp][r][0]);
  }
  if constexpr (kDot) {
    __syncthreads();
    for (int t = tid; t < rows * M; t += THREADS) {
      const int rr = t / M;
      const int m = t - rr * M;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) v += red[w][rr][m];
      ypart[((size_t)pc * D + r0 + rr) * M + m] = v;
    }
  } else {
    // never true (the launch refuses valid < 0): keeps the sink's
    // loads alive
    if (valid < 0) ypart[0] = __uint_as_float(sink);
  }
  if (!moments) return;
  if constexpr (STAGE == STAGE_LOAD) {
#pragma unroll
    for (int i = 0; i < PX; ++i) s[i] = static_cast<float>(ws[i]);
  }
  const size_t base = (size_t)rc * P + p0;
  const float n = static_cast<float>(max(nvar, 1));
  float m1[PX], m2[PX];
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    m1[i] = s1[i] / n;
    m2[i] = fmaxf(0.f, s2[i] - s1[i] * m1[i]);
  }
  if (fast) {
    float4* q = reinterpret_cast<float4*>(psum + base);
    q[0] = make_float4(s[0], s[1], s[2], s[3]);
    q[1] = make_float4(s[4], s[5], s[6], s[7]);
    if (kVar && compute_var) {
      q = reinterpret_cast<float4*>(pshift + base);
      q[0] = make_float4(c[0], c[1], c[2], c[3]);
      q[1] = make_float4(c[4], c[5], c[6], c[7]);
      q = reinterpret_cast<float4*>(pm1 + base);
      q[0] = make_float4(m1[0], m1[1], m1[2], m1[3]);
      q[1] = make_float4(m1[4], m1[5], m1[6], m1[7]);
      q = reinterpret_cast<float4*>(pm2 + base);
      q[0] = make_float4(m2[0], m2[1], m2[2], m2[3]);
      q[1] = make_float4(m2[4], m2[5], m2[6], m2[7]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      if (i >= npx) break;
      psum[base + i] = s[i];
      if (kVar && compute_var) {
        pshift[base + i] = c[i];
        pm1[base + i] = m1[i];
        pm2[base + i] = m2[i];
      }
    }
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
  // y[d, m] of mask group mg = m / MASK_GROUP: that group's partials
  // lie after those of the full groups before it, (n_pc, D, Mg) each
  const long k = item - P;
  if (k < (long)D * M) {
    const int d = static_cast<int>(k / M);
    const int m = static_cast<int>(k - (long)d * M);
    const int mg = m / MASK_GROUP;
    const int width = min(MASK_GROUP, M - mg * MASK_GROUP);
    const float* yp = ypart + (size_t)mg * MASK_GROUP * n_pc * D +
                      (size_t)d * width + (m - mg * MASK_GROUP);
    float v = 0.f;
    for (int j = g; j < n_pc; j += LANES) v += yp[(size_t)j * D * width];
#pragma unroll
    for (int off = 1; off < LANES; off <<= 1)
      v += __shfl_xor_sync(gmask, v, off);
    if (g == 0) y[k] = v;
  }
}

template <typename T, int MB, int STAGE>
void launch_partials(const void* x, const float* masks, int D, int P,
                     int M, int rows, int valid, int compute_var, int moments,
                     float* ypart,
                     float* psum, float* pshift, float* pm1, float* pm2,
                     cudaStream_t stream) {
  const int vec_ok =
      P % PX == 0 &&
      reinterpret_cast<uintptr_t>(x) % (sizeof(T) * PX) == 0;
  const dim3 grid((P + CHUNK_PX - 1) / CHUNK_PX, (D + rows - 1) / rows);
  moments_partials<T, MB, STAGE><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), masks, D, P, M, rows, valid, vec_ok,
      compute_var, moments, ypart, psum, pshift, pm1, pm2);
}

// One partials launch per group of at most MASK_GROUP mask rows; the
// first group also takes the column moments.  Returns cudaGetLastError
// of the first launch that fails, else cudaSuccess.
template <typename T, int STAGE = STAGE_FULL>
cudaError_t launch_groups(const void* x, const float* masks, int D, int P,
                          int M, int rows, int valid, int compute_var,
                          float* ypart,
                          float* psum, float* pshift, float* pm1,
                          float* pm2, cudaStream_t s) {
  const int n_pc = (P + CHUNK_PX - 1) / CHUNK_PX;
  for (int m0 = 0; m0 < M; m0 += MASK_GROUP) {
    const int mg = min(MASK_GROUP, M - m0);
    const float* mk = masks + (size_t)m0 * P;
    float* yp = ypart + (size_t)m0 * n_pc * D;
    const int first = m0 == 0;
    // the group's width rounds up to the next instantiated one; the
    // extra mask rows are zeros in registers and never written out
    if (mg <= 2)
      launch_partials<T, 2, STAGE>(x, mk, D, P, mg, rows, valid,
                                   compute_var,
                                   first, yp, psum, pshift, pm1, pm2, s);
    else if (mg <= 4)
      launch_partials<T, 4, STAGE>(x, mk, D, P, mg, rows, valid,
                                   compute_var,
                                   first, yp, psum, pshift, pm1, pm2, s);
    else if (mg <= 6)
      launch_partials<T, 6, STAGE>(x, mk, D, P, mg, rows, valid,
                                   compute_var,
                                   first, yp, psum, pshift, pm1, pm2, s);
    else
      launch_partials<T, 8, STAGE>(x, mk, D, P, mg, rows, valid,
                                   compute_var,
                                   first, yp, psum, pshift, pm1, pm2, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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
  moments_combine<<<blocks, COMBINE_THREADS, 0, s>>>(
      ypart, psum, pshift, pm1, pm2, D, P, M, rows, n_pc, n_rc, valid,
      compute_var, y, colsum, colvar);
  return static_cast<int>(cudaGetLastError());
}

// The scratch of one call: the y partials of every pixel chunk, group
// after group ((n_pc, D, Mg) each, so M floats per pixel chunk and row
// in all), padded to 256 bytes so that the row-chunk partials after
// them take float4 stores; then sum, shift, mean and m2 of every row
// chunk of every pixel.
struct Scratch {
  float *ypart, *psum, *pshift, *pm1, *pm2;
  int n_pc, n_rc;
};

long ypart_floats(int D, int P, int M) {
  const long n_pc = (P + CHUNK_PX - 1) / CHUNK_PX;
  return (n_pc * D * M + 63) / 64 * 64;
}

Scratch split(float* scratch, int D, int P, int M, int rows) {
  Scratch c;
  c.n_pc = (P + CHUNK_PX - 1) / CHUNK_PX;
  c.n_rc = (D + rows - 1) / rows;
  c.ypart = scratch;
  c.psum = scratch + ypart_floats(D, P, M);
  c.pshift = c.psum + (size_t)c.n_rc * P;
  c.pm1 = c.pshift + (size_t)c.n_rc * P;
  c.pm2 = c.pm1 + (size_t)c.n_rc * P;
  return c;
}

bool geometry_ok(int D, int P, int M, int rows) {
  return D > 0 && P > 0 && M > 0 && rows > 0 && rows <= MAX_ROWS &&
         rows % GROUP == 0;
}

}  // namespace

extern "C" {

// Floats of scratch a call needs with `rows` rows a CTA.
long fused_moments_scratch_floats(int D, int P, int M, int rows) {
  return ypart_floats(D, P, M) + 4L * ((D + rows - 1) / rows) * P;
}

// dtype codes: 0 u8, 1 i8, 2 u16, 3 i16, 4 i32, 5 u32, 6 f32, 7 f64,
// 8 i64, 9 u64, 10 f16, 11 bf16.  `rows`: rows a partials CTA covers
// (the caller's grid plan), a multiple of 4 up to 64.
// Returns a cudaError_t, or -1 for an unsupported dtype, mask count or
// geometry.
int fused_moments_launch(int dtype, const void* x, const float* masks,
                         int D, int P, int M, int rows, int valid,
                         int compute_var, float* scratch, float* y,
                         float* colsum, float* colvar, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!geometry_ok(D, P, M, rows)) return -1;
  const Scratch c = split(scratch, D, P, M, rows);
  cudaError_t err = cudaSuccess;
#define FM_CASE(code, T)                                                   \
  case code:                                                               \
    err = launch_groups<T>(x, masks, D, P, M, rows, valid, compute_var,    \
                           c.ypart, c.psum, c.pshift, c.pm1, c.pm2, s);    \
    break;
  switch (dtype) {
    FM_CASE(0, uint8_t)
    FM_CASE(1, int8_t)
    FM_CASE(2, uint16_t)
    FM_CASE(3, int16_t)
    FM_CASE(4, int32_t)
    FM_CASE(5, uint32_t)
    FM_CASE(6, float)
    FM_CASE(7, double)
    FM_CASE(8, int64_t)
    FM_CASE(9, uint64_t)
    FM_CASE(10, __half)
    FM_CASE(11, __nv_bfloat16)
    default:
      return -1;
  }
#undef FM_CASE
  if (err != cudaSuccess) return static_cast<int>(err);
  return combine(c.ypart, c.psum, c.pshift, c.pm1, c.pm2, D, P, M, rows,
                 c.n_pc, c.n_rc, valid, compute_var, y, colsum, colvar, s);
}

// The stage ablation: `stage` 0 load_min, 1 load, 2 cast, 3 dot,
// 4 var, 5 full (see the header), then the combine unless
// `skip_combine`; the other arguments as fused_moments_launch.  Stages
// below dot leave y as it is (the caller zeroes it), stages below var
// give a zero colvar; var and full are the production launch.  Takes
// u8, u16 and f32 input; returns a cudaError_t, or -1 for another
// dtype, stage, mask count or geometry.
int fused_moments_ablation_launch(int stage, int skip_combine, int dtype,
                                  const void* x, const float* masks, int D,
                                  int P, int M, int rows, int valid,
                                  int compute_var, float* scratch, float* y,
                                  float* colsum, float* colvar,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!geometry_ok(D, P, M, rows) || stage < STAGE_LOAD_MIN ||
      stage > STAGE_FULL)
    return -1;
  const Scratch c = split(scratch, D, P, M, rows);
  cudaError_t err = cudaSuccess;
#define FM_LAUNCH(T, STG)                                                   \
  err = launch_groups<T, STG>(x, masks, D, P, M, rows, valid, compute_var, \
                              c.ypart, c.psum, c.pshift, c.pm1, c.pm2, s)
#define FM_STAGE(code, T)             \
  case code:                          \
    switch (stage) {                  \
      case STAGE_LOAD_MIN:            \
        FM_LAUNCH(T, STAGE_LOAD_MIN); \
        break;                        \
      case STAGE_LOAD:                \
        FM_LAUNCH(T, STAGE_LOAD);     \
        break;                        \
      case STAGE_CAST:                \
        FM_LAUNCH(T, STAGE_CAST);     \
        break;                        \
      case STAGE_DOT:                 \
        FM_LAUNCH(T, STAGE_DOT);      \
        break;                        \
      default:                        \
        FM_LAUNCH(T, STAGE_FULL);     \
    }                                 \
    break;
  switch (dtype) {
    FM_STAGE(0, uint8_t)
    FM_STAGE(2, uint16_t)
    FM_STAGE(6, float)
    default:
      return -1;
  }
#undef FM_STAGE
#undef FM_LAUNCH
  if (err != cudaSuccess) return static_cast<int>(err);
  if (skip_combine) return static_cast<int>(cudaSuccess);
  return combine(c.ypart, c.psum, c.pshift, c.pm1, c.pm2, D, P,
                 stage >= STAGE_DOT ? M : 0, rows, c.n_pc, c.n_rc, valid,
                 stage >= STAGE_VAR ? compute_var : 0, y, colsum, colvar, s);
}

const char* fused_moments_error_string(int code) {
  if (code == -1) return "unsupported dtype, mask count, geometry or stage";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
