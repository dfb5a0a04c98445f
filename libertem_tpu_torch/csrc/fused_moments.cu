// The production entry points of the fused-moments kernel (see
// fused_moments.cuh: the design, its bound and what it replaces).

#include "fused_moments.cuh"

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

// dtype codes: 0 u8, 1 i8, 2 u16, 3 i16, 4 i32, 5 u32, 6 f32, 7 f64,
// 8 i64, 9 u64, 10 f16, 11 bf16.  `rows`, `chunk`: the rows and pixels
// a partials CTA covers (the caller's grid plan).
// Returns a cudaError_t, or -1 for an unsupported dtype, mask count or
// geometry.
int fused_moments_launch(int dtype, const void* x, const float* masks,
                         int D, int P, int M, int rows, int chunk,
                         int valid, int compute_var, float* scratch,
                         float* y, float* colsum, float* colvar,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static const int itemsize[] = {1, 1, 2, 2, 4, 4, 4, 8, 8, 8, 2, 2};
  if (dtype < 0 || dtype > 11 ||
      !geometry_ok(itemsize[dtype], D, P, M, rows, chunk))
    return -1;
  const Scratch c = split_scratch(scratch, D, P, M, rows, chunk);
  cudaError_t err = cudaSuccess;
#define FM_CASE(code, T)                                                 \
  case code:                                                             \
    err = launch_any<T>(x, masks, D, P, M, rows, chunk, valid,           \
                        compute_var, c.ypart, c.psum, c.pshift, c.pm1,   \
                        c.pm2, s);                                       \
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

}  // extern "C"
