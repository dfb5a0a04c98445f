// The production entry point of the fused-moments kernel for the 1-
// and 2-byte input types (see fused_moments.cuh: the design, its bound
// and what it replaces); fused_moments_wide.cu holds the 4- and 8-byte
// ones, so that nvcc builds the two halves at once.

#include "fused_moments.cuh"

extern "C" {

// dtype codes: 0 u8, 1 i8, 2 u16, 3 i16, 10 f16, 11 bf16 here (4 i32,
// 5 u32, 6 f32, 7 f64, 8 i64, 9 u64 in fused_moments_wide.cu).
// `rows`, `chunk`: the rows and pixels a partials CTA covers (the
// caller's grid plan).  `passes`: 3, the TF32 passes the data needs
// (up to three), or 1, x_hi m_hi alone.  Returns a cudaError_t, or -1
// for another dtype, an unsupported mask count, geometry or pass count.
int fused_moments_launch(int dtype, const void* x, const float* masks,
                         int D, int P, int M, int rows, int chunk,
                         int valid, int compute_var, int passes,
                         float* scratch, float* y, float* colsum,
                         float* colvar, void* stream) {
#define FM_CASE(code, T)                                                 \
  case code:                                                             \
    return launch_call<T>(x, masks, D, P, M, rows, chunk, valid,         \
                          compute_var, passes, scratch, y, colsum,       \
                          colvar, stream);
  switch (dtype) {
    FM_CASE(0, uint8_t)
    FM_CASE(1, int8_t)
    FM_CASE(2, uint16_t)
    FM_CASE(3, int16_t)
    FM_CASE(10, __half)
    FM_CASE(11, __nv_bfloat16)
    default:
      return -1;
  }
#undef FM_CASE
}

}  // extern "C"
