// The production entry point of the fused-moments kernel for the 4-
// and 8-byte input types (see fused_moments.cuh: the design, its bound
// and what it replaces); fused_moments.cu holds the 1- and 2-byte ones,
// so that nvcc builds the two halves at once.

#include "fused_moments.cuh"

extern "C" {

// dtype codes: 4 i32, 5 u32, 6 f32, 7 f64, 8 i64, 9 u64 here; the
// arguments and the result as fused_moments.cu's fused_moments_launch.
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
    FM_CASE(4, int32_t)
    FM_CASE(5, uint32_t)
    FM_CASE(6, float)
    FM_CASE(7, double)
    FM_CASE(8, int64_t)
    FM_CASE(9, uint64_t)
    default:
      return -1;
  }
#undef FM_CASE
}

}  // extern "C"
