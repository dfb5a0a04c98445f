// The stage ablation of the fused-moments kernel: the compile-time
// stages of `moments_partials` (see fused_moments.cuh), built apart from
// the production entry points so that nvcc compiles both at once.
// Replaces the TPU kernel `ablated` (benchmarks/bench_kernel_ablation.py:48).

#include "fused_moments.cuh"

extern "C" {

// The stage ablation: `stage` 0 load_min, 1 load, 2 cast, 3 dot,
// 4 var, 5 full (see the header), then the combine unless
// `skip_combine`; the other arguments as fused_moments_launch.  Stages
// below dot leave y as it is (the caller zeroes it), stages below var
// give a zero colvar; var and full are the production launch, with the
// passes the data needs (the precision "highest").  Takes
// u8, u16 and f32 input; returns a cudaError_t, or -1 for another
// dtype, stage, mask count or geometry.
int fused_moments_ablation_launch(int stage, int skip_combine, int dtype,
                                  const void* x, const float* masks, int D,
                                  int P, int M, int rows, int chunk,
                                  int valid, int compute_var,
                                  float* scratch, float* y, float* colsum,
                                  float* colvar, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int itemsize = dtype == 0 ? 1 : dtype == 2 ? 2 : 4;
  if (!geometry_ok(itemsize, D, P, M, rows, chunk) ||
      stage < STAGE_LOAD_MIN || stage > STAGE_FULL)
    return -1;
  const Scratch c = split_scratch(scratch, D, P, M, rows, chunk);
  cudaError_t err = cudaSuccess;
#define FM_LAUNCH(T, STG)                                                \
  err = launch_any<T, STG>(x, masks, D, P, M, rows, chunk, valid,        \
                           compute_var, c.ypart, c.psum, c.pshift,       \
                           c.pm1, c.pm2, s)
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

}  // extern "C"
