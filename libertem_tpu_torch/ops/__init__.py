"""Device ops and the build of their CUDA kernels."""
