"""Stage profiler and kernel experiments of dprast_torch on one CUDA
card (the counterparts of the JAX package's `benchmarks/`)."""
