"""The harness of dprast_torch on one CUDA card: the stage profiler and
B4's two layout experiments (`profile_binned`, `exp_xsel`, `exp_band`,
the counterparts of the JAX package's `benchmarks/`), the reference's
rows (`run`), and two scripts that hold code on the main path to the
card: `exp_b1_cluster` (B1's cluster-size rule) and `exp_span_cost`
(what a stage span costs)."""
