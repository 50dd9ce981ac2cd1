"""Hand-written CUDA kernels (csrc/), their bindings, plain versions and
the public wrappers (ops)."""
