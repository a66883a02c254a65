"""Benchmarks of the port (twins of the JAX package's ``benchmarks/``):
``bench_kernels`` times the kernels against their plain versions and a
library call, and the fused search pipelines against the composed ones."""
