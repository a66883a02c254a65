"""Benchmarks of the port (twins of the JAX package's ``benchmarks/``):
``bench_kernels`` times the kernels against their plain versions and a
library call, and the fused search pipelines against the composed ones; the
paper's tables and figures come from ``bench_autoconfig``,
``bench_efficiency``, ``bench_ablation``, ``bench_preference``,
``bench_costaware`` and ``bench_overhead``, all run by ``run``, through
``common``'s environment and one ``TuningSession`` harness."""
