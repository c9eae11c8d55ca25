"""Benchmark of audiodec_tpu_torch (see benchmark/README.md)."""
