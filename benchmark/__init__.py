"""Benchmark of pathtracer_tpu_torch: see benchmark/run.py."""
