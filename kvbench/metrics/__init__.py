"""Metric readers, one module per metric name of BENCHMARK.json."""
