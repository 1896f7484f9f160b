"""Per-layer metric readers, one module per metric of BENCHMARK.json."""
