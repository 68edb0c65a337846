"""The benchmark of `nnue_vision_tpu_torch`: a data-driven harness whose
cells, configurations, traffic mixes, per-layer metrics and correctness
limits are files found by name (`perfbench/README.md`)."""
