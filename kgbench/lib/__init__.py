"""The harness's yardstick: graph generation, weights, work counts, the
reduction of profiler traces to metrics, and the comparison that decides
``correct``."""
