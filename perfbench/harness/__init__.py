"""The benchmark's general code: spec discovery, weights, traffic, tracing, checks."""
