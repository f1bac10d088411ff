"""Generators of the benchmark's problem batches, one module per name."""
