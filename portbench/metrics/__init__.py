"""Readers of the benchmark's metrics, one module per metric name, each
with read(run) -> number or None (None: the run holds nothing to read,
and the metric is left out of the result line). `kernel_bytes.py` holds the
byte counts of the kernels whose rooflines are read."""
