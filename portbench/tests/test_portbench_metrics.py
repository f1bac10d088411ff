"""The metric readers on runs and traces made by hand: the arithmetic of
each, on numbers worked out beside it."""

from collections import Counter

import numpy as np
import pytest

from portbench import registry
from portbench.harness import Batch, Run
from portbench.metrics import kernel_bytes
from portbench.trace import Trace

H100 = {"kind": "NVIDIA H100 80GB HBM3"}


def _run(**kw):
    run = Run(cfg={"dtype": "float64"}, traffic={}, device=dict(H100))
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def _batch(iters, statuses=None, construct=1.0, solve=3.0, dpi=None, traced=False):
    iters = np.asarray(iters)
    return Batch(0, construct, solve, iters, statuses or ["solved"] * len(iters),
                 int(iters.sum()) if dpi is None else dpi, traced)


def read(name, run):
    return registry.metric(name).read(run)


def test_gemv_bytes_known_shapes():
    # the flagship A in f64: 512 (1500 x 1000 + 1500 + 1000) doubles
    assert kernel_bytes.gemv(512, 1500, 1000, 8) == 8 * 512 * 1_502_500
    assert kernel_bytes.gemv(1, 3, 2, 4) == 4 * (6 + 3 + 2)


def test_gemv_roofline():
    # 2 launches of G1 and 1 of G2 at (4, 1000, 500) f64, 3 kernels of 10 us
    per = kernel_bytes.gemv(4, 1000, 500, 8)
    trace = Trace(span_ns=(0, 100_000), ops=[
        ("void gemv_rows_kernel<double, 4, 8, false>(...)", "kernel", 0, 10_000),
        ("void gemv_rows_kernel<double, 4, 8, false>(...)", "kernel", 20_000, 30_000),
        ("void gemv_cols_kernel<double, false>(...)", "kernel", 40_000, 50_000),
        ("other", "kernel", 50_000, 90_000),
    ], host=[], counters={"gemv_rows": Counter({(4, 1000, 500): 2}),
                          "gemv_cols": Counter({(4, 1000, 500): 1})})
    want = 100 * 3 * per / 3.35e12 / 30e-6
    assert read("gemv_roofline", _run(trace=trace)) == pytest.approx(want)
    # no card of the table, no trace, or no G1/G2 time: nothing to read
    assert read("gemv_roofline", _run(trace=trace, device={"kind": "cpu"})) is None
    assert read("gemv_roofline", _run()) is None
    trace.ops = trace.ops[3:]
    assert read("gemv_roofline", _run(trace=trace)) is None


def test_device_idle_and_kernels_per_iter():
    # busy: [10, 40) joined from two overlapping kernels, a copy [60, 70):
    # 40 of the span's 100 ns
    trace = Trace(span_ns=(0, 100), ops=[
        ("k1", "kernel", 10, 30), ("k2", "kernel", 20, 40), ("copy", "gpu_memcpy", 60, 70),
        ("k3", "kernel", 95, 105),
    ], host=[("aten::item", 40, 60)], iters=2)
    assert trace.busy_ns() == 20 + 10 + 10 + 5
    assert read("device_idle", _run(trace=trace)) == pytest.approx(55.0)
    assert read("kernels_per_iter", _run(trace=trace)) == pytest.approx(1.5)
    gaps = dict(trace.idle_gaps())
    assert gaps["aten::item"] == 20 and gaps["python"] == 10 + 25
    assert read("device_idle", _run()) is None


def test_proj_busy_share():
    trace = Trace(span_ns=(0, 100), ops=[
        ("void proj_exp_kernel<double, 8>(...)", "kernel", 0, 10),
        ("syevj_batched_kernel", "kernel", 10, 30),
        ("elementwise", "kernel", 30, 50),
    ], host=[])
    assert read("proj_busy_share", _run(trace=trace)) == pytest.approx(60.0)
    trace.ops = trace.ops[2:]
    assert read("proj_busy_share", _run(trace=trace)) is None


def test_problems_per_s_counts_whole_batches():
    """Solved problems of every batch the window ran, over the time to the
    end of its last batch."""
    b = [_batch([10] * 4), _batch([10] * 4, ["solved"] * 3 + ["solved_inaccurate"])]
    assert read("problems_per_s", _run(batches=b, window_s=8.0)) == pytest.approx(7 / 8)
    assert read("problems_per_s", _run(batches=[], window_s=0.0)) is None


def test_batch_counters():
    b = [_batch([10, 20], construct=1.0, solve=3.0, dpi=40),
         _batch([30, 40], construct=2.0, solve=2.0, dpi=80),
         _batch([5, 5], construct=9.0, solve=1.0, traced=True)]
    run = _run(batches=b)
    assert read("iters_per_problem", run) == pytest.approx(110 / 6)
    assert read("lockstep_eff", run) == pytest.approx(100 * 110 / (40 + 80 + 10))
    assert read("batch_setup_share", run) == pytest.approx(100 * 3 / 8)


def test_peak_mem_and_setup():
    run = _run(peak_bytes=30_000_000_000, harness_bytes=10_000_000_000, setup_s=12.5)
    assert read("peak_mem_GB", run) == pytest.approx(20.0)
    assert read("setup_s", run) == 12.5
    assert read("peak_mem_GB", _run()) is None
