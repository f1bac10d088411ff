"""The readers of the program's recording (`scs_tpu_torch.trace`) on a
trace and a recording made by hand: `host_syncs_per_iter`, `read_idle`,
`loop_idle` and `floor_share`, each on numbers worked out beside it, and
None where the program records nothing."""

import sys
from collections import deque

import pytest

from portbench import registry
from portbench.harness import Run
from portbench.trace import Trace

NAMES = ("host_syncs_per_iter", "read_idle", "loop_idle", "floor_share")


def _span(trace, name, t0, t1, **attrs):
    sp = trace.Span(name, 1, attrs)
    sp.t0, sp.t1 = t0, t1
    return sp


def _recorded(monkeypatch, recs):
    from scs_tpu_torch import trace

    monkeypatch.setattr(trace, "_records", deque(recs))


def _run(iters=6):
    # device busy [100, 200), [300, 400), [600, 700) of the span [0, 1000):
    # idle gaps [0, 100), [200, 300), [400, 600), [700, 1000)
    t = Trace(span_ns=(0, 1000), ops=[
        ("k", "kernel", 100, 200), ("k", "kernel", 300, 400), ("c", "gpu_memcpy", 600, 700),
    ], host=[], iters=iters)
    return Run(cfg={}, traffic={}, device={}, trace=t)


@pytest.fixture
def recording(monkeypatch):
    from scs_tpu_torch import trace

    recs = [
        _span(trace, "batch.solve", 10, 990),
        # joined [50, 350] and [380, 900]; the floor (32 rows) from 380
        _span(trace, "solve.segment", 50, 350, bucket=64, chunks=1),
        _span(trace, "solve.segment", 380, 650, bucket=32, chunks=8),
        _span(trace, "solve.segment", 640, 900, bucket=32, chunks=3),
        _span(trace, "solve.segment", 1100, 1200, bucket=32, chunks=1),  # outside the span
        # in the gap [200, 300), in a copy, in the gap [700, 1000), outside
        trace.Sync("live", 250, None, 1), trace.Sync("probe", 650, None, 1),
        trace.Sync("results", 800, None, 1), trace.Sync("results", 1500, None, 1),
    ]
    _recorded(monkeypatch, recs)
    return recs


def read(name, run):
    return registry.metric(name).read(run)


def test_readers_on_a_known_recording(recording):
    run = _run()
    assert read("host_syncs_per_iter", run) == pytest.approx(3 / 6)
    assert read("read_idle", run) == pytest.approx(100 * (100 + 300) / 1000)
    # idle in [50, 350]: 50 + 100; in [380, 900]: 200 + 200
    assert read("loop_idle", run) == pytest.approx(100 * (150 + 400) / 1000)
    assert read("floor_share", run) == pytest.approx(100 * (900 - 380) / 1000)


def test_floor_share_is_zero_above_the_floor(monkeypatch):
    from scs_tpu_torch import trace

    _recorded(monkeypatch, [_span(trace, "solve.segment", 50, 350, bucket=64, chunks=1)])
    assert read("floor_share", _run()) == 0.0


def test_nothing_to_read(monkeypatch, recording):
    # no trace
    assert all(read(n, Run(cfg={}, traffic={}, device={})) is None for n in NAMES)
    # a program without the recording (the module cannot be imported)
    monkeypatch.setitem(sys.modules, "scs_tpu_torch.trace", None)
    assert all(read(n, _run()) is None for n in NAMES)


def test_nothing_recorded(monkeypatch):
    _recorded(monkeypatch, [])
    assert all(read(n, _run()) is None for n in NAMES)


def test_a_traced_batch_on_the_cpu_is_recorded(tiny_qp, tiny_traffic):
    """The harness's traced batch runs under the profiler, so the program
    records it with no change to the harness."""
    from portbench import harness
    from scs_tpu_torch import trace

    trace.clear()
    cfg = dict(tiny_qp)
    run = harness.run_cell(cfg, dict(tiny_traffic, batch=64), seed=2**31 + 5, seconds=0.0,
                           trace=True, device="cpu")
    assert run.trace.iters > 0
    # one recorded batch: the traced one, its syncs and segments
    recs = trace.records(*run.trace.span_ns)
    assert len({r.batch for r in recs}) == 1
    assert any(isinstance(r, trace.Sync) for r in recs)
    assert any(isinstance(r, trace.Span) and r.name == "solve.segment" for r in recs)
    # the CPU's window holds no device operation: no card, nothing to read
    assert all(read(n, run) is None for n in NAMES)
