"""The span-and-sync recorder (scs_tpu_torch/trace.py) on the CPU: spans
nest under their parents and batch, the clock is the profiler's, nothing
is recorded while recording is off, a recording leaves the answers' bits
alone, and every wait of a batched solve is counted at a named site."""

from collections import Counter

import numpy as np
import pytest
import torch

import scs_tpu_torch as st
from scs_tpu_torch import trace
from scs_tpu_torch.batch_core import BatchedCore
from scs_tpu_torch.solver import Core

CPU = dict(device="cpu")
KW = dict(dtype="float64", eps_abs=1e-6, eps_rel=1e-6, max_iters=4000, **CPU)


def _gen(B, m, n, seed):
    """B feasible dense QPs over the nonnegative cone (the bench recipe)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(B, m, n) / np.sqrt(m)
    z = rng.randn(B, m)
    y = np.maximum(z, 0)
    x = rng.randn(B, n)
    G = rng.randn(B, n, 5)
    P = 0.1 * G @ G.transpose(0, 2, 1) + 1e-3 * np.eye(n)
    c = -np.einsum("bmn,bm->bn", A, y) - np.einsum("bij,bj->bi", P, x)
    return {"A": A, "b": np.einsum("bmn,bn->bm", A, x) + (y - z), "c": c, "P": P}


def _solve(data, **kw):
    s = st.BatchedSCS({k: v.copy() for k, v in data.items()}, {"l": data["A"].shape[1]},
                      **{**KW, **kw})
    return s, s.solve()


@pytest.fixture
def fresh():
    trace.clear()
    yield
    trace.clear()


def _of(kind):
    return [r for r in trace.records() if isinstance(r, kind)]


def test_spans_nest_under_their_parents_and_batch(fresh):
    with trace.recording():
        with trace.span("outer", batch=7, k=1) as a:
            with trace.span("inner") as b:
                trace.host_sync("here")
                b.set(n=2)
            trace.host_sync("there")
        trace.host_sync("nowhere")
        with trace.span("alone"):
            pass
    inner, outer, alone = _of(trace.Span)  # in the order they closed
    assert (inner.name, outer.name, alone.name) == ("inner", "outer", "alone")
    assert inner is b and outer is a
    assert outer.parent is None and inner.parent == outer.id and alone.parent is None
    assert inner.batch == outer.batch == 7 and alone.batch is None
    assert outer.attrs == {"k": 1} and inner.attrs == {"n": 2}
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1 <= alone.t0
    here, there, nowhere = _of(trace.Sync)
    assert (here.site, here.span, here.batch) == ("here", inner.id, 7)
    assert (there.site, there.span, there.batch) == ("there", outer.id, 7)
    assert (nowhere.span, nowhere.batch) == (None, None)
    assert inner.t0 <= here.t <= inner.t1 and inner.t1 <= there.t <= outer.t1


def test_recording_is_off_by_default(fresh):
    assert not trace.active()
    data = _gen(4, 10, 6, seed=1)
    _solve(data)
    with trace.span("x") as sp:
        trace.host_sync("y")
    assert sp is trace.span("z") and trace.records() == []
    with trace.recording():
        with trace.recording():
            assert trace.active()
        assert trace.active()
    assert not trace.active()


def test_records_are_bounded(fresh):
    with trace.recording():
        for _ in range(trace.MAX_RECORDS + 10):
            trace.host_sync("s")
    assert len(trace.records()) == trace.MAX_RECORDS


def test_the_clock_is_the_profilers(fresh):
    """A profiler session turns recording on, and an aten op's kineto
    interval lies inside the span around it (both epoch ns)."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(300, 300, dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.active()
        with trace.span("mm"):
            torch.mm(a, a)
    assert not trace.active()
    (sp,) = _of(trace.Span)
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    s = mm[0].start_ns()
    assert sp.t0 <= s and s + mm[0].duration_ns() <= sp.t1


def test_results_are_bit_equal_with_recording_on_and_off(fresh):
    data = _gen(64, 20, 12, seed=2)
    _, off = _solve(data)
    with trace.recording():
        _, on = _solve(data)
    assert trace.records()
    for a, b in zip(off, on):
        for k in ("x", "y", "s"):
            np.testing.assert_array_equal(a[k], b[k])
        assert {k: v for k, v in a["info"].items() if not k.endswith("time")} == {
            k: v for k, v in b["info"].items() if not k.endswith("time")}


# the ways the host reads a device value, and the device waits
_READS = ("__bool__", "__float__", "__int__", "item", "tolist", "cpu", "numpy", "nonzero")


@pytest.mark.parametrize("kw", [
    {},  # BatchedSCS's defaults: check_interval 50, the trial-aligned chunk
    {"check_interval": 25},  # not a multiple of the AA interval: a trial test every iteration
    {"solver_strategy": "indirect"},  # CG
    {"rescale_in_chunk": True},  # the rescale applied inside the chunk
], ids=["direct", "unaligned", "indirect", "rescale_in_chunk"])
def test_every_wait_of_a_batched_solve_is_counted(fresh, monkeypatch, kw):
    """On a B = 64 batch that compacts, rescales and fires the AA trial,
    every read of a tensor and every `_sync` is a counted host sync. (On
    the CPU an upload is no wait and is not counted; on a card
    `trace.uploaded` counts it.)"""
    calls = Counter()
    last_cpu = [None]  # `.cpu().numpy()` is one read

    def counting(name, real):
        def f(self, *a, **k):
            out = real(self, *a, **k)
            if name == "numpy" and self is last_cpu[0]:
                last_cpu[0] = None
                return out
            if name == "cpu":
                last_cpu[0] = out
            calls[name] += 1
            return out
        return f

    for name in _READS:
        monkeypatch.setattr(torch.Tensor, name, counting(name, getattr(torch.Tensor, name)))
    for cls in (Core, BatchedCore):
        monkeypatch.setattr(cls, "_sync", counting("_sync", cls._sync))
    data = _gen(64, 20, 12, seed=2)
    with trace.recording():
        s, res = _solve(data, **kw)
    syncs = Counter(r.site for r in _of(trace.Sync))
    assert sum(syncs.values()) == sum(calls.values()), (syncs, calls)
    assert s.bucket_ladder == [64, 32]
    assert any(r["info"]["scale_updates"] for r in res)
    assert syncs["setup_sync"] == calls["_sync"] == 1  # set-up's one wait
    assert syncs["results"] == 14 and syncs["probe"] >= 2 and syncs["finalize"] == 2
    if kw.get("solver_strategy") == "indirect":
        assert syncs["cg"] > 0
    else:
        assert syncs["aa_trial"] > 0 and syncs["rescale_rows"] > 0
    # every sync lies in the batch's spans
    spans = {sp.id: sp for sp in _of(trace.Span)}
    assert {sp.batch for sp in spans.values()} == {s._batch}
    assert all(spans[r.span].t0 <= r.t <= spans[r.span].t1 for r in _of(trace.Sync))


def test_the_span_tree_of_a_batch(fresh):
    data = _gen(64, 20, 12, seed=2)
    with trace.recording():
        s, _ = _solve(data)
    spans = _of(trace.Span)
    by_id = {sp.id: sp for sp in spans}

    def parent(sp):
        return by_id[sp.parent].name if sp.parent else None

    assert {(sp.name, parent(sp)) for sp in spans} == {
        ("batch.setup", None), ("batch.solve", None),
        ("setup.upload", "batch.setup"), ("setup.equilibrate", "batch.setup"),
        ("setup.factorize", "batch.setup"), ("setup.g", "batch.setup"),
        ("solve.segment", "batch.solve"), ("solve.probe", "batch.solve"),
        ("solve.rescale", "batch.solve"), ("solve.finalize", "batch.solve"),
        ("solve.compact", "batch.solve"), ("solve.results", "batch.solve"),
    }
    segs = [sp for sp in spans if sp.name == "solve.segment"]
    assert [sp.attrs["bucket"] for sp in segs] == sorted(
        (sp.attrs["bucket"] for sp in segs), reverse=True)
    assert segs[-1].attrs["bucket"] == s._MIN_BUCKET
    # a segment runs one chunk above the floor and up to 8 at it. Its chunks
    # of 50 iterations at its bucket are what the lockstep ran: more than
    # device_prob_iters, which counts the segment run before a compaction
    # at the compacted size (here one chunk at 64 rows, counted at 32)
    assert all(sp.attrs["chunks"] <= (8 if sp.attrs["bucket"] <= s._MIN_BUCKET else 1)
               for sp in segs)
    ran = sum(sp.attrs["bucket"] * sp.attrs["chunks"] * 50 for sp in segs)
    assert ran == s.device_prob_iters + (64 - 32) * 50


def test_setup_breakdown_without_its_own_waits(monkeypatch):
    """Set-up waits once (for setup_time); its breakdown is read from the
    marks at the setup.* boundaries when first read, with no wait."""
    waits = Counter()
    real = BatchedCore._sync

    def counted(self, *a, **k):
        waits["n"] += 1
        return real(self, *a, **k)

    monkeypatch.setattr(BatchedCore, "_sync", counted)
    s = st.BatchedSCS(_gen(4, 10, 6, seed=1), {"l": 10}, **KW)
    assert waits["n"] == 1
    sb = s.setup_breakdown
    assert waits["n"] == 1 and sb is s.setup_breakdown
    assert list(sb) == ["transfer", "equilibrate", "factorize", "compute_g"]
    assert all(v > 0 for v in sb.values())
    assert sum(sb.values()) <= s._setup_time
