"""dtype "auto" in the port: what it resolves to on each device
(scs_tpu_torch.settings.AUTO_DTYPE, float64), where each solver class
resolves it, and that an explicit dtype wins. The "cuda" cases build
Settings with "cuda" as a plain string (torch.cuda.is_available patched:
Settings makes no tensor); the classes run on the CPU. One `cuda`-marked
test builds each class on the card.

This module imports no JAX: the port's settings have no counterpart to
compare with (scs_tpu's dtype rule is the TPU's), and the sharded case runs
in a spawned gloo world of one rank (tests/torch_parallel_workers.py).
"""

import numpy as np
import pytest
import torch
from scipy import sparse

import scs_tpu_torch as st
from scs_tpu_torch.parallel.dryrun import spawn_world
from scs_tpu_torch.settings import AUTO_DTYPE, Settings

import torch_parallel_workers as W

CPU = dict(device="cpu")
LP_K = {"l": 8}
CURVED_K = {"z": 1, "l": 2, "q": [3]}


def _lp():
    """A bounded, feasible LP over the nonnegative cone: 8 x 4, x in [-1, 1]."""
    A = sparse.csc_matrix(np.vstack([np.eye(4), -np.eye(4)]))
    return {"A": A, "b": np.ones(8), "c": np.ones(4)}


def _lp_batch(B=2):
    d = _lp()
    A = d["A"].toarray()
    return {"A": np.stack([A] * B), "b": np.stack([d["b"]] * B), "c": np.stack([d["c"]] * B)}


# -- the rule on CUDA, with "cuda" as a string --------------------------------

# the defaults; where f32 certifies every measured zero / nonnegative row
# (eps_infeas 1e-5); loose tolerances; tight ones
TOLERANCES = [
    dict(),
    dict(eps_abs=1e-4, eps_rel=1e-4, eps_infeas=1e-5),
    dict(eps_abs=1e-3, eps_rel=1e-2, eps_infeas=1e-3),
    dict(eps_abs=1e-6, eps_rel=1e-6, eps_infeas=1e-9),
]


@pytest.fixture
def cuda_string(monkeypatch):
    """Settings accepts device "cuda" without a card (no tensor is made)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


def test_auto_dtype_is_float64():
    assert AUTO_DTYPE == "float64"


@pytest.mark.parametrize("kw", TOLERANCES)
@pytest.mark.parametrize("strategy", ["auto", "direct", "indirect", "bell"])
def test_cuda_auto_is_float64(cuda_string, strategy, kw):
    """On CUDA "auto" is float64 under every strategy and tolerance, with
    no exception (PERF.md §6, the dtype table)."""
    for device in ("cuda", "cuda:0"):
        stg = Settings.from_kwargs(device=device, solver_strategy=strategy, **kw)
        assert stg.dtype == "float64"
        assert Settings.from_kwargs(device=device, dtype="auto", **kw).dtype == "float64"


@pytest.mark.parametrize("explicit", ["float32", "float64"])
def test_cuda_explicit_dtype_wins(cuda_string, explicit):
    for kw in TOLERANCES:
        assert Settings.from_kwargs(device="cuda", dtype=explicit, **kw).dtype == explicit


# -- where "auto" is resolved: every class on the CPU -------------------------


def test_settings_cpu_auto_is_float64():
    assert Settings.from_kwargs(**CPU).dtype == "float64"
    assert Settings.from_kwargs(**CPU, dtype="auto").dtype == "float64"
    assert Settings.from_kwargs(**CPU, dtype="float32").dtype == "float32"


@pytest.mark.parametrize("dtype,want", [("auto", "float64"), ("float32", "float32"),
                                        ("float64", "float64")])
@pytest.mark.parametrize("strategy", ["direct", "indirect", "bell"])
def test_scs_resolves_on_cpu(strategy, dtype, want):
    """SCS and solve: "auto" is float64 on the CPU under every strategy, an
    explicit dtype stays, and stg.dtype is concrete after construction."""
    solver = st.SCS(_lp(), LP_K, solver_strategy=strategy, dtype=dtype, verbose=False, **CPU)
    assert solver.stg.dtype == want
    assert solver._dtype == getattr(torch, want) and solver.mats.bn.dtype == getattr(torch, want)
    sol = st.solve(_lp(), LP_K, solver_strategy=strategy, dtype=dtype, verbose=False, **CPU)
    assert sol["info"]["status"] == "solved"
    assert sol["x"].dtype == np.dtype(want)


@pytest.mark.parametrize("dtype,want", [("auto", "float64"), ("float32", "float32")])
@pytest.mark.parametrize("strategy", ["direct", "bell"])
def test_batched_resolves_on_cpu(strategy, dtype, want):
    """BatchedSCS and solve_batch, dense and bell."""
    data = _lp_batch()
    if strategy == "bell":
        data = dict(data, A=[sparse.csc_matrix(a) for a in data["A"]])
    solver = st.BatchedSCS(data, LP_K, solver_strategy=strategy, dtype=dtype, **CPU)
    assert solver.stg.dtype == want and solver._dtype == getattr(torch, want)
    res = st.solve_batch(data, LP_K, solver_strategy=strategy, dtype=dtype, **CPU)
    assert [r["info"]["status"] for r in res] == ["solved", "solved"]


def test_sharded_resolves_on_cpu():
    """ShardedSCS in a gloo world of one rank: "auto" is float64 under both
    of its strategies; an explicit float32 stays."""
    cases = [dict(**CPU, solver_strategy="indirect"), dict(**CPU, solver_strategy="bell"),
             dict(**CPU, solver_strategy="bell", dtype="float32")]
    (got,) = spawn_world(1, W.sharded_dtypes, (cases,), timeout=120.0)
    assert got == ["float64", "float64", "float32"]


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: each class is built on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("K", [LP_K, CURVED_K])
def test_classes_report_the_rule_on_card(cuda_device, K):
    """Each class built with dtype "auto" on the card holds AUTO_DTYPE under
    every strategy; explicit dtypes stay."""
    m = sum(v if isinstance(v, int) else sum(v) for v in K.values())
    rng = np.random.RandomState(0)
    A = sparse.csc_matrix(rng.standard_normal((m, 4)))
    data = {"A": A, "b": np.ones(m), "c": np.ones(4)}
    batch = {"A": np.stack([A.toarray()] * 2), "b": np.stack([data["b"]] * 2),
             "c": np.stack([data["c"]] * 2)}
    for kw in TOLERANCES[:2]:
        for strategy in ("direct", "indirect", "bell"):
            solver = st.SCS(data, K, solver_strategy=strategy, verbose=False, **kw)
            assert solver.stg.dtype == AUTO_DTYPE
            assert st.SCS(data, K, solver_strategy=strategy, dtype="float32", verbose=False,
                          **kw).stg.dtype == "float32"
        for strategy, b in (("direct", batch), ("bell", dict(batch, A=[A, A]))):
            solver = st.BatchedSCS(b, K, solver_strategy=strategy, **kw)
            assert solver.stg.dtype == AUTO_DTYPE
    (got,) = spawn_world(1, W.sharded_dtypes, ([dict(solver_strategy="indirect"),
                                                 dict(solver_strategy="bell")],),
                         timeout=120.0)
    assert got == [AUTO_DTYPE, AUTO_DTYPE]
