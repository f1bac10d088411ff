"""scs_tpu's tests/test_coverage.py, run against the port on the CPU.

Every case of the reference module runs its own test function, with its
own tolerances, seeds and sizes, through the CPU facade of scs_tpu_torch
(`tests/torch_ref_facade.py`), except the cases of TABLE: they reach JAX
internals of scs_tpu, and each has a counterpart below that checks the
same property through the port's own internals. The facade's own checks
close the file."""

import dataclasses

import numpy as np
import pytest
import torch

import scs_tpu_torch
import test_basic
import test_batch_update
import test_coverage as ref
import test_coverage2
import test_coverage3
import test_coverage4
import test_failure_modes
import test_rand
import test_threading
import test_warm_start_consistency
import torch_ref_facade as facade
from scs_tpu_torch import info as info_mod
from torch_ref_facade import SCS, count_calls, ref_cases, run_ref_case

TABLE = {
    "test_update_path_has_no_cholesky":
        "reads the jaxprs of scs_tpu's Core._init_pure and _init_from_factor",
    "test_repeat_solve_reuses_setup":
        "patches scs_tpu's Core._jit_init, the jitted full-init program",
    "test_indeterminate_end_to_end":
        "patches scs_tpu's Core._jit_chunk / _jit_multi_chunk and builds the "
        "collapsed state with jax.numpy",
}


@pytest.mark.parametrize("case", ref_cases(ref, table=TABLE))
def test_ref(case, monkeypatch, request):
    run_ref_case(ref, case, monkeypatch, request)


# -- counterparts of TABLE ---------------------------------------------------


def test_update_path_has_no_cholesky(monkeypatch):
    """update(b, c) reuses the numeric factor: the full setup factorizes,
    the update runs no Cholesky and applies the cached factor to recompute
    g, and the re-solve factorizes only at its rescales."""
    chol = count_calls(monkeypatch, torch.linalg, "cholesky_ex")
    data, m, n = ref._small_qp()
    solver = SCS(data, {"l": m}, verbose=False, solver_strategy="direct")
    assert solver.core.factorizations == 1 and chol["n"] == 1
    L0 = solver._state0.L
    solver.solve()
    fac, n_chol = solver.core.factorizations, chol["n"]
    apply = count_calls(monkeypatch, torch, "cholesky_solve")
    solver.update(b=data["b"] * 1.1, c=data["c"] * 0.9)
    assert chol["n"] == n_chol and solver.core.factorizations == fac
    assert solver._state0.L is L0
    assert apply["n"] >= 1  # g is recomputed via the factor
    sol = solver.solve(warm_start=False)
    assert sol["info"]["status"] == "solved"
    assert solver.core.factorizations - fac == sol["info"]["scale_updates"]


def test_repeat_solve_reuses_setup(monkeypatch):
    """A second solve() and a post-update solve never re-run the full
    init (Core._init_pure, the port's init program) and factorize only at
    their rescales."""
    data, m, n = ref._small_qp()
    solver = SCS(data, {"l": m}, verbose=False, eps_abs=1e-7, eps_rel=1e-7)
    init = count_calls(monkeypatch, solver.core, "_init_pure")
    fac = solver.core.factorizations
    s1 = solver.solve(warm_start=False)
    s2 = solver.solve()  # warm
    solver.update(b=data["b"] * 1.1)
    s3 = solver.solve(warm_start=False)
    assert init["n"] == 0, "solve()/update() re-ran the full init program"
    rescales = sum(s["info"]["scale_updates"] for s in (s1, s2, s3))
    assert solver.core.factorizations - fac == rescales
    assert s1["info"]["status"] == "solved"
    assert s3["info"]["status"] == "solved"
    A = data["A"].toarray()
    assert np.linalg.norm(A @ s3["x"] + s3["s"] - 1.1 * data["b"]) < 1e-3


def test_indeterminate_end_to_end(monkeypatch):
    """A solve whose final iterate carries no signal (tau ~ kappa ~ 0, no
    certificate) classifies as INDETERMINATE through the normal solve
    path: the port's chunk collapses the embedding ray."""
    data, m, n = ref._small_qp(seed=5)
    solver = SCS(data, {"l": m}, verbose=False, max_iters=25, eps_abs=1e-12,
                 eps_rel=1e-12)
    core = solver.core
    real = core._chunk

    def sabotage(state, mats):
        st = real(state, mats)
        scale = 1e-14
        u, v = st.u * scale, st.v * scale
        u[-1] = 0.0
        v[-1] = 0.0
        return st._replace(
            u=u, v=v, w=st.w * scale,
            u_sum=torch.zeros_like(st.u_sum), v_sum=torch.zeros_like(st.v_sum),
            avg_cnt=0.0, status=info_mod.UNFINISHED,
        )

    monkeypatch.setattr(core, "_chunk", sabotage)
    sol = solver.solve(warm_start=False)
    assert sol["info"]["status"] == "indeterminate"
    assert sol["info"]["status_val"] == scs_tpu_torch.INDETERMINATE


# -- the facade itself --------------------------------------------------------

FAMILIES = (ref, test_coverage2, test_coverage3, test_coverage4,
            test_failure_modes, test_warm_start_consistency,
            test_batch_update, test_threading, test_basic, test_rand)


@pytest.mark.parametrize("module", FAMILIES, ids=lambda m: m.__name__)
def test_rebind_leaves_no_reference_global(module, monkeypatch):
    """While a case runs, no global of the reference module names an object
    of scs_tpu, and `import scs_tpu...` answers with the facade."""
    facade.rebind(module, monkeypatch)
    left = [k for k, v in vars(module).items()
            if facade._counterpart(v) is not None
            and facade._counterpart(v) is not v]
    assert not left
    import scs_tpu
    import scs_tpu.api as api_mod

    assert scs_tpu is facade.FACADE and api_mod is scs_tpu_torch.api


def test_facade_defaults_to_cpu_and_port_to_cuda():
    """The facade passes device="cpu"; the port keeps "cuda" and raises
    without a card."""
    field = {f.name: f for f in dataclasses.fields(scs_tpu_torch.Settings)}
    assert field["device"].default == "cuda"
    assert facade.Settings.from_kwargs().device == "cpu"
    assert facade.FACADE.Settings.from_kwargs(device="cpu").dtype == "float64"
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="device"):
            scs_tpu_torch.SCS(ref._TINY, {"l": 2})
        with pytest.raises(ValueError, match="device"):
            scs_tpu_torch.solve_batch(
                {"A": np.ones((2, 2, 1)), "b": np.ones((2, 2)),
                 "c": np.ones((2, 1))}, {"l": 2})
