"""scs_tpu's tests/test_failure_modes.py, run against the port on the CPU.

Every case of the reference module runs its own test function, with its
own tolerances, seeds and sizes, through the CPU facade of scs_tpu_torch
(`tests/torch_ref_facade.py`), except the case of TABLE, which builds its
states with jax.numpy; its counterpart below builds them with torch."""

import math

import pytest
import torch

import test_failure_modes as ref
from torch_ref_facade import SCS, ref_cases, run_ref_case

TABLE = {
    "test_indeterminate_classification":
        "builds scs_tpu states from jax.numpy arrays (jnp.ones(N).at[-1])",
}


@pytest.mark.parametrize("case", ref_cases(ref, table=TABLE))
def test_ref(case, monkeypatch, request):
    run_ref_case(ref, case, monkeypatch, request)


def test_indeterminate_classification():
    """A state whose tau AND kappa collapsed (relative to the iterate norm)
    with no certificate classifies as INDETERMINATE; a healthy one does
    not. The port's states, built with torch."""
    data, cone = ref._lp()
    solver = SCS(data, cone, verbose=False, max_iters=50)
    state = solver.core.init_state(solver.mats)
    N = solver.core.N
    u = torch.ones(N, dtype=state.u.dtype)
    u[-1] = 0.0
    u = u * math.sqrt(N / (N - 1.0))
    state = state._replace(u=u, v=torch.zeros(N, dtype=state.v.dtype))
    assert SCS._is_indeterminate(state, float(state.u[-1]), float(state.v[-1]))
    healthy = solver.core.init_state(solver.mats)
    assert not SCS._is_indeterminate(
        healthy, float(healthy.u[-1]), float(healthy.v[-1])
    )
