"""scs_tpu's tests/test_rand.py, run against the port on the CPU: part a
of five (PARTS).

Every case of the reference module runs its own test function, with its
own tolerances, seeds and sizes, through the CPU facade of scs_tpu_torch
(`tests/torch_ref_facade.py`). The port's eager CPU loop projects the
exponential and power cones at ~0.1 s a call, so a sweep case takes
20-85 s here; the family is split by case over five files
(test_torch_ref_rand.py, _b ... _e), each under 150 s on one worker. The
reference's own slow cases (the "indirect" strategy) stay slow."""

import pytest

import test_rand as ref
from torch_ref_facade import ref_case_ids, ref_cases, run_ref_case

PARTS = {
    "a": ["test_solve_feasible", "test_solve_infeasible", "test_solve_unbounded",
          "test_sweep_feasible[1000]"],
    "b": ["test_sweep_feasible[1001]", "test_sweep_feasible[1009]",
          "test_sweep_infeasible"],
    "c": ["test_sweep_feasible[1005]", "test_sweep_feasible[1006]",
          "test_sweep_unbounded"],
    "d": ["test_sweep_feasible[1002]", "test_sweep_feasible[1004]",
          "test_sweep_feasible[1007]"],
    "e": ["test_sweep_feasible[1003]", "test_sweep_feasible[1008]",
          "test_feasible_with_P"],
}


@pytest.mark.parametrize("case", ref_cases(ref, only=PARTS["a"]))
def test_ref(case, monkeypatch, request):
    run_ref_case(ref, case, monkeypatch, request)


def test_parts_cover_the_family_once():
    ids = [c for part in PARTS.values() for c in ref_case_ids(ref, only=part)]
    assert sorted(ids) == sorted(ref_case_ids(ref))
