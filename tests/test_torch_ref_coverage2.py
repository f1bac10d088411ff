"""scs_tpu's tests/test_coverage2.py, run against the port on the CPU.

Every case of the reference module runs its own test function, with its
own tolerances, seeds and sizes, through the CPU facade of scs_tpu_torch
(`tests/torch_ref_facade.py`)."""

import pytest

import test_coverage2 as ref
from torch_ref_facade import ref_cases, run_ref_case


@pytest.mark.parametrize("case", ref_cases(ref))
def test_ref(case, monkeypatch, request):
    run_ref_case(ref, case, monkeypatch, request)
