"""scs_tpu's tests/test_rand.py, run against the port on the CPU: part b
of five (tests/test_torch_ref_rand.py says why the family is split)."""

import pytest

import test_rand as ref
from test_torch_ref_rand import PARTS
from torch_ref_facade import ref_cases, run_ref_case


@pytest.mark.parametrize("case", ref_cases(ref, only=PARTS["b"]))
def test_ref(case, monkeypatch, request):
    run_ref_case(ref, case, monkeypatch, request)
