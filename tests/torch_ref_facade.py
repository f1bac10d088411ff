"""A CPU facade of scs_tpu_torch, and the runner that holds the port to
scs_tpu's own public-surface test functions.

The port's entry points run on "cuda" unless told otherwise, and raise
where there is no card. The facade (`FACADE`, a module that stands in for
the `scs_tpu` package) passes device="cpu" by default to SCS, BatchedSCS,
solve, solve_batch and Settings.from_kwargs, and re-exports everything
else of scs_tpu_torch unchanged; its submodules are the port's own
(`scs_tpu_torch.api`, `.info`, `.io`, ...), except `batch`, whose
BatchedSCS and solve_batch default to the CPU as well.

`ref_cases(module, ...)` expands a reference test module's `test_*`
functions, with their own `pytest.mark.parametrize` marks (stacked marks
multiply, `pytest.param` marks are kept), into the params of one
parametrised test; a case marked `slow` stays `slow`. `run_ref_case(...)`
calls one case with the module's package globals (`scs`, `scs_tpu`,
`BatchedSCS`, `info_mod`, the names imported from `scs_tpu.api`) rebound
to the facade for the duration of the call, and with `sys.modules`
answering `scs_tpu` and its submodules with the facade, so that a test's
own `from scs_tpu.x import y` and `mock.patch("scs_tpu.x.y")` reach the
port too. The reference test bodies run unchanged, with their own
tolerances, seeds and sizes.

This module imports no JAX and nothing of scs_tpu: the test files hand it
the reference module they imported.
"""

import enum
import inspect
import sys
import types

import pytest
import torch

import scs_tpu_torch as port
from scs_tpu_torch import api, batch, bench_cli, info, io, native, polish

CPU = "cpu"
# one intra-op thread, as the port's other CPU test files run it
torch.set_num_threads(1)


def _cpu(settings):
    settings.setdefault("device", CPU)
    return settings


class SCS(port.SCS):
    """scs_tpu_torch.SCS on the CPU unless `device` is given."""

    def __init__(self, data, cone, **settings):
        super().__init__(data, cone, **_cpu(settings))


class BatchedSCS(batch.BatchedSCS):
    """scs_tpu_torch.BatchedSCS on the CPU unless `device` is given."""

    def __init__(self, data, cone, **settings):
        super().__init__(data, cone, **_cpu(settings))


class Settings(port.Settings):
    """scs_tpu_torch.Settings whose from_kwargs defaults to the CPU."""

    @classmethod
    def from_kwargs(cls, **kwargs):
        return port.Settings.from_kwargs(**_cpu(kwargs))


def solve(data, cone, **settings):
    return port.solve(data, cone, **_cpu(settings))


def solve_batch(data, cone, **settings):
    return batch.solve_batch(data, cone, **_cpu(settings))


# module attributes a view leaves to the module object itself
_MACHINERY = {"__name__", "__spec__", "__loader__", "__path__", "__file__",
              "__package__", "__cached__", "__builtins__"}


def _view(name, real, **overrides):
    """A module named `name` holding `real`'s attributes, `overrides` in
    front of them."""
    mod = types.ModuleType(name, real.__doc__)
    mod.__dict__.update(
        {k: v for k, v in vars(real).items() if k not in _MACHINERY})
    mod.__dict__.update(overrides)
    return mod


BATCH = _view("scs_tpu.batch", batch, BatchedSCS=BatchedSCS,
              solve_batch=solve_batch)
SUBMODULES = {"api": api, "batch": BATCH, "bench_cli": bench_cli,
              "info": info, "io": io, "native": native, "polish": polish}
FACADE = _view("scs_tpu", port, SCS=SCS, BatchedSCS=BatchedSCS,
               Settings=Settings, solve=solve, solve_batch=solve_batch,
               **SUBMODULES)
# what `import scs_tpu...` answers while a reference case runs
MODULES = {"scs_tpu": FACADE,
           **{f"scs_tpu.{k}": v for k, v in SUBMODULES.items()}}


def _is_ref(name):
    return name == "scs_tpu" or name.startswith("scs_tpu.")


def _counterpart(value):
    """The facade's object for a reference module global or parametrize
    value, or None when it is not the reference package's."""
    if isinstance(value, enum.Enum):
        cls = _counterpart(type(value))
        return None if cls is None else cls[value.name]
    if isinstance(value, types.ModuleType):
        return MODULES[value.__name__] if _is_ref(value.__name__) else None
    owner = getattr(value, "__module__", None)
    if not isinstance(owner, str) or not _is_ref(owner):
        return None
    return getattr(MODULES[owner], value.__name__)


def _param_sets(fn):
    """[(kwargs, id, marks)] of `fn`'s own parametrize marks."""
    sets = [({}, [], [])]
    marks = getattr(fn, "pytestmark", [])
    # decorators apply bottom-up; pytest's ids read top-down
    for mark in reversed([m for m in marks if m.name == "parametrize"]):
        argnames, values = mark.args[0], mark.args[1]
        if isinstance(argnames, str):
            argnames = [a.strip() for a in argnames.split(",")]
        ids = mark.kwargs.get("ids")
        rows = []
        for i, v in enumerate(values):
            vmarks, vid = [], None
            if isinstance(v, type(pytest.param(None))):
                vmarks, vid, v = list(v.marks), v.id, v.values
                v = v if len(argnames) > 1 else v[0]
            vals = v if len(argnames) > 1 else (v,)
            if vid is None and ids is not None:
                vid = str(ids[i])
            if vid is None:
                vid = "-".join(
                    str(x) if isinstance(x, (int, float, str, bool)) else
                    f"{a}{i}" for a, x in zip(argnames, vals))
            rows.append((dict(zip(argnames, vals)), vid, vmarks))
        sets = [({**k0, **k1}, i0 + [i1], m0 + m1)
                for (k1, i1, m1) in rows for (k0, i0, m0) in sets]
    return sets


def ref_tests(module):
    """The names of `module`'s test functions, in file order."""
    fns = [(f.__code__.co_firstlineno, n) for n, f in vars(module).items()
           if n.startswith("test_") and inspect.isfunction(f)]
    return [n for _, n in sorted(fns)]


def _all_cases(module):
    """[(name, case id, kwargs, marks)] of every case of `module`."""
    out = []
    for name in ref_tests(module):
        fn = getattr(module, name)
        fn_marks = [m for m in getattr(fn, "pytestmark", [])
                    if m.name != "parametrize"]
        for kwargs, ids, marks in _param_sets(fn):
            cid = name + (f"[{'-'.join(ids)}]" if ids else "")
            out.append((name, cid, kwargs, fn_marks + marks))
    return out


def ref_case_ids(module, only=None, table=()):
    """The case ids ref_cases(module, only, table) selects. `only` and
    `table` hold test names or case ids."""
    cases = _all_cases(module)
    known = {n for n, *_ in cases} | {c for _, c, *_ in cases}
    missing = (set(only or ()) | set(table)) - known
    assert not missing, f"no such reference tests or cases: {sorted(missing)}"
    return [c for n, c, *_ in cases
            if (only is None or {n, c} & set(only)) and not {n, c} & set(table)]


def ref_cases(module, only=None, table=(), slow=()):
    """pytest params, one per case of `module`'s test functions: those
    named in `only` (default: all), less those in `table`; the cases named
    in `slow` join the slow tier. Each of the three holds test names or
    case ids."""
    chosen = set(ref_case_ids(module, only, table))
    return [pytest.param((name, kwargs), id=cid, marks=marks + (
                [pytest.mark.slow] if {name, cid} & set(slow) else []))
            for name, cid, kwargs, marks in _all_cases(module) if cid in chosen]


def rebind(module, monkeypatch):
    """Rebind `module`'s reference-package globals, and `sys.modules`'
    `scs_tpu` entries, to the facade until `monkeypatch` is undone."""
    for name, value in list(vars(module).items()):
        new = _counterpart(value)
        if new is not None:
            monkeypatch.setattr(module, name, new)
    for name, mod in MODULES.items():
        monkeypatch.setitem(sys.modules, name, mod)


def run_ref_case(module, case, monkeypatch, request):
    """Call one reference case against the port: its parametrize values,
    and every other argument from the fixture of that name."""
    name, kwargs = case
    fn = getattr(module, name)
    # values the reference package made at import (an enum member) too
    args = {k: _counterpart(v) or v for k, v in kwargs.items()}
    for p in inspect.signature(fn).parameters:
        if p not in args:
            args[p] = request.getfixturevalue(p)
    rebind(module, monkeypatch)
    fn(**args)


def count_calls(monkeypatch, owner, name):
    """Count the calls of owner.name until monkeypatch is undone."""
    calls = {"n": 0}
    real = getattr(owner, name)

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(owner, name, counting)
    return calls
