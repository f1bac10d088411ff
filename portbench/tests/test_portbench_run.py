"""Whole runs, past the harness's look for a card: at a size the CPU
solves in a second, a sound run comes out correct, and the control (the
program's float32 path) and each planted fault come out not correct. The
command line refuses a machine with no card, and a directory that holds
the benchmark alone."""

import os
import shutil
import subprocess
import sys

import pytest

from portbench import faults, harness, reference, registry
from portbench.run import forbidden_modules

SEED = 2**31 + 101


def _correct(cfg, traffic, fault=None, override=None, seconds=0.0):
    if fault:
        with faults.planted(fault):
            run = harness.run_cell(cfg, traffic, SEED, seconds, device="cpu")
            nums = harness.check(run, 1e-4, 1e-4)
    else:
        run = harness.run_cell(cfg, traffic, SEED, seconds, device="cpu", override=override)
        nums = harness.check(run, 1e-4, 1e-4)
    ok, _ = reference.judge(nums, cfg["limits"])
    return ok, nums, run


def test_sound_run_is_correct(tiny_qp, tiny_traffic):
    ok, nums, run = _correct(tiny_qp, tiny_traffic, seconds=0.5)
    assert ok, nums
    assert run.solved == run.attempted >= 4 and len(run.batches) >= 1


def test_control_float32_is_not_correct(tiny_qp, tiny_traffic):
    ok, nums, _ = _correct(tiny_qp, tiny_traffic, override={"dtype": "float32"})
    assert not ok
    lim = tiny_qp["limits"]
    assert nums["report_obj"] > lim["report_obj"] or nums["report_res"] > lim["report_res"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_planted_fault_is_not_correct(tiny_qp, tiny_traffic, fault):
    ok, nums, _ = _correct(tiny_qp, tiny_traffic, fault=fault)
    assert not ok, nums


def test_faults_are_removed_after_use(tiny_qp, tiny_traffic):
    with faults.planted("unchanged"):
        pass
    ok, nums, _ = _correct(tiny_qp, tiny_traffic)
    assert ok, nums


def test_trace_run_reads_the_second_batch(tiny_qp, tiny_traffic):
    run = harness.run_cell(tiny_qp, tiny_traffic, SEED, 0.0, trace=True, device="cpu")
    assert len(run.batches) == 2 and [b.traced for b in run.batches] == [False, True]
    assert run.trace is not None and run.trace.iters == int(run.batches[1].iters.max())
    # no card: no device metric, no memory
    names = [(m["name"], m["unit"]) for m in registry.benchmark()["per_layer"]]
    got = harness.metrics(run, names)
    assert set(got) == {"batch_setup_share", "iters_per_problem", "lockstep_eff"}


def test_window_closes_at_first_batch_end_after_seconds(tiny_qp, tiny_traffic):
    run = harness.run_cell(tiny_qp, tiny_traffic, SEED, 1.0, device="cpu")
    ends = [sum(b.construct_s + b.solve_s for b in run.batches[: i + 1]) for i in range(len(run.batches))]
    assert run.window_s >= 1.0 and ends[-1] <= run.window_s
    assert len(run.batches) == 1 or ends[-2] < 1.0


def test_top_level_names_compared_whole():
    assert forbidden_modules(["scs_tpu_torch", "scs_tpu_torch.batch", "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["scs_tpu.solver", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "scs_tpu"]


def test_a_run_loads_no_jax(tiny_qp):
    """In a fresh process, a whole run on the CPU and its check leave no
    module of JAX or of the JAX package loaded."""
    code = (
        "import copy, json\n"
        "from portbench import harness, registry\n"
        "from portbench.run import forbidden_modules\n"
        "cfg = copy.deepcopy(registry.config(registry.benchmark(), 'dense_qp'))\n"
        "cfg.update(m=30, n=20, cone={'l': 30})\n"
        "run = harness.run_cell(cfg, {'batch': 4, 'pool': 2, 'base_seed': 3, 'warmup_iters': 10}, 5, 0.0,"
        " trace=True, device='cpu')\n"
        "harness.check(run, 1e-4, 1e-4)\n"
        "print(json.dumps(forbidden_modules()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_command_refuses_without_a_card():
    if os.environ.get("CUDA_VISIBLE_DEVICES") is None:
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    else:
        env = dict(os.environ)
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "dense_qp.b512", "--seed", "1",
         "--seconds", "1"],
        cwd=registry.ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""


def test_command_refuses_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(registry.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "dense_qp.b512", "--seed", "1",
         "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "scs_tpu_torch" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("override", [None, {"dtype": "float32"}], ids=["float64", "float32"])
def test_card_run_and_control(card, tiny_qp, override):
    """On the card at a small size: the configuration's float64 is correct,
    its float32 path is not."""
    tiny_qp.update(m=300, n=200, cone={"l": 300})
    run = harness.run_cell(tiny_qp, {"batch": 64, "pool": 2, "base_seed": 3, "warmup_iters": 10}, SEED, 1.0,
                           device=card, override=override)
    ok, _ = reference.judge(harness.check(run, 1e-4, 1e-4), tiny_qp["limits"])
    assert ok is (override is None)


def test_every_seed_runs_the_same_work(tiny_qp):
    """Two seeds give each batch other bits (some variables negated) and
    the same iterations, objectives and answer sizes, bit for bit."""
    import numpy as np
    import torch
    from scs_tpu_torch import BatchedSCS

    traffic = {"batch": 6, "pool": 1, "base_seed": 3, "warmup_iters": 10}
    got = []
    for seed in (11, SEED):
        e = harness.make_pool(tiny_qp, traffic, seed, torch.device("cpu"))[0]
        got.append(e["data"]["A"].clone())
        res = BatchedSCS(e["data"], e["cone"], **harness.settings_of(tiny_qp, traffic, "cpu")).solve()
        got.append([(r["info"]["iter"], r["info"]["pobj"], np.abs(r["x"]).tolist()) for r in res])
    assert not torch.equal(got[0], got[2]) and torch.equal(got[0].abs(), got[2].abs())
    assert got[1] == got[3]


def test_fresh_batch_follows_the_seed(tiny_qp, tiny_traffic):
    """The batch `check` draws after the window comes from the run's seed:
    the same for one seed, other problems for another."""
    import torch

    got = []
    for seed in (11, 11, SEED):
        run = harness.run_cell(tiny_qp, tiny_traffic, seed, 0.0, device="cpu")
        entry, res = harness.fresh_batch(run, torch.device("cpu"))
        assert len(res) == tiny_traffic["batch"]
        got.append(entry["data"]["A"])
    assert torch.equal(got[0], got[1]) and not torch.equal(got[0].abs(), got[2].abs())
