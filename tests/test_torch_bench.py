"""The port's bench CLI (scs_tpu_torch/bench_cli.py) against scs_tpu's
(scs_tpu/bench_cli.py), on the CPU at tiny sizes.

Both CLIs print one JSON line with the same key set; at the same settings
their flagship passes solve the same problems (the host generator,
bit-equal) with the same counts. The tiny CLI runs set
BENCH_AA_LOOKBACK=0 in both: under AA at its default regularization the
iteration counts are chaotic (scs_tpu's own move from 200 / 350 to 250 /
300 under a 1e-15 change of b on this batch), so counts are compared
without it. The sub-metrics run at small sizes in both packages: the same
status and key set, and the high-accuracy cell's certification and
objective.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import scs_tpu.bench_cli as jcli
import scs_tpu_torch.bench_cli as tcli
from scs_tpu_torch.tools import flagship

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(
    BENCH_BATCH="4", BENCH_M="30", BENCH_N="20", BENCH_HOST_GEN="1",
    BENCH_DTYPE="float64", BENCH_CHUNKS="1", BENCH_SKIP_BELL="1",
    BENCH_SKIP_MIXED="1", BENCH_SKIP_HIACC="1", BENCH_SKIP_BELLBATCH="1",
)


@pytest.fixture
def bench_env(monkeypatch, tmp_path):
    """BENCH_DEVICE=cpu for the port, and scs_tpu's compile cache pointed at
    tmp_path, with JAX's two cache settings restored afterwards."""
    import jax

    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in names}
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    monkeypatch.setenv("BENCH_COMPILE_CACHE", str(tmp_path / "jax_cache"))
    yield monkeypatch
    for k, v in saved.items():
        jax.config.update(k, v)


def _one_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


def test_both_clis_tiny(bench_env, capsys):
    for k, v in TINY.items():
        bench_env.setenv(k, v)
    bench_env.setenv("BENCH_AA_LOOKBACK", "0")
    jcli.main()
    ref = _one_line(capsys)
    tcli.main()
    ours = _one_line(capsys)
    assert set(ours) == set(ref)
    for k in ("n_solved", "amortized_n_solved", "batch", "chunks", "mean_iters",
              "max_iters_seen", "metric", "matched_eps", "baseline_pps"):
        assert ours[k] == ref[k], k
    assert ours["n_solved"] == 4
    assert set(ours["setup_breakdown"]) == set(ref["setup_breakdown"])


def test_hi_acc_submetric_both(bench_env):
    ref = jcli._hi_acc_submetric(B=2, m=60, n=40)
    ours = tcli._hi_acc_submetric(B=2, m=60, n=40)
    assert set(ours) == set(ref)
    for out in (ref, ours):
        assert out["status"] == "solved" and out["n_certified"] == 2
        assert out["max_obj_rel_err_vs_f64"] < 1e-5


def test_bell_submetrics_both(bench_env):
    ref = jcli._bell_submetric(m=600, n=400)
    ours = tcli._bell_submetric(m=600, n=400)
    assert set(ours) == set(ref)
    assert ours["status"] == ref["status"] == "solved"
    assert ours["nnz"] == ref["nnz"] and ours["metric"] == ref["metric"]
    # smaller than the cell's generator test (700 x 500), which stops
    # before the solve: a bell batch costs ~50 ms an iteration on the CPU
    kw = dict(B=2, m=256, n=128, density=0.05, width=2)
    ref = jcli._bell_batch_submetric(**kw)
    ours = tcli._bell_batch_submetric(**kw)
    assert set(ours) == set(ref)
    assert ours["status"] == ref["status"] == "solved"
    for k in ("metric", "n_solved", "nnz_per_problem", "dense_batch_gb"):
        assert ours[k] == ref[k], k
    assert 0 <= ours["dense_vs_hbm"] < 1 and ours["pack_gb"] > 0


def test_bench_bell_cross_check(bench_env, capsys):
    bench_env.setenv("BENCH_BELL", "1")
    bench_env.setenv("BENCH_M", "600")
    bench_env.setenv("BENCH_N", "400")
    tcli.main()
    out = _one_line(capsys)
    assert out["status"] == "solved"
    assert out["cross_check_obj_gap"] < 1e-3
    assert out["unit"] == "seconds" and out["value"] == out["solve_secs"]


def test_cli_module_runs_in_a_subprocess(tmp_path):
    env = dict(os.environ, **TINY, BENCH_DEVICE="cpu", PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "scs_tpu_torch.bench_cli"],
                         capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0])["n_solved"] == 4
    assert "# solved 4/4" in out.stderr
    assert os.listdir(tmp_path) == []  # no BENCHMARK.json, no other file


def test_importing_the_bench_never_imports_jax():
    code = (
        "import sys\n"
        "import scs_tpu_torch.bench_cli\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or m == 'scs_tpu'"
        " or m.startswith(('jax.', 'scs_tpu.'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_gen_batch_device_recipe():
    A, P, b, c = tcli.gen_batch_device(3, 40, 24, seed=5, device="cpu")
    assert A.shape == (3, 40, 24) and P.shape == (3, 24, 24)
    assert b.shape == (3, 40) and c.shape == (3, 24)
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in (A, P, b, c))
    torch.testing.assert_close(P, P.mT, rtol=0, atol=0)
    assert float(torch.linalg.eigvalsh(P.double()).min()) > 0.9e-4
    # the same seed gives the same batch; another seed another batch
    again = tcli.gen_batch_device(3, 40, 24, seed=5, device="cpu")
    for x, y in zip((A, P, b, c), again):
        assert torch.equal(x, y)
    assert not torch.equal(A, tcli.gen_batch_device(3, 40, 24, seed=6, device="cpu")[0])
    # the host generator is the flagship module's, scs_tpu's bit for bit
    assert tcli.gen_batch is flagship.gen_batch
    for x, y in zip(tcli.gen_batch(2, 30, 20), jcli.gen_batch(2, 30, 20)):
        np.testing.assert_array_equal(x, y)
