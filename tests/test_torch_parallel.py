"""scs_tpu_torch.parallel against scs_tpu.parallel, on the CPU.

The port's sharded paths run in gloo worlds of spawned processes
(scs_tpu_torch.parallel.dryrun.spawn_world), one world for each mesh size
of tests/test_sharding.py: 8 where its `make_mesh()` is unsized, 4 where it
says 4. Each world runs its cases once (module-scoped fixtures, the rank
side in tests/torch_parallel_workers.py, which imports no JAX) and reports
every rank's answers; scs_tpu's are computed here, on the 8-device virtual
CPU mesh of tests/conftest.py. Every world is joined with a timeout, so a
deadlock fails its tests instead of hanging the suite.

Tolerances, f64 unless the scs_tpu test says otherwise:
  * the sharded CG: x to rtol 1e-8 of scs_tpu's, iterations within 1;
  * the sharded batch: every problem solved, pobj to 1e-6 relative;
  * ShardedSCS: the same status, pobj to 1e-6 relative, x to rtol 1e-5 of
    its largest entry, y and s of the unpadded length (the f32 infeasible-then-feasible case,
    whose optimum is 0 at x = 0: pobj and x to its eps, 1e-4, absolutely);
  * every rank's answers bit-equal to rank 0's, a repeated solve bit-equal
    to the first (the fixed-order sums of parallel/comm.py);
  * the compensated A'y of the sharded dense core in f32 within 5e-7 of the
    f64 product (D1's gate), the partials summed in f64.
"""

import fcntl
import os
import pickle
import sys

import numpy as np
import pytest
import torch
from scipy import sparse as _sp

import jax

import scs_tpu as scs
import scs_tpu.ops.sparse as jsp
import scs_tpu_torch.ops.sparse as tsp
from scs_tpu.batch import BatchedSCS as JBatchedSCS
from scs_tpu.parallel import (
    ShardedSCS as JShardedSCS,
    make_mesh as jmake_mesh,
    shard_batched_mats as jshard_batched_mats,
    sharded_batch_solve as jsharded_batch_solve,
    sharded_cg_solve as jsharded_cg_solve,
)
from scs_tpu_torch.parallel.dryrun import World, check_ranks_agree, spawn_world

import torch_parallel_workers as W

WORLD_TIMEOUT = 300.0  # seconds for a whole world, spawn included
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORLD8_CASES = ["devices", "cg", "cg_P", "batch", "one_problem"] + (
    ["update_and_warm_start"] if W.SLOW else []
)
WORLD4_CASES = [
    "devices", "infeasible", "bell_lp", "bell_update_b", "bell_qp", "raises", "aty_hi",
    "time_limit", "repeat_bits", "cg_default_device", "dryrun",
]

# one chunk from scs_tpu's sharded Mats and cold state (stabilising
# settings of tests/test_torch_core.py: every CG solve to its floor, AA
# regularization 1e-4)
STABLE = dict(verbose=False, cg_tol_factor=1e-12, acceleration_regularization=1e-4,
              check_interval=10, eps_abs=1e-7, eps_rel=1e-7)
CONVERTED = {
    "core_bell": (W.bell_qp_data, {"l": 40}, dict(STABLE, solver_strategy="bell", bell_block_size=4)),
    "core_dense": (lambda: W.one_problem_data()[1], W.one_problem_data()[0], dict(STABLE)),
}


def _jax_chunk(label):
    """scs_tpu's sharded solver on a 4-device mesh: its Mats and cold state
    as numpy, and the w of one chunk from that state."""
    gen, K, settings = CONVERTED[label]
    data = gen()
    solver = JShardedSCS(dict(data), dict(K), mesh=jmake_mesh(4, axis_name="rows"), **settings)
    with solver.mesh:
        out = solver.core._jit_chunk(solver._state0, solver.mats)
    to_np = jax.tree.map(np.asarray, (solver.mats, solver._state0))
    return data, K, settings, to_np, np.asarray(out.w), int(out.it)


def _run_worlds():
    """The world of 8 runs while scs_tpu computes the converted cases'
    references here; the world of 4, which needs them, starts when the
    world of 8 is done."""
    w8 = World(8, W.run_cases, (WORLD8_CASES,), timeout=WORLD_TIMEOUT)
    chunks = {label: _jax_chunk(label) for label in CONVERTED}
    extra = [
        (label, W.case_core_from_converted, (to_np[0], to_np[1], K, data, settings, 4))
        for label, (data, K, settings, to_np, _, _) in chunks.items()
    ]
    res8 = w8.wait()
    res4 = World(4, W.run_cases, (WORLD4_CASES, extra), timeout=WORLD_TIMEOUT).wait()
    return {"world8": res8, "world4": res4, "chunks": chunks}


@pytest.fixture(scope="module")
def worlds(request, tmp_path_factory):
    """The worlds' results, computed once per pytest run: under xdist the
    first worker to get here runs the worlds behind a file lock in the
    run's shared temporary directory and leaves the results there for the
    others, so however the module's tests are spread over workers, at most
    12 ranks run at once."""
    if not hasattr(request.config, "workerinput"):  # no xdist worker: this process alone
        return _run_worlds()
    shared = tmp_path_factory.getbasetemp().parent
    done = shared / "torch_parallel_worlds.pkl"
    with open(shared / "torch_parallel_worlds.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if done.exists():
            return pickle.loads(done.read_bytes())
        res = _run_worlds()
        done.write_bytes(pickle.dumps(res))
        return res


@pytest.fixture(scope="module")
def jax_chunks(worlds):
    return worlds["chunks"]


@pytest.fixture(scope="module")
def world8(worlds):
    return worlds["world8"]


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds["world4"]


def ranks(world, case):
    """Every rank's result of `case`; fails on a rank that raised."""
    res = [r[case] for r in world]
    for rank, r in enumerate(res):
        if isinstance(r, dict) and "error" in r:
            pytest.fail(f"rank {rank}, case {case}: {r['error']}")
    return res


def assert_ranks_bit_equal(res, keys=("x", "y", "s")):
    for rank, r in enumerate(res[1:], 1):
        for k in keys:
            assert np.array_equal(r[k], res[0][k], equal_nan=True), f"rank {rank} differs in {k}"


def assert_matches(port, ref, m=None):
    """ShardedSCS against scs_tpu's ShardedSCS on the same problem: x to
    rtol 1e-5 of its largest entry (scs_tpu's own x moves by 9e-6 of it on
    the bell QP between a 1-device and an 8-device CPU backend)."""
    info = ref["info"]
    assert port["status"] == info["status"]
    np.testing.assert_allclose(port["pobj"], info["pobj"], rtol=1e-6, atol=1e-12)
    scale = np.abs(ref["x"]).max()
    np.testing.assert_allclose(port["x"], ref["x"], rtol=1e-5, atol=1e-5 * scale)
    if m is not None:
        assert port["y"].shape == (m,) and port["s"].shape == (m,)


# -- the cases of tests/test_sharding.py --------------------------------------------


@pytest.mark.parametrize("case", ["cg", "cg_P"])
def test_sharded_cg_matches_scs_tpu(world8, case):
    """test_sharded_cg_matches_dense / test_sharded_cg_with_P: x to rtol
    1e-8 of scs_tpu's sharded CG, iterations within 1, and the dense
    solve's answer as scs_tpu's test holds it."""
    A, dy, rhs, P = W.cg_data(case == "cg_P")
    xj, kj = jsharded_cg_solve(
        jax.numpy.asarray(A), jax.numpy.asarray(dy), jax.numpy.asarray(rhs),
        jmake_mesh(axis_name="rows"), P_mat=None if P is None else jax.numpy.asarray(P),
        rho_x=1e-6, tol=1e-12, max_iters=2000,
    )
    res = ranks(world8, case)
    assert_ranks_bit_equal(res, ("x",))
    S = 1e-6 * np.eye(A.shape[1]) + A.T @ (dy[:, None] * A) + (0 if P is None else P)
    for r in res:
        np.testing.assert_allclose(r["x"], np.asarray(xj), rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(r["x"], np.linalg.solve(S, rhs), rtol=1e-6, atol=1e-8)
        assert abs(r["k"] - kj) <= 1 and r["k"] > 0


def test_sharded_batch_solve(world8):
    """8 problems over 8 ranks, one each: all solved, pobj to 1e-6 of
    scs_tpu's sharded batch (and to 3 decimals of the planted optima)."""
    K, A, b, c, stars = W.batch_data()
    solver = JBatchedSCS({"A": A, "b": b, "c": c}, K, eps_abs=1e-6, eps_rel=1e-6)
    mesh = jmake_mesh(axis_name="batch")
    states = jsharded_batch_solve(solver.core, jshard_batched_mats(solver.mats, mesh), mesh)
    ref = np.asarray(states.diag.pobj)
    res = ranks(world8, "batch")
    for r in res:
        assert r["local_B"] == 1
        assert np.all(r["status"] == 1), r["status"]
        np.testing.assert_allclose(r["pobj"], ref, rtol=1e-6, atol=1e-12)
        np.testing.assert_almost_equal(r["pobj"], stars, decimal=3)
        assert np.array_equal(r["pobj"], res[0]["pobj"])


def test_sharded_scs_solves_one_problem(world8):
    """K = z + l + two SOCs, m = 30 (padded to 32 over 8 ranks)."""
    K, data, p_star = W.one_problem_data()
    ref = JShardedSCS(dict(data), dict(K), mesh=jmake_mesh(axis_name="rows"), **W.EPS6).solve()
    res = ranks(world8, "one_problem")
    assert_ranks_bit_equal(res)
    for r in res:
        assert_matches(r, ref, m=30)
        assert r["status"] == "solved"
        np.testing.assert_almost_equal(r["pobj"], p_star, decimal=4)


def test_devices_available(world8, world4):
    for world, n in ((world8, 8), (world4, 4)):
        for r in ranks(world, "devices"):
            assert r["world"] == n and r["mesh"] == n and r["ndim"] == 1
            assert tuple(r["names"]) == ("rows",)


@pytest.mark.slow
def test_sharded_scs_update_and_warm_start(world8):
    K, data, p_star = W.warm_data()
    solver = JShardedSCS(dict(data), dict(K), mesh=jmake_mesh(axis_name="rows"), **W.EPS6)
    refs = [solver.solve(), solver.solve(warm_start=True)]
    solver.update(b=1.05 * data["b"])
    refs.append(solver.solve())
    res = ranks(world8, "update_and_warm_start")
    for r in res:
        for key, ref in zip(("first", "warm", "updated"), refs):
            assert_matches(r[key], ref, m=22)
            assert r[key]["status"] == "solved"
        assert r["warm"]["iter"] <= r["first"]["iter"]
        np.testing.assert_almost_equal(r["first"]["pobj"], p_star, decimal=4)


def test_sharded_infeasible_update_feasible(world4):
    """f32, as scs_tpu's test: infeasible, then update(b) to feasible on the
    same sharded workspace."""
    data, b_good = W.infeasible_data()
    solver = JShardedSCS(dict(data), {"l": 4}, mesh=jmake_mesh(4, axis_name="rows"),
                         verbose=False, dtype="float32")
    refs = [solver.solve()]
    solver.update(b=b_good)
    refs.append(solver.solve(warm_start=False))
    res = ranks(world4, "infeasible")
    for r in res:
        assert r["first"]["status"] == "infeasible" == refs[0]["info"]["status"]
        assert r["updated"]["status"] == "solved" == refs[1]["info"]["status"]
        # f32 at the default eps 1e-4, and an optimum of 0 (x = 0): the two
        # packages agree to eps, absolutely
        np.testing.assert_allclose(r["updated"]["pobj"], refs[1]["info"]["pobj"], rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(r["updated"]["x"], refs[1]["x"], rtol=1e-5, atol=1e-4)
        assert len(r["updated"]["y"]) == 4 and len(r["updated"]["s"]) == 4
    assert_ranks_bit_equal([r["updated"] for r in res])


def _kkt_ok(d, sol):
    x, y, s = sol["x"], sol["y"], sol["s"]
    A = d["A"].toarray()
    P = d.get("P")
    Px = 0 if P is None else (P + P.T - _sp.diags(P.diagonal())) @ x
    assert np.linalg.norm(A @ x + s - d["b"]) < 1e-3 * (1 + np.linalg.norm(d["b"]))
    assert np.linalg.norm(Px + A.T @ y + d["c"]) < 1e-3 * (1 + np.linalg.norm(d["c"]))


def test_sharded_bell_matches_unsharded(world4):
    d = W.blocky_lp(24, 10, seed=3)
    ref = JShardedSCS(dict(d), {"l": 24}, mesh=jmake_mesh(4, axis_name="rows"),
                      eps_abs=1e-6, eps_rel=1e-6, **W.BELL).solve(warm_start=False)
    direct = scs.solve(dict(d), {"l": 24}, solver_strategy="direct", verbose=False,
                       eps_abs=1e-6, eps_rel=1e-6, max_iters=20000)
    res = ranks(world4, "bell_lp")
    assert_ranks_bit_equal(res)
    for r in res:
        assert_matches(r, ref, m=24)
        np.testing.assert_allclose(r["pobj"], direct["info"]["pobj"], rtol=1e-3, atol=1e-4)
        _kkt_ok(d, r)


def test_sharded_bell_update_b(world4):
    d = W.blocky_lp(16, 8, seed=5)
    solver = JShardedSCS(dict(d), {"l": 16}, mesh=jmake_mesh(4, axis_name="rows"), **W.BELL)
    refs = [solver.solve(warm_start=False)]
    solver.update(b=d["b"] * 1.5)
    refs.append(solver.solve(warm_start=False))
    for r in ranks(world4, "bell_update_b"):
        for key, ref in zip(("first", "updated"), refs):
            assert_matches(r[key], ref, m=16)
            assert r[key]["status"] == "solved"
        assert abs(r["first"]["pobj"] - r["updated"]["pobj"]) > 1e-10


def test_sharded_bell_qp_matches_unsharded(world4):
    d = W.bell_qp_data()
    ref = JShardedSCS(dict(d), {"l": 40}, mesh=jmake_mesh(4, axis_name="rows"),
                      eps_abs=1e-6, eps_rel=1e-6, **W.BELL).solve(warm_start=False)
    direct = scs.solve(dict(d), {"l": 40}, solver_strategy="direct", verbose=False,
                       eps_abs=1e-6, eps_rel=1e-6, max_iters=20000)
    res = ranks(world4, "bell_qp")
    assert_ranks_bit_equal(res)
    for r in res:
        assert_matches(r, ref, m=40)
        np.testing.assert_allclose(r["pobj"], direct["info"]["pobj"], rtol=1e-3, atol=1e-4)
        _kkt_ok(d, r)


# -- the port's own checks ----------------------------------------------------------


@pytest.mark.parametrize("n_dev,bs,dtype", [(4, 4, "float32"), (8, 4, "float64"), (2, 8, "float32")])
def test_sharded_packers_bit_equal_to_scs_tpu(n_dev, bs, dtype):
    """pack_bell_sharded and pack_bell_sym_sharded: the host arrays of
    scs_tpu's, bit for bit (widths padded to the widest rank, colsq_all
    summed over the slices)."""
    rng = np.random.RandomState(n_dev)
    m = n_dev * bs * 3
    A = _sp.random(m, 37, density=0.2, random_state=rng, format="csc")
    A.data = rng.randn(A.nnz)
    P = (A.T @ A).tocsc()
    jdt = {"float32": jax.numpy.float32, "float64": jax.numpy.float64}[dtype]
    tdt = {"float32": torch.float32, "float64": torch.float64}[dtype]
    ours = tsp.pack_bell_sharded(A, n_dev, bs, tdt) + tuple(tsp.pack_bell_sym_sharded(P, n_dev, bs, tdt))
    theirs = jsp.pack_bell_sharded(A, n_dev, bs, jdt) + tuple(jsp.pack_bell_sym_sharded(P, n_dev, bs, jdt))
    for a, b in zip(ours, theirs):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    blocks, cols = tsp.place_bell_shard(ours[0], ours[1], n_dev - 1, ours[2].shape[1], "cpu")
    assert blocks.shape == ours[0].shape[1:] and cols.dtype == torch.int32


def test_each_rank_holds_only_its_slice(world8, world4):
    """No rank's device holds the whole dense A or the whole bell pack."""
    for r in ranks(world8, "one_problem"):
        assert r["shapes"] == {"A": (32 // 8, 12)}
    for r in ranks(world4, "infeasible"):
        assert r["shapes"] == {"A": (1, 1)}
    for case, m_pad in (("bell_lp", 32), ("bell_qp", 48)):
        for r in ranks(world4, case):
            nbr_loc = m_pad // 4 // 4  # 4 ranks, bs 4
            assert r["shapes"]["A_blocks"][0] == nbr_loc
            if case == "bell_qp":
                assert r["shapes"]["P_blocks"][0] == 32 // 4 // 4  # n = 18 pads to 32


def test_ranks_bit_equal_and_solve_repeats(world4):
    res = ranks(world4, "repeat_bits")
    assert_ranks_bit_equal([r["first"] for r in res])
    for r in res:
        assert r["first"]["iter"] == r["second"]["iter"]
        for k in ("x", "y", "s"):
            assert np.array_equal(r["first"][k], r["second"][k])


def test_scs_tpu_raises(world4):
    """A 2-D mesh, "direct", phase_timing="always" on bell: scs_tpu's
    ValueErrors, with its messages."""
    for r in ranks(world4, "raises"):
        assert r["2-D mesh"] == "ShardedSCS expects a 1-D mesh"
        assert r["direct"] == "ShardedSCS requires solver_strategy='indirect' or 'bell'"
        assert r["always on bell"] == (
            "phase_timing='always' is not supported on the sharded bell path"
        )


def test_compensated_aty_across_four_ranks_meets_d1_gate(world4):
    res = ranks(world4, "aty_hi")
    for r in res:
        assert r["hi_acc"] and r["local_rows"] == r["m"] // 4
        assert r["rel_hi"] <= 5e-7, r
    assert len({r["rel_hi"] for r in res}) == 1


def test_time_limit_returns_on_every_rank(world4):
    """time_limit_secs: rank 0's clock decides, so every rank stops after
    the same iteration, near the limit."""
    res = ranks(world4, "time_limit")
    assert len({r["iter"] for r in res}) == 1
    assert_ranks_bit_equal(res, ("x",))
    for r in res:
        assert r["status"] in ("solved_inaccurate", "infeasible_inaccurate", "unbounded_inaccurate")
        assert 0.3 <= r["secs"] < 30.0


@pytest.mark.parametrize("label", sorted(CONVERTED))
def test_core_chunk_from_converted_mats(world4, jax_chunks, label):
    """One chunk of the port's sharded core (bell with P; dense) from scs_tpu's
    sharded Mats and cold state (convert.sharded_mats_from_numpy) agrees
    with scs_tpu's chunk to rtol 1e-10, on every rank, bit-equal between
    ranks."""
    w_ref, it_ref = jax_chunks[label][4], jax_chunks[label][5]
    res = ranks(world4, label)
    for r in res:
        assert r["it"] == it_ref
        np.testing.assert_allclose(r["w"], w_ref, rtol=1e-10, atol=1e-10 * np.abs(w_ref).max())
        assert np.array_equal(r["w"], res[0]["w"])
    if label == "core_dense":
        assert all(r["A_rows"] == 32 // 4 for r in res)


def test_sharded_cg_defaults_to_the_card(world4):
    """sharded_cg_solve on a host A with no device argument goes to this
    rank's card, or raises where there is none; it never falls back to the
    CPU."""
    for r in ranks(world4, "cg_default_device"):
        if torch.cuda.is_available():
            assert r["device"].startswith("cuda")
        else:
            assert "device" not in r and "no CUDA device" in r["raised"], r


def test_dryrun_world4(world4):
    """parallel/dryrun.py's four legs in the gloo world of 4: the batch to
    termination, the CG, the dense LP in f32 at eps 1e-5 (high accuracy),
    the bell QP; every rank's answers rank 0's bits."""
    res = ranks(world4, "dryrun")
    check_ranks_agree(res)
    r0 = res[0]
    assert all(st != 0 for st in r0["batch"]["statuses"])
    assert r0["dense"]["status"] == r0["bell"]["status"] == "solved"
    assert r0["dense"]["hi_acc"] and 0 < r0["cg"]["iters"] <= 200


# -- on the card: chip_smoke.py's phase 14 ---------------------------------------


@pytest.fixture
def chip_smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import importlib.util  # noqa: PLC0415

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    # registered under its name, so its rank functions pickle by reference
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_sharded_bell_lp_world1_nccl_on_card(chip_smoke):
    """Phase 14 (a): the bench's bell LP through ShardedSCS, one NCCL rank."""
    chip_smoke.phase_sharded_bell(1, "nccl", pobj_ref=None)


@pytest.mark.cuda
def test_sharded_bell_lp_and_dense_qp_world2_gloo_on_card(chip_smoke):
    """Phase 14 (b): the same LP over two gloo ranks on one card, then the
    sharded dense QP."""
    one = chip_smoke.phase_sharded_bell(1, "nccl", pobj_ref=None)
    chip_smoke.phase_sharded_bell(2, "gloo", pobj_ref=one["pobj"])
    chip_smoke.phase_sharded_dense(2)


@pytest.mark.cuda
def test_two_nccl_ranks_on_one_card_raise(chip_smoke):
    with pytest.raises(RuntimeError, match="failed"):
        spawn_world(2, chip_smoke.nccl_same_card, (), backend="nccl", timeout=120.0)
