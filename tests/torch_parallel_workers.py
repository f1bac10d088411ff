"""The rank side of tests/test_torch_parallel.py: the cases of
tests/test_sharding.py (same data, same settings, same mesh sizes) and the
port's own checks, run on every rank of a gloo world on the CPU
(scs_tpu_torch.parallel.dryrun.spawn_world). Each case returns numpy data
to the test process, which holds it against scs_tpu's answers.

This module imports no JAX, so the spawned ranks never load it.
"""

import os
import time

import numpy as np
import torch
import torch.distributed as dist
from scipy import sparse as _sp

import oracle
from scs_tpu_torch.batch import BatchedSCS
from scs_tpu_torch.convert import sharded_mats_from_numpy, state_from_numpy
from scs_tpu_torch.parallel import (
    ShardedSCS,
    make_mesh,
    shard_batched_mats,
    sharded_batch_solve,
    sharded_cg_solve,
)
from scs_tpu_torch.parallel.comm import gather_rows
from scs_tpu_torch.parallel.dryrun import legs

CPU = dict(device="cpu")
SLOW = os.environ.get("SCS_TPU_SLOW") == "1"


# -- data (tests/test_sharding.py's, bit for bit) ------------------------------


def cg_data(with_P):
    """(A, dy, rhs, P) of test_sharded_cg_matches_dense / _with_P."""
    if not with_P:
        rng = np.random.RandomState(0)
        m, n = 64, 24
        A = rng.randn(m, n)
        dy = np.abs(rng.randn(m)) + 0.5
        return A, dy, rng.randn(n), None
    rng = np.random.RandomState(1)
    m, n = 40, 16
    A = rng.randn(m, n)
    G = rng.randn(n, n)
    P = 0.1 * G @ G.T
    dy = np.abs(rng.randn(m)) + 0.5
    return A, dy, rng.randn(n), P


def batch_data():
    K = {"l": 10}
    rng = np.random.RandomState(3)
    As, bs, cs, stars = [], [], [], []
    for _ in range(8):
        data, p_star, _ = oracle.gen_feasible(K, n=6, density=0.8, rng=rng)
        As.append(np.asarray(data["A"].todense()))
        bs.append(data["b"])
        cs.append(data["c"])
        stars.append(p_star)
    return K, np.stack(As), np.stack(bs), np.stack(cs), np.array(stars)


def one_problem_data():
    K = {"z": 3, "l": 20, "q": [4, 3]}  # m = 30, pads to 32
    data, p_star, _ = oracle.gen_feasible(K, n=12, density=0.9, rng=np.random.RandomState(7))
    return K, data, p_star


def warm_data():
    K = {"l": 22}  # pads to 24
    data, p_star, _ = oracle.gen_feasible(K, n=10, density=0.9, rng=np.random.RandomState(11))
    return K, data, p_star


def infeasible_data():
    A = _sp.csc_matrix(np.array([[1.0], [-1.0], [0.5], [0.2]]))
    b_bad = np.array([-1.0, -1.0, 2.0, 2.0])  # x<=-1 and x>=1: infeasible
    return {"A": A, "b": b_bad, "c": np.array([1.0])}, np.array([1.0, 0.0, 2.0, 2.0])


def blocky_lp(m, n, seed=0):
    """tests/test_sharding.py::_blocky_lp."""
    rng = np.random.RandomState(seed)
    A = _sp.random(m, n, density=0.3, random_state=rng, format="csc")
    A.data = rng.randn(A.nnz)
    A = (A + _sp.eye(m, n, format="csc")).tocsc()
    x0 = rng.randn(n)
    s = np.abs(rng.randn(m))
    b = A @ x0 + s
    y = np.abs(rng.randn(m))
    c = -(A.T @ y)
    return {"A": A, "b": b, "c": c}


def bell_qp_data():
    rng = np.random.RandomState(3)
    m, n = 40, 18
    A = _sp.random(m, n, density=0.3, random_state=rng, format="csc")
    A.data = rng.randn(A.nnz)
    A = (A + _sp.eye(m, n, format="csc")).tocsc()
    x0 = rng.randn(n)
    b = A @ x0 + np.abs(rng.randn(m))
    c = -(A.T @ np.abs(rng.randn(m)))
    G = rng.randn(n, 4)
    P = _sp.csc_matrix(np.triu(G @ G.T * 0.1 + 1e-3 * np.eye(n)))
    return {"A": A, "b": b, "c": c, "P": P}


EPS6 = dict(eps_abs=1e-6, eps_rel=1e-6, verbose=False, max_iters=20000)
BELL = dict(solver_strategy="bell", bell_block_size=4, verbose=False, max_iters=20000)


# -- what a rank reports --------------------------------------------------------


def _sol(sol):
    info = sol["info"]
    return dict(x=sol["x"], y=sol["y"], s=sol["s"], status=info["status"],
                pobj=info["pobj"], iter=info["iter"])


def _shapes(solver):
    """The operator shapes this rank's device holds."""
    mats = solver.mats
    if mats.bell is not None:
        out = {f: tuple(getattr(mats.bell, f).shape) for f in ("A_blocks", "At_blocks")}
        if mats.pbell is not None:
            out["P_blocks"] = tuple(mats.pbell.blocks.shape)
        return out
    return {"A": tuple(mats.A.shape)}


# -- the cases --------------------------------------------------------------------


def case_devices():
    mesh = make_mesh(axis_name="rows")
    return dict(world=dist.get_world_size(), mesh=mesh.size(), ndim=mesh.ndim,
                names=mesh.mesh_dim_names)


def case_cg(with_P):
    A, dy, rhs, P = cg_data(with_P)
    x, k = sharded_cg_solve(A, dy, rhs, make_mesh(axis_name="rows"), P_mat=P,
                            rho_x=1e-6, tol=1e-12, max_iters=2000, device="cpu")
    return dict(x=x.numpy(), k=k)


def case_cg_default_device():
    """sharded_cg_solve with no device argument on a host A: where x lands,
    or what rank_device raised."""
    A, dy, rhs, _ = cg_data(False)
    try:
        x, _ = sharded_cg_solve(A, dy, rhs, make_mesh(axis_name="rows"), max_iters=5)
    except RuntimeError as e:
        return dict(raised=str(e))
    return dict(device=str(x.device))


def case_batch():
    K, A, b, c, _ = batch_data()
    solver = BatchedSCS({"A": A, "b": b, "c": c}, K, eps_abs=1e-6, eps_rel=1e-6, **CPU)
    mesh = make_mesh(axis_name="batch")
    mats = shard_batched_mats(solver.mats, mesh)
    states = sharded_batch_solve(solver.core, mats, mesh)
    return dict(status=states.status.numpy(), pobj=states.diag.pobj.numpy(),
                it=states.it.numpy(), local_B=int(mats.bn.shape[0]))


def case_one_problem():
    K, data, _ = one_problem_data()
    solver = ShardedSCS(dict(data), dict(K), mesh=make_mesh(axis_name="rows"), **EPS6, **CPU)
    out = _sol(solver.solve())
    out["shapes"] = _shapes(solver)
    return out


def case_update_and_warm_start():
    K, data, _ = warm_data()
    solver = ShardedSCS(dict(data), dict(K), mesh=make_mesh(axis_name="rows"), **EPS6, **CPU)
    sol = _sol(solver.solve())
    sol2 = _sol(solver.solve(warm_start=True))
    solver.update(b=1.05 * data["b"])
    sol3 = _sol(solver.solve())
    return dict(first=sol, warm=sol2, updated=sol3)


def case_infeasible():
    data, b_good = infeasible_data()
    solver = ShardedSCS(data, {"l": 4}, mesh=make_mesh(4, axis_name="rows"),
                        verbose=False, dtype="float32", **CPU)
    s1 = _sol(solver.solve())
    solver.update(b=b_good)
    s2 = _sol(solver.solve(warm_start=False))
    return dict(first=s1, updated=s2, shapes=_shapes(solver))


def case_bell_lp():
    d = blocky_lp(24, 10, seed=3)
    solver = ShardedSCS(dict(d), {"l": 24}, mesh=make_mesh(4, axis_name="rows"),
                        eps_abs=1e-6, eps_rel=1e-6, **BELL, **CPU)
    out = _sol(solver.solve(warm_start=False))
    out["shapes"] = _shapes(solver)
    return out


def case_bell_update_b():
    d = blocky_lp(16, 8, seed=5)
    solver = ShardedSCS(dict(d), {"l": 16}, mesh=make_mesh(4, axis_name="rows"), **BELL, **CPU)
    s1 = _sol(solver.solve(warm_start=False))
    solver.update(b=d["b"] * 1.5)
    s2 = _sol(solver.solve(warm_start=False))
    return dict(first=s1, updated=s2)


def case_bell_qp():
    d = bell_qp_data()
    solver = ShardedSCS(dict(d), {"l": 40}, mesh=make_mesh(4, axis_name="rows"),
                        eps_abs=1e-6, eps_rel=1e-6, **BELL, **CPU)
    out = _sol(solver.solve(warm_start=False))
    out["shapes"] = _shapes(solver)
    return out


def case_raises():
    """scs_tpu's raises, with its messages."""
    d = blocky_lp(24, 10, seed=3)
    world = dist.get_world_size()
    mesh2 = torch.distributed.device_mesh.DeviceMesh(
        "cpu", np.arange(world).reshape(2, world // 2).tolist(), mesh_dim_names=("a", "b")
    )
    mesh = make_mesh(axis_name="rows")
    out = {}
    for label, kw in (
        ("2-D mesh", dict(mesh=mesh2)),
        ("direct", dict(mesh=mesh, solver_strategy="direct")),
        ("always on bell", dict(mesh=mesh, solver_strategy="bell", bell_block_size=4,
                                phase_timing="always")),
    ):
        try:
            ShardedSCS(dict(d), {"l": 24}, verbose=False, **kw, **CPU)
            out[label] = None
        except ValueError as e:
            out[label] = str(e)
    return out


def case_repeat_bits():
    """Two cold solves on one instance (tests/test_sharding.py's bell LP):
    x, y and s bit-equal between them (and, in the test process, between
    the ranks)."""
    d = blocky_lp(24, 10, seed=3)
    solver = ShardedSCS(dict(d), {"l": 24}, mesh=make_mesh(axis_name="rows"),
                        eps_abs=1e-6, eps_rel=1e-6, **BELL, **CPU)
    return dict(first=_sol(solver.solve(warm_start=False)),
                second=_sol(solver.solve(warm_start=False)))


def case_aty_hi(m=4000, n=300, seed=17):
    """The compensated A'y of the sharded dense core in f32 (high-accuracy
    mode: eps 1e-6), against the f64 product of the same f32 A and y."""
    rng = np.random.RandomState(seed)
    A = _sp.csc_matrix(rng.randn(m, n))
    b = A @ rng.randn(n) + np.abs(rng.randn(m))
    c = -(A.T @ np.abs(rng.randn(m)))
    solver = ShardedSCS({"A": A, "b": b, "c": c}, {"l": m}, mesh=make_mesh(axis_name="rows"),
                        eps_abs=1e-6, eps_rel=1e-6, verbose=False, dtype="float32", **CPU)
    core, mats = solver.core, solver.mats
    y = torch.as_tensor(rng.randn(solver.m), dtype=torch.float32)
    A_full = gather_rows(mats.A, core.group).double()  # the test's reference only
    exact = A_full.T @ y.double()

    def rel(v):
        return float(torch.linalg.vector_norm(v.double() - exact) / torch.linalg.vector_norm(exact))

    return dict(hi_acc=core.hi_acc, rel_hi=rel(core._ATy_hi(mats, y)), rel_plain=rel(core._ATy(mats, y)),
                local_rows=int(mats.A.shape[0]), m=solver.m)


def case_time_limit():
    """A solve that cannot finish before its time limit returns on every
    rank after the same iteration (rank 0's clock decides)."""
    K, data, _ = one_problem_data()
    solver = ShardedSCS(dict(data), dict(K), mesh=make_mesh(axis_name="rows"),
                        eps_abs=1e-14, eps_rel=1e-14, max_iters=10**7, check_interval=5,
                        time_limit_secs=0.3, verbose=False, **CPU)
    t0 = time.perf_counter()
    sol = solver.solve()
    return dict(iter=sol["info"]["iter"], status=sol["info"]["status"],
                secs=time.perf_counter() - t0, x=sol["x"])


def case_core_from_converted(mats_np, state_np, K, data, settings, n_dev):
    """One chunk of the port's sharded core from scs_tpu's sharded Mats and
    cold-start State, carried across by convert.py."""
    solver = ShardedSCS(dict(data), dict(K), mesh=make_mesh(n_dev, axis_name="rows"),
                        **settings, **CPU)
    rank = dist.get_rank()
    mats = sharded_mats_from_numpy(mats_np, rank, n_dev)
    state = state_from_numpy(state_np)
    out = solver.core._chunk(state, mats)
    return dict(w=out.w.numpy(), it=out.it, cg_iters=out.cg_iters,
                A_rows=None if mats.A is None else int(mats.A.shape[0]))


CASES = {
    "devices": case_devices,
    "cg": lambda: case_cg(False),
    "cg_P": lambda: case_cg(True),
    "batch": case_batch,
    "one_problem": case_one_problem,
    "update_and_warm_start": case_update_and_warm_start,
    "infeasible": case_infeasible,
    "bell_lp": case_bell_lp,
    "bell_update_b": case_bell_update_b,
    "bell_qp": case_bell_qp,
    "raises": case_raises,
    "repeat_bits": case_repeat_bits,
    "aty_hi": case_aty_hi,
    "time_limit": case_time_limit,
    "cg_default_device": case_cg_default_device,
    "dryrun": lambda: legs("cpu"),
}


def run_cases(names, extra=()):
    """Run the named cases (and `extra`: (name, function, args) triples) on
    this rank; a case that raises is reported as its error, so the other
    cases still report."""
    out = {}
    todo = [(name, CASES[name], ()) for name in names] + list(extra)
    for name, fn, args in todo:
        try:
            out[name] = fn(*args)
        except Exception as e:  # reported to the test process
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out
