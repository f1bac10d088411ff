"""The sharded paths end to end on small problems, in a world of N ranks —
the port of scs_tpu's `__graft_entry__.dryrun_multichip`, with its four
legs at its sizes and settings:

  1. the sharded batch: N dense QPs of 24 x 16 (one a rank), f32, eps 1e-4,
     solved to termination;
  2. the sharded CG on a (16 N) x 32 system, f32, tol 1e-4;
  3. the sharded dense LP of (8 N + 3) x 16 (rows not divisible: padding),
     f32 at eps 1e-5 (the high-accuracy mode), solved;
  4. the sharded bell QP of 24 x 10 with bell_block_size=4, f32, eps 1e-5,
     solved.

    python -m scs_tpu_torch.parallel.dryrun N

spawns N gloo ranks on the CPU (rendezvous through a file in a fresh
temporary directory), runs the legs on each, checks that every rank ended
with the same answers, and prints one line. `legs(device)` runs them inside
a world the caller set up (e.g. one NCCL rank on a card); `spawn_world`
starts such a world from a function.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from scipy import sparse as _sp

from ..batch import BatchedSCS
from ..ops import df32
from ..ops.dense import gemv_cols, gemv_rows
from ..ops.sparse import bell_spmv
from .mesh import make_mesh, rank_device, shard_batched_mats, sharded_batch_solve
from .sharded import ShardedSCS
from .sharded_cg import sharded_cg_solve


def _rank_main(rank, world, backend, init_method, fn, args, out_q):
    """One rank (one CPU thread for PyTorch's own ops): join the world, run
    fn(*args), report (rank, ok, result or traceback), leave the world."""
    try:
        torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        out_q.put((rank, True, result))
    except BaseException:  # reported to the parent, which raises it
        out_q.put((rank, False, traceback.format_exc()))


class World:
    """A world of n spawned processes, each joining it (`backend`,
    rendezvous through a file in a fresh temporary directory) and running
    fn(*args), a module-level function whose
    result is pickled back. `wait()` returns the ranks' results in rank
    order; it raises, and kills every rank, when a rank fails or dies, or
    when the world has not finished within `timeout` seconds of its start
    (a deadlock fails instead of hanging)."""

    def __init__(self, n, fn, args=(), backend="gloo", timeout=600.0):
        self.n, self.backend, self.timeout = n, backend, timeout
        ctx = mp.get_context("spawn")
        self._q = ctx.Queue()
        self._tmp = tempfile.TemporaryDirectory(prefix="scs_world_")
        init_method = "file://" + os.path.join(self._tmp.name, "rendezvous")
        self._procs = [
            ctx.Process(
                target=_rank_main,
                args=(r, n, backend, init_method, fn, args, self._q),
                daemon=True,
            )
            for r in range(n)
        ]
        for p in self._procs:
            p.start()
        self._deadline = time.monotonic() + timeout
        self._results = None

    def wait(self):
        if self._results is not None:
            return self._results
        n, results = self.n, {}
        try:
            while len(results) < n:
                left = self._deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"world of {n} ({self.backend}) not done in {self.timeout:.0f} s; "
                        f"ranks reported: {sorted(results)}"
                    )
                try:
                    rank, ok, out = self._q.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(self._procs)
                            if r not in results and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"rank(s) {dead} of {n} died without reporting")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n} ({self.backend}) failed:\n{out}")
                results[rank] = out
        finally:
            for p in self._procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
            self._tmp.cleanup()
        self._results = [results[r] for r in range(n)]
        return self._results


def spawn_world(n, fn, args=(), backend="gloo", timeout=600.0):
    """World(...).wait(): run fn(*args) on every rank of a new world of n
    processes and return the ranks' results in rank order."""
    return World(n, fn, args, backend, timeout).wait()


def make_batched_qp(B, m, n, seed=0, dtype="float32", eps=1e-6, device="cpu"):
    """__graft_entry__._make_batched_qp's batch of dense QPs (the same
    numbers from the same seed) in a BatchedSCS on `device`."""
    rng = np.random.RandomState(seed)
    A = rng.randn(B, m, n).astype(np.float64) / np.sqrt(m)
    G = rng.randn(B, n, 8).astype(np.float64)
    P = 0.1 * np.einsum("bik,bjk->bij", G, G) + 1e-3 * np.eye(n)
    x0 = rng.randn(B, n)
    b = np.einsum("bij,bj->bi", A, x0) + np.abs(rng.randn(B, m))
    c = rng.randn(B, n)
    return BatchedSCS(
        {"A": A, "b": b, "c": c, "P": P}, {"l": m},
        dtype=dtype, verbose=False, eps_abs=eps, eps_rel=eps, device=device,
    )


_COUNTED = {
    "gemv_rows": gemv_rows, "gemv_cols": gemv_cols, "bell_spmv": bell_spmv,
    "df32.mv": df32.mv, "df32.tv": df32.tv,
}


def _launches():
    return {k: f.launches for k, f in _COUNTED.items()}


def _since(before):
    return {k: f.launches - before[k] for k, f in _COUNTED.items() if f.launches - before[k]}


def legs(device="cpu"):
    """The four legs on this rank of an initialized world (every rank of the
    default group takes part). Returns what rank 0 prints and the others
    must match: statuses, iterations, x, and each leg's kernel launches on
    this rank (on a card)."""
    n_dev = dist.get_world_size()
    dev = str(rank_device(device, dist.group.WORLD))
    out = {"device": dev}

    # 1) the sharded batch, to termination
    t0, before = time.perf_counter(), _launches()
    solver = make_batched_qp(B=n_dev, m=24, n=16, dtype="float32", eps=1e-4, device=dev)
    mesh = make_mesh(n_dev, axis_name="batch")
    mats = shard_batched_mats(solver.mats, mesh)
    states = sharded_batch_solve(solver.core, mats, mesh, max_iters=20000)
    statuses = states.status.tolist()
    if not all(st != 0 for st in statuses):
        raise AssertionError(f"the sharded batch left UNFINISHED problems: {statuses}")
    out["batch"] = dict(statuses=statuses, iters=states.it.tolist(),
                        pobj=states.diag.pobj.tolist(), secs=time.perf_counter() - t0,
                        launches=_since(before))

    # 2) the sharded CG
    t0, before = time.perf_counter(), _launches()
    rng = np.random.RandomState(1)
    m, n = 16 * n_dev, 32
    A = rng.randn(m, n).astype(np.float32)
    dy = (np.abs(rng.randn(m)) + 0.5).astype(np.float32)
    rhs = rng.randn(n).astype(np.float32)
    mesh_rows = make_mesh(n_dev, axis_name="rows")
    x, k = sharded_cg_solve(A, dy, rhs, mesh_rows, tol=1e-4, max_iters=200, device=dev)
    out["cg"] = dict(iters=k, x=x.cpu().numpy(), secs=time.perf_counter() - t0,
                     launches=_since(before))

    # 3) the sharded dense LP (+ SOC-free), f32 at eps 1e-5: high accuracy
    t0, before = time.perf_counter(), _launches()
    mq, nq = 8 * n_dev + 3, 16
    Af = rng.randn(mq, nq)
    x0 = rng.randn(nq)
    bf = Af @ x0 + np.abs(rng.randn(mq))
    cf = -(Af.T @ np.abs(rng.randn(mq)))
    sharded = ShardedSCS(
        {"A": _sp.csc_matrix(Af), "b": bf, "c": cf}, {"l": mq},
        mesh=make_mesh(n_dev, axis_name="rows"), eps_abs=1e-5, eps_rel=1e-5,
        max_iters=20000, verbose=False, dtype="float32", device=dev,
    )
    sol = sharded.solve()
    if sol["info"]["status"] != "solved":
        raise AssertionError(f"sharded dense LP: {sol['info']['status']}")
    out["dense"] = dict(status=sol["info"]["status"], iters=sol["info"]["iter"],
                        hi_acc=sharded.core.hi_acc, x=sol["x"], pobj=sol["info"]["pobj"],
                        secs=time.perf_counter() - t0, launches=_since(before))

    # 4) the sharded bell QP, bell_block_size=4
    t0, before = time.perf_counter(), _launches()
    ms, ns = 24, 10
    As = _sp.random(ms, ns, density=0.3, random_state=rng, format="csc")
    As.data = rng.randn(As.nnz)
    As = (As + _sp.eye(ms, ns, format="csc")).tocsc()
    xs0 = rng.randn(ns)
    bs_ = As @ xs0 + np.abs(rng.randn(ms))
    cs_ = -(As.T @ np.abs(rng.randn(ms)))
    Gs = rng.randn(ns, 3)
    Ps = _sp.csc_matrix(np.triu(Gs @ Gs.T * 0.1 + 1e-3 * np.eye(ns)))
    sharded_bell = ShardedSCS(
        {"A": As, "b": bs_, "c": cs_, "P": Ps}, {"l": ms},
        mesh=make_mesh(n_dev, axis_name="rows"), solver_strategy="bell",
        bell_block_size=4, eps_abs=1e-5, eps_rel=1e-5, max_iters=20000,
        verbose=False, dtype="float32", device=dev,
    )
    solb = sharded_bell.solve()
    if solb["info"]["status"] != "solved":
        raise AssertionError(f"sharded bell QP: {solb['info']['status']}")
    out["bell"] = dict(status=solb["info"]["status"], iters=solb["info"]["iter"],
                       x=solb["x"], pobj=solb["info"]["pobj"],
                       secs=time.perf_counter() - t0, launches=_since(before))
    return out


def check_ranks_agree(results):
    """Every rank's answers are rank 0's, bit for bit."""
    r0 = results[0]
    for r, res in enumerate(results[1:], 1):
        for leg, key in (("batch", "statuses"), ("batch", "iters"), ("batch", "pobj"),
                         ("cg", "iters"), ("cg", "x"), ("dense", "iters"), ("dense", "x"),
                         ("bell", "iters"), ("bell", "x")):
            if not np.array_equal(np.asarray(res[leg][key]), np.asarray(r0[leg][key])):
                raise AssertionError(f"rank {r} differs from rank 0 in {leg} {key}")


def summary(res, n):
    return (
        f"dryrun ok: {n} ranks on {res['device']}; batch statuses {res['batch']['statuses']} "
        f"(all terminal), cg iters {res['cg']['iters']}, sharded-A solve: "
        f"{res['dense']['status']} in {res['dense']['iters']} iters (hi_acc "
        f"{res['dense']['hi_acc']}), sharded-bell QP solve: {res['bell']['status']} in "
        f"{res['bell']['iters']} iters"
    )


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 4
    results = spawn_world(n, legs, ("cpu",))
    check_ranks_agree(results)
    print(summary(results[0], n))


if __name__ == "__main__":
    main()
