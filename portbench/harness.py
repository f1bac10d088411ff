"""One run of one cell: the pool, the warm-up, the measured window, the
reference's check and the metrics.

The window runs whole batches back to back. Each batch is what a user does
with new data: a fresh copy of a pool entry, `BatchedSCS(copy, cone,
**settings)`, then `.solve()`. The window closes at the first batch end at
or after `seconds`, and every rate is over the time to that end, so no
batch is cut in half. With `trace`, the window's second batch runs under
the profiler (a window ends no earlier than that batch).

The pool comes from the traffic's fixed `base_seed`, so that every seed
times the same work; after the window, `check` also solves one batch
drawn afresh from the run's seed, so that each seed widens what `correct`
covers.
"""

from __future__ import annotations

import math
import time
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench import reference, registry, seeding
from portbench.trace import Window

TRACED_BATCH = 1  # the window's second batch: the first after a warm one
FRESH = 2**20  # the index, under the run's seed, of the batch drawn afresh


@dataclass
class Batch:
    pool_index: int
    construct_s: float  # BatchedSCS(...) on the copy, synchronised at both ends
    solve_s: float  # .solve(), synchronised at both ends
    iters: np.ndarray  # info["iter"] of each problem
    statuses: list
    device_prob_iters: int  # the batch's lockstep cost in problem-iterations
    traced: bool = False


@dataclass
class Run:
    """What a run measured; the metric readers take their numbers from it."""

    cfg: dict
    traffic: dict
    device: dict
    seed: int = 0
    settings: dict = field(default_factory=dict)
    setup_s: float = math.nan
    window_s: float = math.nan
    batches: list = field(default_factory=list)
    peak_bytes: int | None = None  # allocator peak over the window
    setup_peak_bytes: int | None = None  # allocator peak of the set-up
    harness_bytes: int | None = None  # the pool and one copy, the harness's own
    trace: object = None
    results: list = field(default_factory=list)  # (pool index, solve() output) per batch
    pool: list = field(default_factory=list)  # the generator's entries

    @property
    def itemsize(self):
        return torch.empty((), dtype=getattr(torch, self.cfg["dtype"])).element_size()

    @property
    def solved(self):
        return sum(s == "solved" for b in self.batches for s in b.statuses)

    @property
    def attempted(self):
        return sum(len(b.statuses) for b in self.batches)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree.values())


def settings_of(cfg, traffic, device, override=None):
    st = dict(cfg["settings"], dtype=cfg["dtype"], device=str(device))
    st.update(traffic.get("settings", {}))
    st.update(override or {})
    return st


def make_pool(cfg, traffic, seed, device):
    """The traffic's batches: drawn from its `base_seed`, then given some
    variables negated, drawn from the run's seed (`run_cell` draws the
    order in which the window visits them from it too).

    How long a batch takes is set by its slowest problem's iterations, so
    batches drawn afresh for every seed would change the work with the
    seed. A change of sign of a variable (a column of A, an entry of c, a
    row and column of P) leaves every iteration the same, bit for bit in
    size: the solver's arithmetic meets each sign twice or in a norm. So
    every seed runs the same work on inputs of other bits, in another
    order. (Problems are not permuted within a batch: the solver pads a
    compacted batch with copies of its first live problem, whose work
    would then change with the seed.)"""
    gen = registry.generator(cfg["generator"])
    pool = []
    for i in range(int(traffic["pool"])):
        entry = gen.make(cfg, int(traffic["batch"]),
                         seeding.entry_seed(int(traffic["base_seed"]), i), device)
        flip_signs(entry["data"], seeding.entry_seed(seed, i))
        pool.append(entry)
    return pool


def flip_signs(data, seed):
    """Negate each variable of each problem with probability 1/2, drawn
    from `seed`, in place: A's column, c's entry, P's row and column."""
    A = data["A"]
    B, _, n = A.shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    sign = (torch.randint(0, 2, (B, n), generator=g) * 2 - 1).to(A.device, A.dtype)
    A.mul_(sign[:, None, :])
    data["c"].mul_(sign)
    if "P" in data:
        data["P"].mul_(sign[:, :, None]).mul_(sign[:, None, :])


def _gemv_counters():
    from scs_tpu_torch.ops.dense import gemv_cols, gemv_rows  # noqa: PLC0415

    return {"gemv_rows": Counter(gemv_rows.shapes), "gemv_cols": Counter(gemv_cols.shapes)}


def run_cell(cfg, traffic, seed, seconds, trace=False, device="cuda", t_start=None,
             override=None, device_info=None):
    """Run one cell once; returns the Run. `t_start` is the process's start
    on the host clock (set-up is counted from it); `override` replaces
    solver settings (the control's float32)."""
    from scs_tpu_torch import BatchedSCS  # noqa: PLC0415

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    settings = settings_of(cfg, traffic, device, override)
    run = Run(cfg=cfg, traffic=traffic, device=device_info or {}, seed=seed, settings=settings)
    pool = make_pool(cfg, traffic, seed, device)
    cone = pool[0]["cone"]

    order = torch.randperm(len(pool), generator=torch.Generator().manual_seed(
        seeding.entry_seed(seed, len(pool)))).tolist()

    def one_batch(j, traced):
        entry = pool[order[j % len(pool)]]
        data = {k: v.clone() for k, v in entry["data"].items()}
        _sync(device)
        t0 = time.perf_counter()
        solver = BatchedSCS(data, cone, **settings)
        _sync(device)
        t1 = time.perf_counter()
        res = solver.solve()
        _sync(device)
        t2 = time.perf_counter()
        batch = Batch(
            pool_index=order[j % len(pool)], construct_s=t1 - t0, solve_s=t2 - t1,
            iters=np.array([r["info"]["iter"] for r in res]),
            statuses=[r["info"]["status"] for r in res],
            device_prob_iters=int(solver.device_prob_iters), traced=traced,
        )
        return batch, res

    # warm-up: one capped solve at the cell's own shapes loads every kernel
    # library, builds the hand-written kernels on a checkout's first run and
    # sizes the allocator's pool
    warm = dict(settings, max_iters=int(traffic["warmup_iters"]))
    entry = pool[0]
    BatchedSCS({k: v.clone() for k, v in entry["data"].items()}, cone, **warm).solve()
    _sync(device)

    if device.type == "cuda":
        run.harness_bytes = sum(_nbytes(e["data"]) for e in pool) + _nbytes(pool[0]["data"])
        run.setup_peak_bytes = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t_open = time.perf_counter()
    run.setup_s = t_open - t_start
    j = 0
    while True:
        traced = trace and j == TRACED_BATCH
        if traced:
            before = _gemv_counters() if device.type == "cuda" else {}
            with Window() as w:
                batch, res = one_batch(j, True)
            w.trace.counters = {
                k: c - before[k] for k, c in _gemv_counters().items()
            } if device.type == "cuda" else {}
            w.trace.iters = int(batch.iters.max())
            run.trace = w.trace
        else:
            batch, res = one_batch(j, False)
        run.batches.append(batch)
        run.results.append((batch.pool_index, res))
        j += 1
        now = time.perf_counter()
        if now - t_open >= seconds and not (trace and j <= TRACED_BATCH):
            break
    run.window_s = now - t_open
    if device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    run.pool = pool
    return run


def fresh_batch(run, device):
    """One batch drawn from the run's own seed at the cell's size, solved
    as the window solves one (untimed, once the window has closed):
    (the generator's entry, solve()'s output)."""
    from scs_tpu_torch import BatchedSCS  # noqa: PLC0415

    gen = registry.generator(run.cfg["generator"])
    entry = gen.make(run.cfg, int(run.traffic["batch"]), seeding.entry_seed(run.seed, FRESH), device)
    data = {k: v.clone() for k, v in entry["data"].items()}
    return entry, BatchedSCS(data, entry["cone"], **run.settings).solve()


def check(run, eps_abs, eps_rel, fresh=True):
    """The reference's numbers over every batch of the window and, with
    `fresh`, over a batch drawn afresh from the run's seed; the pool is
    let go before that batch is made."""
    worst = {k: 0.0 for k in reference.NUMBERS}
    covered = 0

    def add(entry, res):
        nonlocal covered
        nums, n = reference.check_batch(entry, res, eps_abs, eps_rel)
        covered += n
        for k, v in nums.items():
            worst[k] = v + worst[k] if k == "wrong_status" else max(worst[k], v)

    for pool_index, res in run.results:
        add(run.pool[pool_index], res)
    if fresh:
        device = run.pool[0]["data"]["A"].device
        run.pool, run.results = [], []
        entry, res = fresh_batch(run, device)
        add(entry, res)
        del entry, res
    if covered == 0:  # nothing solved: nothing to hold the answers to
        for k in reference.NUMBERS[1:]:
            worst[k] = math.inf
    return worst


def metrics(run, names):
    """{name: {"value", "unit"}} of the metrics whose reader finds something."""
    out = {}
    for name, unit in names:
        v = registry.metric(name).read(run)
        if v is not None:
            out[name] = {"value": v, "unit": unit}
    return out
