"""The cone-projection kernels C1 (proj_exp), C2 (proj_pow) and C3
(proj_box) of csrc/cone_proj.cu on the card, at the synthetic shapes and on
the rows the solver hands them.

    python -m scs_tpu_torch.tools.cone_proto [--other OLD.cu] [--groups]
        [--kernels exp,pow,box] [--host-other ROOT] [--no-wide] [--json PATH]

Cases: the synthetic rows of tools/mixed_cone (exp_rows at EXP_TIMED,
pow_rows at POW_SIZES, the box at BOX_CASES) and the rows captured
(CaptureRows) early, in the middle and late in a solve of the mixed_cone
cell (64 problems; exponential and power cones) and of the wide mixed-cone
batch (128 problems, generated in worker processes; exponential and power
cones and the box, and the buckets it was compacted to; --no-wide skips
it). --kernels picks the kinds (all three by default). For each case, f32:

  * what the rows need: inner Newton solves a row and Newton steps a row
    (percentiles), the rows and solves that end on a cycle, and, under
    the serial schedule (one lane a cone, G = 1), the longest chain of a
    warp of 32 rows against the mean row; the box's steps a problem; for
    proj_pow also, on the plain version's map (mixed_cone.pow_repeat_steps),
    the step at which each row first repeats (a histogram of fixed points
    and of cycles, by period), the rows that never repeat, and the steps of
    the fixed count spent on cycles;
  * the kernel against its plain version (max |kernel - plain| over
    max(1, |v|)), and its device time from CUDA-graph replays of the bare
    entry point beside the bound (check_cone_kernels' count: the plain
    version's solves or steps over 67 TFLOP/s, or the bytes; also the
    bound from the Newton steps the kernel ran);
  * with --other: a build of an earlier cone_proj.cu (the previous design's
    entry points: `git show daad41b:scs_tpu_torch/ops/csrc/cone_proj.cu`
    for proj_exp and proj_box before their lane groups; a source with this
    one's entry points works too), timed against the package's build in
    turns (there and back), whether the two builds' answers are bit-equal,
    and the earlier design's serial floor: its time for one warp of the
    case's longest chain less one warp of rows that need no Newton step,
    per step, times the longest chain;
  * with --groups: proj_exp at every lanes-per-cone G of EXP_GROUPS.

First, the host us per call of the three wrappers at the mixed_cone cell's
shapes; with --host-other ROOT also those of the scs_tpu_torch package of
another checkout at ROOT (`git archive` of an earlier commit), in turns.
Every line carries the card's name and power limit (nvidia-smi). --json
writes the numbers to PATH. Needs a CUDA card; nothing runs on import.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
import time

import numpy as np
import torch

from . import mixed_cone as mc
from .gemv_proto import _bind, card, time_graph_ms

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
F32 = torch.float32
_VP, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# the C entry points, this design's and the previous one's (proj_exp and
# proj_box before their lane-group design: no steps, cycles or group
# arguments; proj_pow's has not changed)
NEW_ABI = {
    "proj_exp_f32": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _D, _VP],
    "proj_box_f32": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    "proj_pow_f32": [_VP, _VP, _VP, _VP, _VP, _I, _VP],
}
OLD_ABI = {
    "proj_exp_f32": [_VP, _VP, _VP, _VP, _I, _D, _VP],
    "proj_box_f32": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    "proj_pow_f32": NEW_ABI["proj_pow_f32"],
}
# timed synthetic cases: the exponential rows of the mixed_cone cell (1280),
# of the wide batch (38400) and 10^6; the power rows of the mixed_cone cell
# (64 x 4), of the wide batch (128 x 100) and 10^6; and mc.BOX_CASES
EXP_TIMED = (1280, 38400, 1_000_000)
POW_TIMED = mc.POW_SIZES
KINDS = ("exp", "pow", "box")


class Build:
    """A build of a cone_proj.cu source: the library, and whether its
    proj_exp and proj_box take this design's arguments (read off the
    source)."""

    def __init__(self, src, name):
        with open(src) as fh:
            self.new = "int group" in fh.read()
        self.lib = _bind(src, name, NEW_ABI if self.new else OLD_ABI)


def exp_launch(lib, new_abi, v, sign, out, group, counts=(None, None, None)):
    """A call of the bare proj_exp_f32 entry point on the current stream;
    counts (new ABI): int32 (k,) outputs of the solves, Newton steps and
    cycles a row, or None."""
    from ..ops.projections import _explim  # noqa: PLC0415

    fn, k, lim = lib.proj_exp_f32, v.shape[0], _explim(v)
    sp = None if sign is None else sign.data_ptr()
    cp = tuple(None if c is None else c.data_ptr() for c in counts)

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        if new_abi:
            rc = fn(v.data_ptr(), sp, out.data_ptr(), *cp, k, group, lim, stream)
        else:
            rc = fn(v.data_ptr(), sp, out.data_ptr(), None, k, lim, stream)
        if rc != 0:
            raise RuntimeError(f"proj_exp launch failed: cudaError {rc}")

    return call


def box_launch(lib, new_abi, v, bl, bu, out, iters=None):
    """A call of the bare proj_box_f32 entry point on the current stream;
    iters: an int32 (B,) output of the Newton steps a problem ran."""
    fn = lib.proj_box_f32
    B, nb = v.shape[0], v.shape[1] - 1
    stride = nb if bl.dim() == 2 else 0
    it = None if iters is None else iters.data_ptr()
    extra = (it, None) if new_abi else (it,)

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(v.data_ptr(), bl.data_ptr(), bu.data_ptr(), out.data_ptr(), *extra, B, nb, stride,
                stream)
        if rc != 0:
            raise RuntimeError(f"proj_box launch failed: cudaError {rc}")

    return call


def _pct(x, qs=(50, 90, 99)):
    return ", ".join(f"p{q} {np.percentile(x, q):g}" for q in qs) + f", max {x.max()}"


def pow_launch(lib, v, a, sign, out, iters=None):
    """A call of the bare proj_pow_f32 entry point on the current stream;
    iters: an int32 (k,) output of the Newton steps a row ran, or None."""
    fn, k = lib.proj_pow_f32, v.shape[0]
    sp = None if sign is None else sign.data_ptr()
    it = None if iters is None else iters.data_ptr()

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(v.data_ptr(), a.data_ptr(), sp, out.data_ptr(), it, k, stream)
        if rc != 0:
            raise RuntimeError(f"proj_pow launch failed: cudaError {rc}")

    return call


def exp_stats(lib, v, sign):
    """What the rows need under the serial schedule (G = 1, through the
    bare entry point of the package's build `lib`): solves, steps and
    cycles a row, and the warps' longest chains."""
    k = v.shape[0]
    counts = [torch.zeros(k, dtype=torch.int32, device=v.device) for _ in range(3)]
    exp_launch(lib, True, v, sign, torch.empty_like(v), 1, counts)()
    evals, steps, cycles = (c.cpu().numpy() for c in counts)
    pad = -k % 32
    warps = np.concatenate([steps, np.zeros(pad, steps.dtype)]).reshape(-1, 32)
    worked = steps > 0
    return {
        "rows": k, "rows_with_newton": int(worked.sum()),
        "solves": f"{evals[worked].mean():.1f} mean, {_pct(evals[worked])}" if worked.any() else "none",
        "steps": f"{steps[worked].mean():.1f} mean, {_pct(steps[worked])}" if worked.any() else "none",
        "solves_total": int(evals.sum()), "steps_total": int(steps.sum()),
        "rows_cycling": int((cycles > 0).sum()), "solves_cycling": int(cycles.sum()),
        "warp_longest_mean": float(warps.max(axis=1).mean()),
        "row_mean": float(steps.mean()), "longest": int(steps.max()),
        "longest_row": int(np.argmax(np.where(cycles == 0, steps, -1))),
        "longest_clean": int(np.where(cycles == 0, steps, -1).max()),
    }


def box_stats(v, bl, bu):
    from ..ops import projections as pr  # noqa: PLC0415

    B = v.shape[0]
    iters, cycles = (torch.zeros(B, dtype=torch.int32, device=v.device) for _ in range(2))
    pr._proj_box(v, bl, bu, iters_out=iters, cycles_out=cycles)
    iters, cycles = iters.cpu().numpy(), cycles.cpu().numpy()
    return {
        "problems": B, "steps": f"{iters.mean():.1f} mean, {_pct(iters)}",
        "steps_total": int(iters.sum()), "cycling": int(cycles.sum()),
        "longest": int(iters.max()),
    }


def exp_bound_ms(v, evals_total, steps_total=None):
    """check_cone_kernels' bound: the plain version's solves at 40 Newton
    steps each or, given steps_total, the Newton steps the kernel ran."""
    newton = 40 * evals_total if steps_total is None else steps_total
    ops = newton * mc.EXP_OPS_PER_NEWTON + evals_total * mc.EXP_OPS_PER_SOLVE
    return mc._bound_ms(v.shape[0] * 7 * 4, ops, F32, HBM_BYTES_PER_S, PEAK_FLOPS)


def box_bound_ms(v, bl, steps_total):
    B, nb = v.shape[0], v.shape[1] - 1
    n_bytes = (2 * B * (nb + 1) + 2 * (B if bl.dim() == 2 else 1) * nb) * 4
    return mc._bound_ms(n_bytes, (steps_total + B) * nb * mc.BOX_OPS_PER_ELEMENT, F32,
                        HBM_BYTES_PER_S, PEAK_FLOPS)


def run_exp_case(label, v, sign, libs, tag, groups):
    """Stats, agreement, times in turns, the serial floor, the G sweep."""
    from ..ops import projections as pr  # noqa: PLC0415

    st = exp_stats(libs["this"].lib, v, sign)
    out = pr._proj_exp_batch(v, sign)
    err = float(mc._row_err(out, pr._signed(pr._proj_exp_batch_ref, v, sign), v).max())
    bound = exp_bound_ms(v, st["solves_total"])
    bound_run = exp_bound_ms(v, st["solves_total"], st["steps_total"])
    G = pr.exp_group(v.shape[0])
    rec = {"label": label, "shape": tuple(v.shape), "group": G, "stats": st, "max_rel_err": err,
           "bound_ms": bound[0], "bound_by": bound[1], "bound_steps_ms": bound_run[0]}
    print(f"{label} f32: {st['rows']} rows, {st['rows_with_newton']} need Newton; solves a row "
          f"{st['solves']}; Newton steps a row {st['steps']}; {st['rows_cycling']} rows with a "
          f"cycle ({st['solves_cycling']} solves); serial schedule: longest chain of a warp "
          f"{st['warp_longest_mean']:.1f} steps on average against {st['row_mean']:.1f} for the "
          f"mean row, longest {st['longest']}; max |kernel - plain| {err:.3e} of max(1, |v|); "
          f"bound {bound[0]:.6f} ms by {bound[1]} (from the Newton steps run at G = 1: "
          f"{bound_run[0]:.6f} ms by {bound_run[1]}) [{tag}]", flush=True)
    outs = {name: torch.empty_like(v) for name in libs}
    calls = {name: exp_launch(b.lib, b.new, v, sign, outs[name], G) for name, b in libs.items()}
    rec["ms"] = time_graph_ms(calls["this"])
    if "other" in libs:
        turns = [(t, time_graph_ms(calls[t])) for t in ("other", "this", "this", "other")]
        rec["turns"] = turns
        # the earlier design's time per Newton step: one warp of the longest
        # chain free of cycles, less one warp of rows inside the cone
        lib, new = libs["other"].lib, libs["other"].new
        rows = torch.full((32,), st["longest_row"], dtype=torch.long, device=v.device)
        warps = {
            "longest_row": (v[rows].contiguous(), None if sign is None else sign[rows].contiguous()),
            "idle_row": (torch.tensor([[0.0, 1.0, 1.0]] * 32, dtype=v.dtype, device=v.device), None),
        }
        warp_ms = {n: time_graph_ms(exp_launch(lib, new, w, sg, torch.empty_like(w), 1))
                   for n, (w, sg) in warps.items()}
        per_step = (warp_ms["longest_row"] - warp_ms["idle_row"]) / max(st["longest_clean"], 1)
        rec["serial_floor_ms"] = per_step * st["longest"]
        rec["step_us"] = per_step * 1e3
        # this design's, the same way at G = 1 (the row's steps are its own count)
        lib_t, new_t = libs["this"].lib, libs["this"].new
        this_ms = {n: time_graph_ms(exp_launch(lib_t, new_t, w, sg, torch.empty_like(w), 1))
                   for n, (w, sg) in warps.items()}
        rec["this_step_us"] = 1e3 * (this_ms["longest_row"] - this_ms["idle_row"]) / max(
            st["longest_clean"], 1)
        print(f"  in turns: " + ", ".join(f"{t} {ms:.4f} ms" for t, ms in turns)
              + f" ({G} lanes a cone); this design at G = 1: {rec['this_step_us']:.4f} us a "
              f"Newton step; earlier design: {per_step * 1e3:.4f} us a Newton step "
              f"(one warp of {st['longest_clean']} steps {warp_ms['longest_row']:.4f} ms, of none "
              f"{warp_ms['idle_row']:.4f} ms), serial floor {rec['serial_floor_ms']:.4f} ms for the "
              f"longest chain of {st['longest']} steps (at least: a solve it ran to the end of a "
              f"cycle counts here at this design's exit) [{tag}]", flush=True)
    else:
        print(f"  this build {rec['ms']:.4f} ms ({G} lanes a cone) [{tag}]", flush=True)
    if groups:
        lib, new = libs["this"].lib, libs["this"].new
        rec["groups"] = {g: time_graph_ms(exp_launch(lib, new, v, sign, outs["this"], g))
                         for g in sorted(pr.EXP_GROUPS)}
        print("  by lanes a cone: " + ", ".join(f"G={g} {ms:.4f}" for g, ms in rec["groups"].items())
              + f" ms [{tag}]", flush=True)
    return rec


def run_box_case(label, v, bl, bu, libs, tag):
    from ..ops import projections as pr  # noqa: PLC0415

    st = box_stats(v, bl, bu)
    out = pr._proj_box(v, bl, bu)
    err = float(mc._row_err(out, pr._proj_box_ref(v, bl, bu), v).max())
    bound = box_bound_ms(v, bl, st["steps_total"])
    rec = {"label": label, "shape": tuple(v.shape), "stats": st, "max_rel_err": err,
           "bound_ms": bound[0], "bound_by": bound[1]}
    print(f"{label} f32: Newton steps a problem {st['steps']}; {st['cycling']} of {st['problems']} "
          f"problems left on a cycle; longest chain {st['longest']} steps; max |kernel - plain| {err:.3e} of "
          f"max(1, |v|); bound {bound[0]:.6f} ms by {bound[1]} [{tag}]", flush=True)
    outs = {name: torch.empty_like(v) for name in libs}
    calls = {name: box_launch(b.lib, b.new, v, bl, bu, outs[name]) for name, b in libs.items()}
    rec["ms"] = time_graph_ms(calls["this"])
    if "other" in libs:
        turns = [(t, time_graph_ms(calls[t])) for t in ("other", "this", "this", "other")]
        rec["turns"] = turns
        # the earlier design's steps (its own count) and time per step: its
        # longest problem alone, less a problem of one step (s inside its box)
        lib, new = libs["other"].lib, libs["other"].new
        old_iters = torch.zeros(v.shape[0], dtype=torch.int32, device=v.device)
        box_launch(lib, new, v, bl, bu, outs["other"], old_iters)()
        old_iters = old_iters.cpu().numpy()
        i = int(np.argmax(old_iters))
        one = v[i : i + 1].clone()
        lo = bl[i : i + 1] if bl.dim() == 2 else bl
        hi = bu[i : i + 1] if bu.dim() == 2 else bu
        fin_l, fin_u = torch.isfinite(lo), torch.isfinite(hi)
        zero = torch.zeros_like(lo)
        inside = torch.where(fin_l & fin_u, 0.5 * (lo + hi),
                             torch.where(fin_l, lo, torch.where(fin_u, hi, zero)))
        flat = torch.cat([torch.ones_like(one[:, :1]), inside.reshape(1, -1)], dim=1)
        ms = {n: time_graph_ms(box_launch(lib, new, w, lo, hi, torch.empty_like(w)))
              for n, w in (("longest", one), ("one step", flat))}
        per_step = (ms["longest"] - ms["one step"]) / max(int(old_iters[i]) - 1, 1)
        rec["serial_floor_ms"] = per_step * int(old_iters.max())
        rec["step_us"] = per_step * 1e3
        rec["old_steps"] = f"{old_iters.mean():.1f} mean, {_pct(old_iters)}"
        print(f"  in turns: " + ", ".join(f"{t} {ms_:.4f} ms" for t, ms_ in turns)
              + f"; earlier design: steps a problem {rec['old_steps']}, {per_step * 1e3:.4f} us a "
              f"step (its longest problem alone {ms['longest']:.4f} ms, one step "
              f"{ms['one step']:.4f} ms), serial floor {rec['serial_floor_ms']:.4f} ms [{tag}]",
              flush=True)
    else:
        print(f"  this build {rec['ms']:.4f} ms [{tag}]", flush=True)
    return rec


def _hist(x, top=40):
    counts = np.bincount(np.asarray(x, np.int64), minlength=top + 1)
    return " ".join(f"{i}:{c}" for i, c in enumerate(counts) if c)


def pow_stats(lib, v, a, sign):
    """What the rows need: the kernel's own Newton steps a row and the
    warps' longest chains; on the plain version's map
    (mc.pow_repeat_steps) the step at which each row first repeats, by
    period, and the steps of the fixed count spent on cycles."""
    from ..ops import projections as pr  # noqa: PLC0415

    k, n = v.shape[0], pr.POW_NEWTON_ITERS
    iters = torch.zeros(k, dtype=torch.int32, device=v.device)
    pow_launch(lib, v, a, sign, torch.empty_like(v), iters)()
    steps = iters.cpu().numpy()
    need, period = (t.cpu().numpy() for t in mc.pow_repeat_steps(v, a, sign))
    worked = need > 0
    warps = np.concatenate([steps, np.zeros(-k % 32, steps.dtype)]).reshape(-1, 32)
    fixed, cyc = worked & (period == 1), worked & (period >= 2)
    # the fixed count's steps on a cycle: from its entry (need - period) on
    on_cycle = int(np.where(cyc, n - (need - period), 0).sum())
    # the longest row that does not cycle, for the time of a step
    clean = np.where(worked & (period <= 1), steps, -1)
    return {
        "rows": k, "rows_with_newton": int(worked.sum()),
        "steps": f"{steps[worked].mean():.1f} mean, {_pct(steps[worked])}" if worked.any() else "none",
        "steps_total": int(steps.sum()),
        "need": f"{need[worked].mean():.1f} mean, {_pct(need[worked])}" if worked.any() else "none",
        "need_total": int(need.sum()), "need_longest": int(need.max()),
        "warp_longest_mean": float(warps.max(axis=1).mean()), "row_mean": float(steps.mean()),
        "longest": int(steps.max()),
        "plain_fixed_points": int(fixed.sum()), "plain_cycling": int(cyc.sum()),
        "plain_no_repeat": int((worked & (period == 0)).sum()),
        "periods": _hist(period[worked & (period > 0)], n),
        "fixed_point_step_hist": _hist(need[fixed], n),
        "cycle_entry_hist": _hist((need - period)[cyc], n),
        "steps_on_cycles": on_cycle,
        "steps_on_cycles_share": on_cycle / max(int(steps.sum()), 1),
        "longest_clean": int(clean.max()), "longest_row": int(np.argmax(clean)),
    }


def pow_bound_ms(v, steps_total):
    """check_cone_kernels' bound from `steps_total` Newton steps."""
    return mc._bound_ms(v.shape[0] * 8 * 4, steps_total * mc.POW_OPS_PER_NEWTON, F32,
                        HBM_BYTES_PER_S, PEAK_FLOPS)


def run_pow_case(label, v, a, sign, libs, tag):
    """Stats, agreement, times in turns and the time of a Newton step of
    proj_pow."""
    from ..ops import projections as pr  # noqa: PLC0415

    this = libs["this"].lib
    st = pow_stats(this, v, a, sign)
    out = torch.empty_like(v)
    pow_launch(this, v, a, sign, out)()
    plain = pr._signed(lambda w: pr._proj_pow_batch_ref(w, a), v, sign)
    err = float(mc._row_err(out, plain, v).max())
    bound = pow_bound_ms(v, st["need_total"])
    fixed = pow_bound_ms(v, pr.POW_NEWTON_ITERS * st["rows_with_newton"])
    bound_run = pow_bound_ms(v, st["steps_total"])
    rec = {"label": label, "shape": tuple(v.shape), "stats": st, "max_rel_err": err,
           "bound_ms": bound[0], "bound_by": bound[1], "bound_fixed_ms": fixed[0],
           "bound_steps_ms": bound_run[0]}
    print(f"{label} f32: {st['rows']} rows, {st['rows_with_newton']} need Newton; the kernel's "
          f"Newton steps a row {st['steps']} ({st['steps_total']} in all); longest chain of a warp "
          f"{st['warp_longest_mean']:.1f} steps on average against {st['row_mean']:.1f} for the "
          f"mean row, longest {st['longest']}; the plain map: steps to the first repeat "
          f"{st['need']} ({st['need_total']} in all), {st['plain_fixed_points']} rows reach a "
          f"fixed point (at step: {st['fixed_point_step_hist']}), {st['plain_cycling']} cycle "
          f"(periods {st['periods']}; entering at step: {st['cycle_entry_hist']}), "
          f"{st['plain_no_repeat']} never repeat; {st['steps_on_cycles']} steps of the fixed count "
          f"on cycles ({100 * st['steps_on_cycles_share']:.1f}% of the kernel's steps); max "
          f"|kernel - plain| {err:.3e} of max(1, |v|); bound {bound[0]:.6f} ms by {bound[1]} "
          f"(at 40 steps a row {fixed[0]:.6f}; from the steps the kernel ran {bound_run[0]:.6f}) "
          f"[{tag}]", flush=True)
    # the builds in turns, there and back (this, other, other, this)
    outs = {name: torch.empty_like(v) for name in libs}
    times = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        times[name].append(time_graph_ms(pow_launch(libs[name].lib, v, a, sign, outs[name])))
    rec["ms"] = float(np.mean(times["this"]))
    rec["turns"] = times
    rec["bit_equal_this"] = {name: bool(torch.equal(o, outs["this"])) for name, o in outs.items()}
    # each build's time a Newton step: one warp of the longest row that
    # does not cycle, less one warp of rows inside the cone, over that
    # row's steps
    rows = torch.full((32,), st["longest_row"], dtype=torch.long, device=v.device)
    idle = torch.tensor([[1.0, 1.0, 0.0]] * 32, dtype=v.dtype, device=v.device)
    warps = {"longest_row": (v[rows].contiguous(), a[rows].contiguous(),
                             None if sign is None else sign[rows].contiguous()),
             "idle_row": (idle, a[rows].contiguous(), None)}
    rec["step_us"] = {}
    for name, b in libs.items():
        ms = {n: time_graph_ms(pow_launch(b.lib, w, aw, sw, torch.empty_like(w)))
              for n, (w, aw, sw) in warps.items()}
        rec["step_us"][name] = 1e3 * (ms["longest_row"] - ms["idle_row"]) / max(
            st["longest_clean"], 1)
    rec["serial_floor_ms"] = rec["step_us"]["this"] * 1e-3 * st["need_longest"]
    print("  in turns (ms, there and back): " + "; ".join(
        f"{name} {t[0]:.4f} {t[1]:.4f}" + ("" if rec["bit_equal_this"][name] else " (other bits)")
        for name, t in times.items()) + f" [{tag}]", flush=True)
    print("  a Newton step (us; one warp of the longest row that does not cycle, "
          f"{st['longest_clean']} steps, less one warp inside the cone): "
          + "; ".join(f"{name} {us:.4f}" for name, us in rec["step_us"].items())
          + f"; serial floor {rec['serial_floor_ms']:.4f} ms: this build's step times the longest "
          f"chain an exact exit needs ({st['need_longest']} steps) [{tag}]", flush=True)
    return rec


def _ptxas(name, kernel=""):
    """The registers and spills nvcc reported for `name`'s entry functions
    (those whose mangled name holds `kernel`)."""
    from ..ops import _kernels  # noqa: PLC0415

    out, current = [], None
    for ln in _kernels.build_log.get(name, "").splitlines():
        if "Compiling entry function" in ln:
            current = ln.split("'")[1] if "'" in ln else ln
        elif current and kernel in current and ("registers" in ln or "spill" in ln):
            out.append(f"{current[-40:]}: {ln.split(':', 1)[-1].strip()}")
    return " | ".join(out) or "(not built in this process)"


def _package_from(root):
    """The scs_tpu_torch package of another checkout at `root` (a `git
    archive` of an earlier commit), imported as scs_tpu_torch_other: its
    wrappers, bindings and kernels built from its own sources."""
    import importlib.util  # noqa: PLC0415

    init = os.path.join(root, "scs_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        "scs_tpu_torch_other", init, submodule_search_locations=[os.path.dirname(init)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = pkg
    spec.loader.exec_module(pkg)
    from importlib import import_module  # noqa: PLC0415

    return import_module("scs_tpu_torch_other.ops.projections")


def host_times(tag, other_root=None):
    """Host us per call of the three cone wrappers, back to back, at the
    mixed_cone cell's shapes (gemv_proto.host_us); with other_root, the
    wrappers of the checkout there too, in turns (this, other, other,
    this)."""
    from ..ops import projections as pr  # noqa: PLC0415
    from .gemv_proto import host_us  # noqa: PLC0415

    dev = torch.device("cuda")
    v, a, sign = (torch.as_tensor(x, dtype=F32, device=dev) for x in mc.pow_rows(256, seed=1))
    ve = torch.as_tensor(mc.exp_rows(1280, seed=3), dtype=F32, device=dev)
    se = torch.as_tensor(np.where(np.arange(1280) % 3 == 0, -1.0, 1.0), dtype=F32, device=dev)
    vb, bl, bu = (torch.as_tensor(x, dtype=F32, device=dev)
                  for x in mc.box_case(64, 400, seed=1, per_row=True))
    mods = {"this": pr}
    if other_root is not None:
        mods["other"] = _package_from(other_root)
    order = list(mods) + list(mods)[::-1]
    res = {name: {} for name in mods}
    for name in order:
        m = mods[name]
        for label, call in (
            ("_proj_pow_batch (256, 3)", lambda: m._proj_pow_batch(v, a, sign)),
            ("_proj_exp_batch (1280, 3)", lambda: m._proj_exp_batch(ve, se)),
            ("_proj_box (64, 401)", lambda: m._proj_box(vb, bl, bu)),
        ):
            res[name].setdefault(label, []).append(host_us(call))
    for name, by in res.items():
        print(f"host us per wrapper call, back to back, {name} wrappers: "
              + ", ".join(f"{k} {' '.join(f'{us:.2f}' for us in t)}" for k, t in by.items())
              + f" [{tag}]", flush=True)
    return res


def capture_solves(wide=True, workers=8):
    """The rows the solver hands the kernels: CaptureRows over a solve of
    the mixed_cone cell and (wide) of the wide batch, f32 on the card.
    Returns [(tag, CaptureRows)]."""
    import multiprocessing  # noqa: PLC0415
    from concurrent.futures import ProcessPoolExecutor  # noqa: PLC0415

    from .. import BatchedSCS  # noqa: PLC0415

    kw = dict(dtype="float32", eps_abs=mc.MIXED_EPS, eps_rel=mc.MIXED_EPS, max_iters=20000,
              scale=1.0, device="cuda")
    out = []
    data, _ = mc.gen_mixed_batch(mc.MIXED_K, mc.MIXED_B, mc.MIXED_SEED)
    with mc.CaptureRows() as cap:
        BatchedSCS(data, mc.MIXED_K, **kw).solve()
    out.append(("mixed_cone", cap))
    if wide:
        K = mc.wide_cone()
        t0 = time.perf_counter()
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            data, _, _ = mc.collect_mixed_batch(
                mc.gen_mixed_batch(K, mc.WIDE_B, 4000, pool=pool)
            )
        print(f"wide batch generated in {time.perf_counter() - t0:.1f} s", flush=True)
        with mc.CaptureRows() as cap:
            BatchedSCS(data, K, **kw).solve()
        del data
        out.append(("mixed_cone_wide", cap))
    return out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {}
    for flag in ("--other", "--json", "--kernels", "--host-other"):
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1]
            del argv[i : i + 2]
    groups = "--groups" in argv
    wide = "--no-wide" not in argv
    kinds = opts.get("--kernels", ",".join(KINDS)).split(",")
    if not torch.cuda.is_available():
        sys.exit("cone_proto: PyTorch sees no CUDA device; this runs only on the card")
    from ..ops import _kernels  # noqa: PLC0415

    tag = card()
    print(tag)
    src = os.path.join(_kernels._CSRC, "cone_proj.cu")
    libs = {"this": Build(src, "cone_proj")}
    print("ptxas: " + _ptxas("cone_proj"))
    if "--other" in opts:
        libs["other"] = Build(opts["--other"], "cone_proj_other")
        print("ptxas, the other build: " + _ptxas("cone_proj_other", "proj_pow"))
    dev = torch.device("cuda")
    res = {"card": tag, "exp": [], "box": [], "pow": [], "host_us": host_times(tag, opts.get("--host-other"))}
    for k in EXP_TIMED if "exp" in kinds else ():
        v = mc.exp_rows(k, seed=k % 1000) * np.where(np.arange(k) % 3 == 0, -1.0, 1.0)[:, None]
        sign = np.where(np.arange(k) % 3 == 0, -1.0, 1.0)
        res["exp"].append(run_exp_case(
            f"proj_exp synthetic (k={k}, 3)", torch.as_tensor(v, dtype=F32, device=dev),
            torch.as_tensor(sign, dtype=F32, device=dev), libs, tag, groups))
    for k in POW_TIMED if "pow" in kinds else ():
        v, a, sign = (torch.as_tensor(x, dtype=F32, device=dev)
                      for x in mc.pow_rows(k, seed=k % 1000 + 1))
        res["pow"].append(run_pow_case(f"proj_pow synthetic (k={k}, 3)", v, a, sign, libs, tag))
    for B, nb, per_row in mc.BOX_CASES if "box" in kinds else ():
        v, bl, bu = (torch.as_tensor(a, dtype=F32, device=dev)
                     for a in mc.box_case(B, nb, seed=B + per_row, per_row=per_row))
        res["box"].append(run_box_case(
            f"proj_box synthetic ({B}, {nb + 1}) {'per-row' if per_row else 'shared'} bounds",
            v, bl, bu, libs, tag))
    for cell, cap in capture_solves(wide):
        for ph, (c, v, sign) in cap.phases("exp").items() if "exp" in kinds else ():
            res["exp"].append(run_exp_case(f"proj_exp {cell} {ph} (call {c}) {tuple(v.shape)}",
                                           v, sign, libs, tag, groups))
        for ph, (c, v, a, sign) in cap.phases("pow").items() if "pow" in kinds else ():
            res["pow"].append(run_pow_case(f"proj_pow {cell} {ph} (call {c}) {tuple(v.shape)}",
                                           v, a, sign, libs, tag))
        for ph, (c, v, bl, bu) in cap.phases("box").items() if "box" in kinds else ():
            res["box"].append(run_box_case(f"proj_box {cell} {ph} (call {c}) {tuple(v.shape)}",
                                           v, bl, bu, libs, tag))
    if "--json" in opts:
        with open(opts["--json"], "w") as fh:
            json.dump(res, fh, indent=1, default=str)


if __name__ == "__main__":
    main()
