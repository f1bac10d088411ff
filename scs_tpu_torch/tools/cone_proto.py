"""The cone-projection kernels C1 (proj_exp) and C3 (proj_box) of
csrc/cone_proj.cu on the card, at the synthetic shapes and on the rows the
solver hands them.

    python -m scs_tpu_torch.tools.cone_proto [--other OLD.cu] [--groups]
        [--no-wide] [--json PATH]

Cases: the synthetic rows of tools/mixed_cone (exp_rows at EXP_SIZES, the
box at BOX_CASES) and the rows captured (CaptureRows) early, in the middle
and late in a solve of the mixed_cone cell (64 problems; exponential cones
only) and of the wide mixed-cone batch (128 problems, generated in worker
processes; exponential cones and the box; --no-wide skips it). For each
case, f32:

  * what the rows need: inner Newton solves a row and Newton steps a row
    (percentiles), the rows and solves that end on a cycle, and, under
    the serial schedule (one lane a cone, G = 1), the longest chain of a
    warp of 32 rows against the mean row; the box's steps a problem;
  * the kernel against its plain version (max |kernel - plain| over
    max(1, |v|)), and its device time from CUDA-graph replays of the bare
    entry point beside the bound (check_cone_kernels' count: the plain
    version's solves or steps over 67 TFLOP/s, or the bytes; for proj_exp
    also the bound from the Newton steps its exits leave to run);
  * with --other: a build of an earlier cone_proj.cu (the previous design's
    entry points: `git show daad41b:scs_tpu_torch/ops/csrc/cone_proj.cu`;
    a source with this one's entry points works too), timed against the
    package's build in turns (other, this, this, other), and the earlier
    design's serial floor: its time for one warp of the case's longest
    chain less one warp of rows that need no Newton step, per step, times
    the longest chain;
  * with --groups: proj_exp at every lanes-per-cone G of EXP_GROUPS.

Every line carries the card's name and power limit (nvidia-smi). --json
writes the numbers to PATH. Needs a CUDA card; nothing runs on import.
"""

from __future__ import annotations

import ctypes
import json
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
# the C entry points, this design's and the previous one's (no steps,
# cycles or group arguments)
NEW_ABI = {
    "proj_exp_f32": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _D, _VP],
    "proj_box_f32": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
}
OLD_ABI = {
    "proj_exp_f32": [_VP, _VP, _VP, _VP, _I, _D, _VP],
    "proj_box_f32": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
}
# timed synthetic cases: the exponential rows of the mixed_cone cell (1280),
# of the wide batch (38400) and 10^6, and mc.BOX_CASES
EXP_TIMED = (1280, 38400, 1_000_000)


def bind(src, name):
    """(library, new ABI?) built from `src`; the ABI read off the source."""
    with open(src) as fh:
        new = "int group" in fh.read()
    return _bind(src, name, NEW_ABI if new else OLD_ABI), new


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

    st = exp_stats(libs["this"][0], v, sign)
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
    calls = {name: exp_launch(lib, new, v, sign, outs[name], G) for name, (lib, new) in libs.items()}
    rec["ms"] = time_graph_ms(calls["this"])
    if "other" in libs:
        turns = [(t, time_graph_ms(calls[t])) for t in ("other", "this", "this", "other")]
        rec["turns"] = turns
        # the earlier design's time per Newton step: one warp of the longest
        # chain free of cycles, less one warp of rows inside the cone
        lib, new = libs["other"]
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
        lib_t, new_t = libs["this"]
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
        lib, new = libs["this"]
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
    calls = {name: box_launch(lib, new, v, bl, bu, outs[name]) for name, (lib, new) in libs.items()}
    rec["ms"] = time_graph_ms(calls["this"])
    if "other" in libs:
        turns = [(t, time_graph_ms(calls[t])) for t in ("other", "this", "this", "other")]
        rec["turns"] = turns
        # the earlier design's steps (its own count) and time per step: its
        # longest problem alone, less a problem of one step (s inside its box)
        lib, new = libs["other"]
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
    for flag in ("--other", "--json"):
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1]
            del argv[i : i + 2]
    groups = "--groups" in argv
    wide = "--no-wide" not in argv
    if not torch.cuda.is_available():
        sys.exit("cone_proto: PyTorch sees no CUDA device; this runs only on the card")
    from ..ops import _kernels  # noqa: PLC0415

    tag = card()
    print(tag)
    libs = {"this": (_kernels.load("cone_proj"), True)}
    print("ptxas: " + " | ".join(
        ln.split(":", 1)[-1].strip() for ln in _kernels.build_log.get("cone_proj", "").splitlines()
        if "registers" in ln or "spill" in ln or "Compiling" in ln))
    if "--other" in opts:
        libs["other"] = bind(opts["--other"], "cone_proj_other")
    dev = torch.device("cuda")
    res = {"card": tag, "exp": [], "box": []}
    for k in EXP_TIMED:
        v = mc.exp_rows(k, seed=k % 1000) * np.where(np.arange(k) % 3 == 0, -1.0, 1.0)[:, None]
        sign = np.where(np.arange(k) % 3 == 0, -1.0, 1.0)
        res["exp"].append(run_exp_case(
            f"proj_exp synthetic (k={k}, 3)", torch.as_tensor(v, dtype=F32, device=dev),
            torch.as_tensor(sign, dtype=F32, device=dev), libs, tag, groups))
    for B, nb, per_row in mc.BOX_CASES:
        v, bl, bu = (torch.as_tensor(a, dtype=F32, device=dev)
                     for a in mc.box_case(B, nb, seed=B + per_row, per_row=per_row))
        res["box"].append(run_box_case(
            f"proj_box synthetic ({B}, {nb + 1}) {'per-row' if per_row else 'shared'} bounds",
            v, bl, bu, libs, tag))
    for cell, cap in capture_solves(wide):
        for ph, (c, v, sign) in cap.phases("exp").items():
            res["exp"].append(run_exp_case(f"proj_exp {cell} {ph} (call {c}) {tuple(v.shape)}",
                                           v, sign, libs, tag, groups))
        for ph, (c, v, bl, bu) in cap.phases("box").items():
            res["box"].append(run_box_case(f"proj_box {cell} {ph} (call {c}) {tuple(v.shape)}",
                                           v, bl, bu, libs, tag))
    if "--json" in opts:
        with open(opts["--json"], "w") as fh:
            json.dump(res, fh, indent=1, default=str)


if __name__ == "__main__":
    main()
