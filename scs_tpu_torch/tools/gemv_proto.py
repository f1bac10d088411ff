"""Batched dense GEMV on the card: the hand-written kernels against
torch.bmm — the counterpart of the entry point of tools/gemv_proto.py.

    python -m scs_tpu_torch.tools.gemv_proto [B m n] [--main-shapes] [--comp]
        [--other OLD_GEMV.cu] [--variant OTHER_DESIGN.cu ...] [--cluster-sweep]
        [--json PATH]

With B m n (default 128 1536 1024, the prototype's size): `gemv_rows`
(M x), `gemv_cols` (M' u) and torch.bmm with TF32 off on one float32
(B, m, n) batch, timed with CUDA events, in milliseconds and GB/s beside the
card's 3.35 TB/s memory rate.

--main-shapes: every shape at which a main path of the port launches the
kernels (MAIN_SHAPES), and M one element into a buffer (MISALIGNED). For
each kernel at each shape: agreement with the plain version (TOL), a
bit-equal repeat, the device time per call from CUDA-graph replays beside
its bound (M, the input vector and the output, each once, over 3.35 TB/s),
torch.bmm's device time the same way, the plain version's (CUDA events),
and the host time per call of the wrapper and of torch.bmm: a host clock around HOST_CALLS calls back to back,
taken before the one synchronise at the end (fewer calls than the launch
queue holds, so no call waits for the device).

--comp: D1, the compensated products of ops/df32.py (gemv_rows_comp /
gemv_cols_comp), at every shape the high-accuracy paths launch them
(COMP_SHAPES), M one element into its buffer, and rows whose products
cancel: each result against the float64 product (COMP_REL, per problem),
the plain version's too, a bit-equal repeat, the misaligned M against its
aligned copy; device ms from graph replays beside the bound and beside G1 /
G2 at the same shape, and the plain version's ms. With --variant, also D1
of each variant source against the package's, in turns, at the timed
shapes (COMP_TIMED).

--other OLD.cu: a build of the previous gemv.cu design, with its entry
points (`git show c9d2815:scs_tpu_torch/ops/csrc/gemv.cu`: gemv_cols takes
a scratch and a row split, and launches a second kernel when the split is
above 1), timed against the package's build in turns within this call
(other, this, this, other), CUDA-graph replays of the bare entry points at
every main shape. --variant SRC.cu (any number): the same for a source
with the package's entry points (another design of either kernel, or an
earlier build of this one); each line says whether the two builds' results
are bit-equal.
--cluster-sweep: gemv_cols at every main shape under every cluster size
1-8, for the package's build and each variant (what cols_cluster picks
against the alternatives).

Every line carries the card's name and power limit (nvidia-smi). --json
writes the numbers to PATH. Needs a CUDA card; nothing runs on import.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time

import torch

from ..ops import df32
from ..ops.dense import gemv_cols, gemv_cols_ref, gemv_rows, gemv_rows_ref

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# |y_kernel - y_plain| <= TOL * (|M| |v|) elementwise: two summation orders
TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
HOST_CALLS = 200
F32, F64 = torch.float32, torch.float64

# (label, (B, r, c), dtype, kernels launched there): the full batches of the
# flagship (chip_smoke.py phase 8), the wide mixed-cone batch (phase 10)
# and mixed_cone (phase 9), the bucket each of those launches most after
# retirement, and the single dense QP (phase 7, SCS.solve) in f64 and at
# the flagship's width
MAIN_SHAPES = [
    ("flagship A", (512, 1500, 1000), F32, ("rows", "cols")),
    ("flagship P, S^-1", (512, 1000, 1000), F32, ("rows",)),
    ("flagship A, B = 128", (128, 1500, 1000), F32, ("rows", "cols")),
    ("flagship P, S^-1, B = 128", (128, 1000, 1000), F32, ("rows",)),
    ("wide A", (128, 5313, 1771), F32, ("rows", "cols")),
    ("wide S^-1", (128, 1771, 1771), F32, ("rows",)),
    ("wide A, B = 32", (32, 5313, 1771), F32, ("rows", "cols")),
    ("wide S^-1, B = 32", (32, 1771, 1771), F32, ("rows",)),
    ("mixed_cone A", (64, 185, 61), F32, ("rows", "cols")),
    ("mixed_cone S^-1", (64, 61, 61), F32, ("rows",)),
    ("mixed_cone A, B = 32", (32, 185, 61), F32, ("rows", "cols")),
    ("mixed_cone S^-1, B = 32", (32, 61, 61), F32, ("rows",)),
    ("single dense A f64", (1, 300, 200), F64, ("rows", "cols")),
    ("single dense P, S^-1 f64", (1, 200, 200), F64, ("rows",)),
    ("single dense A", (1, 1500, 1000), F32, ("rows", "cols")),
]
# M a contiguous view one element into its buffer: every row 4 bytes past a
# 16-byte boundary
MISALIGNED = ("flagship A, one element in", (512, 1500, 1000), F32, ("rows", "cols"))

# D1, float32 only: the hi_acc cell's A and P (chip_smoke.py phase 11), the
# single dense QP's A (phase 7), a batch of dots (mv on (B, 1, k)), ragged
# widths (rows of <= 16 groups, rows too long to stage x for)
COMP_SHAPES = [
    ("hi_acc A", (32, 1500, 1000), ("rows", "cols")),
    ("hi_acc P", (32, 1000, 1000), ("rows",)),
    ("single dense A", (1, 1500, 1000), ("rows", "cols")),
    ("hi_acc dots", (32, 1, 1000), ("rows",)),
    ("ragged", (5, 1501, 1771), ("rows", "cols")),
    ("ragged, narrow", (7, 185, 61), ("rows", "cols")),
    ("ragged, x not staged", (3, 20, 4099), ("rows", "cols")),
]
COMP_MISALIGNED = ("hi_acc A, one element in", (32, 1500, 1000), ("rows", "cols"))
# a single dot's relative error is its condition number times the rounding
# of any sum that is not compensated: on such rows (the dots, the cancelling
# case) the plain version and G1/G2 are reported, not held to COMP_REL
# the hi_acc A with products that cancel: half of each row (column) is the
# negated other half, times a vector 2^-10 apart, so the result is ~4e4
# times smaller than the sum of the products' magnitudes. A plain f32 sum,
# or a p-stream whose additions were contracted into the products, is off
# by ~1e-4 relative there; the compensated kernel must still meet COMP_REL
COMP_CANCEL = ("hi_acc A, cancelling", (32, 1500, 1000), ("rows", "cols"))
# the shapes D1 is timed at: the hi_acc cell's A and P, the single QP's A
COMP_TIMED = ("hi_acc A", "hi_acc P", "single dense A")
# relative error against the float64 product, per problem, in norm
# (tests/test_hi_accuracy.py::test_df32_matvec_accuracy)
COMP_REL = 5e-7
# operations per element of M: the product, its error by FMA, the TwoSum of
# the p-stream (6) and the two additions into the companion sum
COMP_FLOPS = 11


def card():
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps=30, inner=1):
    """Median over `reps` CUDA-event pairs of the time per call of `inner`
    calls in a row, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def time_graph_ms(fn, reps=20, inner=10):
    """Device time per call of fn: `inner` calls captured into a CUDA graph,
    the replays timed with events (median of `reps`), so the host's cost of
    a call is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture requires
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    ms = time_ms(graph.replay, reps) / inner
    del graph
    return ms


def host_us(fn, calls=HOST_CALLS):
    """Host time per call: a host clock around `calls` calls back to back,
    read before the one synchronise at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def gemv_bound_ms(shape, dtype):
    """Bound of one batched GEMV over M (B, r, c): M, the input vectors and
    the output once, over the memory rate (the operations, 2 per element
    of M, take less on every shape here)."""
    B, r, c = shape
    item = torch.empty((), dtype=dtype).element_size()
    return (B * r * c + B * (r + c)) * item / HBM_BYTES_PER_S * 1e3


def make_inputs(shape, dtype, gen, offset=0):
    """M (B, r, c) scaled by 1/sqrt(c), v (B, c), u (B, r) on the card; M
    starts `offset` elements into its buffer."""
    B, r, c = shape
    buf = torch.randn(offset + B * r * c, generator=gen, device="cuda", dtype=dtype) / c**0.5
    M = buf[offset:].view(B, r, c)
    v = torch.randn((B, c), generator=gen, device="cuda", dtype=dtype)
    u = torch.randn((B, r), generator=gen, device="cuda", dtype=dtype)
    return M, v, u


def _ops(which, M, v, u):
    if which == "rows":
        return gemv_rows, gemv_rows_ref, v, lambda: torch.bmm(M, v[:, :, None])
    return gemv_cols, gemv_cols_ref, u, lambda: torch.bmm(u[:, None, :], M)


def row_shifts(M):
    """Elements past a 16-byte boundary at which M's rows start (the kernels
    funnel every shift out of aligned 16-byte loads)."""
    B, r, c = M.shape
    per = 16 // M.element_size()
    first = M.data_ptr() // M.element_size()
    return sorted({(first + i * c) % per for i in range(min(B * r, per))})


def check_shape(shape, dtype, kernels, gen, timed=True, offset=0, plain=False, M=None):
    """One shape: for each kernel, agreement with its plain version within
    TOL, a bit-equal repeat, B = 1 equal to the 2-D call, exactly one launch
    per call, and (offset) whether the result equals that of an aligned copy;
    then, if timed, device ms (graphs), bound, torch.bmm ms, host us per call
    (and the plain version's ms if `plain`). M: a (B, r, c) matrix of this
    shape and dtype already on the card (a solver's own) instead of a random
    one; the vectors are random either way. Returns {kernel: {...}}."""
    if M is None:
        M, v, u = make_inputs(shape, dtype, gen, offset)
    else:
        B, r, c = shape
        v = torch.randn((B, c), generator=gen, device=M.device, dtype=dtype)
        u = torch.randn((B, r), generator=gen, device=M.device, dtype=dtype)
    Mabs = M.abs()
    out = {}
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        for which in kernels:
            kern, ref, vec, lib = _ops(which, M, v, u)
            before = kern.launches
            y = kern(M, vec)
            y_again = kern(M, vec)
            if kern.launches != before + 2:
                raise AssertionError(f"gemv_{which} {shape}: {kern.launches - before} launches in 2 calls")
            y_p = ref(M, vec)
            lim = TOL[dtype] * ref(Mabs, vec.abs())
            torch.cuda.synchronize()
            err = (y - y_p).abs()
            if not bool(torch.all(err <= lim)):
                raise AssertionError(
                    f"gemv_{which} {shape} {dtype}: kernel disagrees with plain "
                    f"version (excess {float((err - lim).max()):.3e})"
                )
            del y_p, lim
            if not torch.equal(y, y_again):
                raise AssertionError(f"gemv_{which} {shape} {dtype}: a repeated launch differs")
            if shape[0] == 1 and not torch.equal(kern(M[0], vec[0]), y[0]):
                raise AssertionError(f"gemv_{which} {shape} {dtype}: 2-D call differs from B = 1")
            rec = {"max_abs_err": float(err.max()), "load_bytes": 16, "row_shifts": row_shifts(M)}
            if offset:
                rec["equals_aligned_copy"] = torch.equal(kern(M.clone(), vec), y)
            if timed:
                rec.update(
                    ms=time_graph_ms(lambda: kern(M, vec)),
                    bound_ms=gemv_bound_ms(shape, dtype),
                    bmm_ms=time_graph_ms(lib),
                    host_us=host_us(lambda: kern(M, vec)),
                    bmm_host_us=host_us(lib),
                )
                if plain:
                    rec["plain_ms"] = time_ms(lambda: ref(M, vec), reps=5)
            out[which] = rec
    finally:
        torch.set_float32_matmul_precision(prev)
    return out


def fmt(label, shape, dtype, which, rec, tag):
    """One report line for check_shape's record."""
    line = (f"{label} {shape} {str(dtype)[6:]} gemv_{which}: max |err| {rec['max_abs_err']:.3e} "
            f"within {TOL[dtype]:g}*|M||v|, repeat bit-equal, {rec['load_bytes']}-byte loads "
            f"(row shifts {rec['row_shifts']})")
    if "equals_aligned_copy" in rec:
        line += f", equal to the aligned copy: {rec['equals_aligned_copy']}"
    if "ms" in rec:
        line += (f"; device {rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                 f"({100 * rec['bound_ms'] / rec['ms']:.0f}%), torch.bmm {rec['bmm_ms']:.4f} ms; "
                 f"host {rec['host_us']:.1f} us per call (torch.bmm {rec['bmm_host_us']:.1f})")
    if "plain_ms" in rec:
        line += f"; plain {rec['plain_ms']:.4f} ms"
    return f"{line} [{tag}]"


def main_shapes(tag, dtypes=(F32, F64)):
    """check_shape at every main shape and the misaligned case: timed (with
    the plain version) in the shape's own dtype, checked in every dtype of
    `dtypes`."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = []
    for label, shape, dtype, kernels in [*MAIN_SHAPES, MISALIGNED]:
        offset = 1 if label == MISALIGNED[0] else 0
        for dt in dtypes:
            rec = check_shape(shape, dt, kernels, gen, timed=dt == dtype, offset=offset,
                              plain=dt == dtype)
            for which, r in rec.items():
                print(fmt(label, shape, dt, which, r, tag), flush=True)
                res.append({"label": label, "shape": shape, "dtype": str(dt)[6:],
                            "kernel": f"gemv_{which}", **r})
            torch.cuda.empty_cache()
    return res


def _cancelling(M, vec, axis):
    """Make half of M along `axis` (1: rows, 2: columns) the negated other
    half and the matching half of vec the other half times 1 + 2^-10."""
    h = M.shape[axis] // 2
    if axis == 2:
        M[:, :, h : 2 * h] = -M[:, :, :h]
    else:
        M[:, h : 2 * h, :] = -M[:, :h, :]
    vec[:, h : 2 * h] = (vec[:, :h].double() * (1 + 2.0**-10)).float()


def _rel_per_problem(y, exact):
    """Largest ||y_b - exact_b|| / ||exact_b|| over the batch."""
    num = torch.linalg.vector_norm(y.double() - exact, dim=-1)
    return float((num / torch.linalg.vector_norm(exact, dim=-1)).max())


def check_comp(shape, kernels, gen, timed=True, offset=0, cancel=False):
    """D1 at one float32 shape: for each kernel, one launch per call, the
    result and the plain version's against the float64 product (COMP_REL
    per problem; the plain version is held to it where a problem's output
    is a vector and does not cancel), the plain G1/G2's error beside, a bit-equal repeat, and
    (offset) the result on an aligned copy of M; then, if timed, device ms
    (graph replays) beside the bound, G1/G2's device ms at the shape and the
    plain version's ms (CUDA events). Returns {kernel: {...}}."""
    M, v, u = make_inputs(shape, F32, gen, offset)
    out = {}
    for which in kernels:
        if which == "rows":
            kern, ref, plain_gemv, vec = df32.mv, df32.mv_ref, gemv_rows, v.clone()
        else:
            kern, ref, plain_gemv, vec = df32.tv, df32.tv_ref, gemv_cols, u.clone()
        Mk = M.clone() if cancel else M
        if cancel:
            _cancelling(Mk, vec, 2 if which == "rows" else 1)
        before = kern.launches
        y = kern(Mk, vec)
        y_again = kern(Mk, vec)
        if kern.launches != before + 2:
            raise AssertionError(f"D1 {which} {shape}: {kern.launches - before} launches in 2 calls")
        Md, vd = Mk.double(), vec.double()
        exact = ((Md @ vd[:, :, None])[:, :, 0] if which == "rows"
                 else (vd[:, None, :] @ Md)[:, 0, :])
        del Md
        y_p = ref(Mk, vec)
        rec = {
            "rel_err": _rel_per_problem(y, exact),
            "plain_rel_err": _rel_per_problem(y_p, exact),
            "gemv_rel_err": _rel_per_problem(plain_gemv(Mk, vec), exact),
            "max_abs_err": float((y - y_p).abs().max()),
        }
        del exact, y_p
        plain_held = not cancel and y.shape[-1] > 1
        if rec["rel_err"] > COMP_REL or (plain_held and rec["plain_rel_err"] > COMP_REL):
            raise AssertionError(f"D1 {which} {shape} (cancelling {cancel}): {rec}")
        if not torch.equal(y, y_again):
            raise AssertionError(f"D1 {which} {shape}: a repeated launch differs")
        if offset:
            rec["equals_aligned_copy"] = torch.equal(kern(Mk.clone(), vec), y)
            if not rec["equals_aligned_copy"]:
                raise AssertionError(f"D1 {which} {shape}: misaligned M differs from its aligned copy")
        if timed:
            B, r, c = shape
            n_out = r if which == "rows" else c
            by = (B * r * c + B * (r + c - n_out) + B * n_out) * 4 / HBM_BYTES_PER_S
            op = COMP_FLOPS * B * r * c / 67e12
            rec.update(
                ms=time_graph_ms(lambda: kern(Mk, vec)),
                bound_ms=max(by, op) * 1e3,
                bound_by="bytes" if by >= op else "operations",
                gemv_ms=time_graph_ms(lambda: plain_gemv(Mk, vec)),
                plain_ms=time_ms(lambda: ref(Mk, vec), reps=5),
            )
        out[which] = rec
        del Mk
    return out


def fmt_comp(label, shape, which, rec, tag):
    """One report line for check_comp's record."""
    line = (f"D1 {label} {shape} f32 df32.{'mv' if which == 'rows' else 'tv'}: relative error "
            f"against f64 {rec['rel_err']:.2e} (limit {COMP_REL:g}; plain version "
            f"{rec['plain_rel_err']:.2e}, plain G{'1' if which == 'rows' else '2'} "
            f"{rec['gemv_rel_err']:.2e}), max |kernel - plain| {rec['max_abs_err']:.3e}, "
            f"repeat bit-equal")
    if "equals_aligned_copy" in rec:
        line += f", equal to the aligned copy: {rec['equals_aligned_copy']}"
    if "ms" in rec:
        line += (f"; device {rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
                 f"{100 * rec['bound_ms'] / rec['ms']:.0f}%), G{'1' if which == 'rows' else '2'} at the "
                 f"shape {rec['gemv_ms']:.4f} ms; plain {rec['plain_ms']:.4f} ms")
    return f"{line} [{tag}]"


def comp_shapes(tag, timed_labels=None, prefix=""):
    """check_comp at every COMP_SHAPES shape, the misaligned and the
    cancelling case; timed where the label is in `timed_labels` (all when
    None); each line starts with `prefix`. Returns {(label, kernel):
    record}."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    res = {}
    cases = [(*c, 0, False) for c in COMP_SHAPES]
    cases += [(*COMP_MISALIGNED, 1, False), (*COMP_CANCEL, 0, True)]
    for label, shape, kernels, offset, cancel in cases:
        timed = timed_labels is None or label in timed_labels
        rec = check_comp(shape, kernels, gen, timed=timed, offset=offset, cancel=cancel)
        for which, r in rec.items():
            print(prefix + fmt_comp(label, shape, which, r, tag), flush=True)
            res[(label, which)] = r
        torch.cuda.empty_cache()
    return res


def compare_comp_sources(tag, variants):
    """D1 of each variant source (with the package's entry points) against
    the package's build at the COMP_TIMED shapes: bare entry points in CUDA
    graphs, in turns (variant, this, this, variant), after checking that
    the two give the same bits."""
    from ..ops import _kernels  # noqa: PLC0415
    from ..ops.dense import cols_cluster  # noqa: PLC0415

    abi = {"gemv_rows_comp_f32": [_VP, _VP, _VP, _I, _I, _I, _VP],
           "gemv_cols_comp_f32": [_VP, _VP, _VP, _I, _I, _I, _I, _VP]}
    libs = {"this": _kernels.load("gemv")}
    for k, src in enumerate(variants):
        libs[f"variant {src.rsplit('/', 1)[-1]}"] = _bind(src, f"gemv_variant{k}", abi)
    gen = torch.Generator(device="cuda").manual_seed(6)
    res = []
    for label, shape, kernels in COMP_SHAPES:
        if label not in COMP_TIMED:
            continue
        M, v, u = make_inputs(shape, F32, gen)
        B, r, c = shape
        for which in kernels:
            vec, n_out = (v, r) if which == "rows" else (u, c)
            ys = {name: torch.empty((B, n_out), device="cuda") for name in libs}

            def call(name, which=which, vec=vec, ys=ys):
                stream = torch.cuda.current_stream().cuda_stream
                if which == "rows":
                    fn = libs[name].gemv_rows_comp_f32
                    return fn(M.data_ptr(), vec.data_ptr(), ys[name].data_ptr(), B, r, c, stream)
                fn = libs[name].gemv_cols_comp_f32
                return fn(M.data_ptr(), vec.data_ptr(), ys[name].data_ptr(), B, r, c,
                          cols_cluster(B, r, c, 4), stream)

            for name in libs:
                if call(name) != 0:
                    raise AssertionError(f"D1 {which} {shape}: {name} launch failed")
            for alt in libs:
                if alt == "this":
                    continue
                same = torch.equal(ys[alt], ys["this"])
                turns = [(t, time_graph_ms(lambda t=t: call(t))) for t in (alt, "this", "this", alt)]
                print(f"in turns, D1 {label} {shape} {which}: "
                      + ", ".join(f"{t} {ms:.4f} ms" for t, ms in turns)
                      + f"; bit-equal: {same} [{tag}]", flush=True)
                res.append({"label": label, "shape": shape, "kernel": f"D1 {which}",
                            "against": alt, "turns": turns, "bit_equal": same})
        del M, v, u
        torch.cuda.empty_cache()
    return res


def _old_splits(B, r, c, itemsize):
    """The row ranges the previous design's gemv_cols (commit c9d2815) cut a
    product into: its cols_splits."""
    vec = 16 // itemsize
    per_tile = 32 * (vec if c % vec == 0 else 1)
    want = -(-528 // max(B * -(-c // per_tile), 1))
    return max(1, min(want, r // 64, 64))


def _bind(path, name, symbols):
    """ctypes library built from `path` with the given {symbol: argtypes}."""
    from ..ops import _kernels  # noqa: PLC0415

    lib = ctypes.CDLL(_kernels.build(name, path))
    for sym, argtypes in symbols.items():
        fn = getattr(lib, sym)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


_VP, _I = ctypes.c_void_p, ctypes.c_int


def compare_sources(tag, other_src=None, variants=()):
    """The package's build against an earlier source (other_src, with the
    previous design's entry points) and against other designs with the package's entry points
    (variants), bare entry points captured in CUDA graphs, in turns: alt,
    this, this, alt. Each build's output is first held against this one's."""
    from ..ops import _kernels  # noqa: PLC0415
    from ..ops.dense import cols_cluster  # noqa: PLC0415

    new_abi = {f"gemv_rows_{s}": [_VP, _VP, _VP, _I, _I, _I, _VP] for s in ("f32", "f64")}
    new_abi |= {f"gemv_cols_{s}": [_VP, _VP, _VP, _I, _I, _I, _I, _VP] for s in ("f32", "f64")}
    libs = {"this": (_kernels.load("gemv"), True)}
    if other_src:
        old_abi = dict(new_abi)
        old_abi |= {f"gemv_cols_{s}": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP] for s in ("f32", "f64")}
        libs["other"] = (_bind(other_src, "gemv_other", old_abi), False)
    for k, src in enumerate(variants):
        libs[f"variant {src.rsplit('/', 1)[-1]}"] = (_bind(src, f"gemv_variant{k}", new_abi), True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    res = []
    for label, shape, dtype, kernels in [*MAIN_SHAPES, MISALIGNED]:
        M, v, u = make_inputs(shape, dtype, gen, 1 if label == MISALIGNED[0] else 0)
        B, r, c = shape
        item = M.element_size()
        sfx = "_f32" if dtype == F32 else "_f64"
        cluster = cols_cluster(B, r, c, item)
        splits = _old_splits(B, r, c, item)
        scratch = torch.empty((B, splits, c), dtype=dtype, device="cuda") if splits > 1 else None

        def call(which, name, y):
            lib, is_new = libs[name]
            stream = torch.cuda.current_stream().cuda_stream
            if which == "rows":
                return getattr(lib, "gemv_rows" + sfx)(
                    M.data_ptr(), v.data_ptr(), y.data_ptr(), B, r, c, stream)
            if is_new:
                return getattr(lib, "gemv_cols" + sfx)(
                    M.data_ptr(), u.data_ptr(), y.data_ptr(), B, r, c, cluster, stream)
            return getattr(lib, "gemv_cols" + sfx)(
                M.data_ptr(), u.data_ptr(), y.data_ptr(),
                scratch.data_ptr() if scratch is not None else None, B, r, c, splits, stream)

        for which in kernels:
            n_out = r if which == "rows" else c
            y_this = torch.empty((B, n_out), dtype=dtype, device="cuda")
            y_alt = torch.empty_like(y_this)
            if call(which, "this", y_this) != 0:
                raise AssertionError(f"gemv_{which} {shape}: launch failed")
            _, ref, vec, _ = _ops(which, M, v, u)
            lim = 2 * TOL[dtype] * ref(M.abs(), vec.abs())
            for alt in libs:
                if alt == "this":
                    continue
                if call(which, alt, y_alt) != 0:
                    raise AssertionError(f"gemv_{which} {shape}: {alt} launch failed")
                if not bool(torch.all((y_alt - y_this).abs() <= lim)):
                    raise AssertionError(f"gemv_{which} {shape}: {alt} build disagrees")
                same = torch.equal(y_alt, y_this)
                turns = [
                    (t, time_graph_ms(lambda t=t: call(which, t, y_alt if t == alt else y_this)))
                    for t in (alt, "this", "this", alt)
                ]
                print(f"in turns, {label} {shape} {str(dtype)[6:]} gemv_{which}: "
                      + ", ".join(f"{t} {ms:.4f} ms" for t, ms in turns)
                      + f"; bound {gemv_bound_ms(shape, dtype):.4f} ms; bit-equal: {same} [{tag}]",
                      flush=True)
                res.append({"label": label, "shape": shape, "kernel": f"gemv_{which}",
                            "against": alt, "turns": turns, "bit_equal": same})
            del lim, y_this, y_alt
        del M, v, u, scratch
        torch.cuda.empty_cache()
    return res


def cluster_sweep(tag, variants=()):
    """gemv_cols at every main shape with every cluster size 1-8 (bare entry
    points captured in CUDA graphs), for the package's build and each
    variant: what cols_cluster's choice costs against the others."""
    from ..ops import _kernels  # noqa: PLC0415
    from ..ops.dense import cols_cluster  # noqa: PLC0415

    cols_abi = {f"gemv_cols_{s}": [_VP, _VP, _VP, _I, _I, _I, _I, _VP] for s in ("f32", "f64")}
    libs = {"this": _kernels.load("gemv")}
    for k, src in enumerate(variants):
        libs[f"variant {src.rsplit('/', 1)[-1]}"] = _bind(src, f"gemv_variant{k}", cols_abi)
    gen = torch.Generator(device="cuda").manual_seed(3)
    res = []
    for label, shape, dtype, kernels in MAIN_SHAPES:
        if "cols" not in kernels:
            continue
        M, _, u = make_inputs(shape, dtype, gen)
        B, r, c = shape
        y = torch.empty((B, c), dtype=dtype, device="cuda")
        sfx = "_f32" if dtype == F32 else "_f64"
        for name, lib in libs.items():
            fn = getattr(lib, "gemv_cols" + sfx)
            times = {
                k: time_graph_ms(lambda k=k: fn(M.data_ptr(), u.data_ptr(), y.data_ptr(), B, r, c, k,
                                                torch.cuda.current_stream().cuda_stream))
                for k in range(1, 9)
            }
            print(f"cluster sweep, {label} {shape} {str(dtype)[6:]} {name}: "
                  + ", ".join(f"{k}: {ms:.4f}" for k, ms in times.items())
                  + f" ms; cols_cluster picks {cols_cluster(B, r, c, M.element_size())} [{tag}]", flush=True)
            res.append({"label": label, "shape": shape, "lib": name, "ms": times})
        del M, u, y
        torch.cuda.empty_cache()
    return res


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    opts, variants = {}, []
    while "--variant" in argv:
        i = argv.index("--variant")
        variants.append(argv[i + 1])
        del argv[i : i + 2]
    for flag in ("--other", "--json"):
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1]
            del argv[i : i + 2]
    main_mode = "--main-shapes" in argv
    if main_mode:
        argv.remove("--main-shapes")
    comp_mode = "--comp" in argv
    if comp_mode:
        argv.remove("--comp")
    sweep_mode = "--cluster-sweep" in argv
    if sweep_mode:
        argv.remove("--cluster-sweep")
    if not torch.cuda.is_available():
        sys.exit("gemv_proto: PyTorch sees no CUDA device; this runs only on the card")
    tag = card()
    print(tag)
    out = {"card": tag}
    if main_mode:
        out["main_shapes"] = main_shapes(tag)
    if comp_mode:
        out["comp"] = [{"label": k[0], "kernel": k[1], **r} for k, r in comp_shapes(tag).items()]
    if not (main_mode or comp_mode):
        B, m, n = (int(a) for a in argv) if argv else (128, 1536, 1024)
        rec = check_shape((B, m, n), F32, ("rows", "cols"),
                          torch.Generator(device="cuda").manual_seed(0), plain=True)
        for which, r in rec.items():
            print(fmt("prototype", (B, m, n), F32, which, r, tag))
        out["shape"] = rec
    if "--other" in opts or variants:
        out["turns"] = compare_sources(tag, opts.get("--other"), variants)
    if comp_mode and variants:
        out["comp_turns"] = compare_comp_sources(tag, variants)
    if sweep_mode:
        out["cluster_sweep"] = cluster_sweep(tag, variants)
    if "--json" in opts:
        with open(opts["--json"], "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
