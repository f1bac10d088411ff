"""Block-ELL SpMV on the card: the hand-written kernel alone, at the shapes
of the bench cells — the SpMV's counterpart of tools/gemv_proto.py.

Times `bell_spmv` / `bell_spmv_batched` and their plain versions with CUDA
events on random packs of the shapes the main paths use, f32 and f64, and
prints milliseconds and GB/s beside the bound (pack, cols, x and y once at
the card's 3.35 TB/s), with the card's name and power limit and the
compiler's report (registers, spills, shared memory). A kernel's time
depends on the pack's shape, not on its values, so the packs are drawn on
the device: random tiles, distinct random block columns per block-row.

  bell A        (235, 7, 128, 128)      the `bell` cell's A, 157 block columns
  bell A^T      (157, 18, 128, 128)     its A^T, 235 block columns
  wide          (63, 47, 32, 32)        every tile touched (w = nbc)
  batch A       (8, 240, 7, 128, 128)   the `bell_batch` cell's stacked A
  batch A^T     (8, 160, 17, 128, 128)  its stacked A^T

Needs a CUDA card:

    python -m scs_tpu_torch.tools.spmv_proto [name ...] [--other OTHER.cu ...] [--padded OLD.cu]

With --other (any number of them), a second build from that source, with
the package's entry points, is timed against the package's
ops/csrc/bell_spmv.cu in turns within the one call (others, this, this,
others reversed; medians of 50 event pairs around 10 launches each) and
every output is held against the plain version. --padded does the same
for a source with the entry points of the kernel's first design
(`git show 0fcbb0d:scs_tpu_torch/ops/csrc/bell_spmv.cu`): x padded to whole
tiles, no x_len on the single entry points, no x_stride. Names pick packs
of the table above (default: all).

Nothing runs on import.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import torch

from ..ops.sparse import (
    bell_spmv,
    bell_spmv_batched,
    bell_spmv_batched_ref,
    bell_spmv_ref,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TOL = {torch.float32: 1e-5, torch.float64: 1e-13}  # x |A||x|, elementwise

# name -> (pack shape, block columns)
SHAPES = {
    "bell A": ((235, 7, 128, 128), 157),
    "bell A^T": ((157, 18, 128, 128), 235),
    "wide": ((63, 47, 32, 32), 47),
    "batch A": ((8, 240, 7, 128, 128), 160),
    "batch A^T": ((8, 160, 17, 128, 128), 240),
}


def time_ms(fn, reps=50, inner=10):
    """Median over `reps` CUDA-event pairs of the time per call of `inner`
    calls in a row, after one warm-up call. Several calls per pair keep the
    device's queue ahead of the host, so the time is the device's and not
    the host's gap between an event and a launch."""
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


def random_pack(shape, nbc, dtype, gen):
    """(blocks, cols, x) on the card: random tiles, `width` distinct block
    columns per block-row, x of nbc * bs elements."""
    *lead, width, bs, _ = shape
    blocks = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    order = torch.rand((*lead, nbc), generator=gen, device="cuda").argsort(-1)
    cols = order[..., :width].to(torch.int32).contiguous()
    x = torch.randn((*lead[:-1], nbc * bs), generator=gen, device="cuda", dtype=dtype)
    return blocks, cols, x


def bound_ms(blocks, cols, x):
    n_bytes = (
        blocks.numel() * blocks.element_size() + cols.numel() * 4
        + (x.numel() + blocks.numel() // (blocks.shape[-1] * blocks.shape[-3])) * x.element_size()
    )
    return n_bytes / HBM_BYTES_PER_S * 1e3


def _bind_padded_abi(lib):
    """Entry points of the first design: (blocks, cols, x, y, nbr, width,
    bs, stream) and (blocks, cols, x, y, batch, nbr, width, bs, x_len,
    stream)."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    for sym in ("bell_spmv_f32", "bell_spmv_f64"):
        getattr(lib, sym).argtypes = [vp, vp, vp, vp, i, i, i, vp]
    for sym in ("bell_spmv_batched_f32", "bell_spmv_batched_f64"):
        getattr(lib, sym).argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]


def raw_launcher(lib, blocks, cols, x, y, padded_abi):
    """A closure launching `lib`'s entry point for this pack on the current
    stream into y, without the wrapper (both builds pay the same host cost)."""
    suffix = "_f32" if blocks.dtype == torch.float32 else "_f64"
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (blocks.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr())
    if blocks.dim() == 4:
        nbr, width, bs, _ = blocks.shape
        fn = getattr(lib, "bell_spmv" + suffix)
        args = (nbr, width, bs) if padded_abi else (nbr, width, bs, x.shape[0])
    else:
        B, nbr, width, bs, _ = blocks.shape
        fn = getattr(lib, "bell_spmv_batched" + suffix)
        args = (B, nbr, width, bs, x.shape[1])
        if not padded_abi:
            args += (x.stride(0),)

    def launch():
        rc = fn(*ptrs, *args, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError {rc}")

    return launch


def run_case(name, dtype, gen, libs):
    """`libs`: tag -> (library, padded_abi); "this" is the package's."""
    shape, nbc = SHAPES[name]
    blocks, cols, x = random_pack(shape, nbc, dtype, gen)
    batched = blocks.dim() == 5
    kern, plain = (bell_spmv_batched, bell_spmv_batched_ref) if batched else (bell_spmv, bell_spmv_ref)
    y_p = plain(blocks, cols, x)
    limit = TOL[dtype] * plain(blocks.abs(), cols, x.abs())
    y_k = kern(blocks, cols, x)
    torch.cuda.synchronize()
    err = (y_k - y_p).abs()
    if not bool(torch.all(err <= limit)):
        raise AssertionError(f"{name} {dtype}: kernel disagrees with its plain version")
    if not torch.equal(y_k, kern(blocks, cols, x)):
        raise AssertionError(f"{name} {dtype}: a repeated launch differs")
    k_ms, p_ms = time_ms(lambda: kern(blocks, cols, x)), time_ms(lambda: plain(blocks, cols, x))
    gb = blocks.numel() * blocks.element_size() / 1e9
    b_ms = bound_ms(blocks, cols, x)
    print(
        f"{name} {tuple(shape)} {str(dtype)[6:]}: kernel {k_ms:.4f} ms ({gb / k_ms * 1e3:.0f} GB/s, "
        f"{100 * b_ms / k_ms:.0f}% of the bound {b_ms:.4f} ms), plain {p_ms:.4f} ms, "
        f"max |err| {float(err.max()):.3e} within {TOL[dtype]:g}*|A||x|, repeat bit-equal"
    )
    if len(libs) > 1:
        y = torch.empty_like(y_p)
        launch = {
            tag: raw_launcher(lib, blocks, cols, x, y, padded) for tag, (lib, padded) in libs.items()
        }
        others = [t for t in launch if t != "this"]
        for tag in others:
            y.zero_()
            launch[tag]()
            torch.cuda.synchronize()
            if not bool(torch.all((y - y_p).abs() <= limit)):
                raise AssertionError(f"{name} {dtype}: build {tag} disagrees with the plain version")
        order = others + ["this", "this"] + others[::-1]
        turns = [(tag, time_ms(launch[tag])) for tag in order]
        print("    in turns: " + ", ".join(f"{t} {ms:.4f} ms" for t, ms in turns))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    sources = []  # (source path, padded_abi)
    for flag, padded in (("--other", False), ("--padded", True)):
        while flag in argv:
            i = argv.index(flag)
            sources.append((argv[i + 1], padded))
            del argv[i : i + 2]
    names = argv or list(SHAPES)
    if not torch.cuda.is_available():
        sys.exit("spmv_proto: PyTorch sees no CUDA device; this runs only on the card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    from ..ops import _kernels  # noqa: PLC0415

    libs = {"this": (_kernels.load("bell_spmv"), False)}
    print("ptxas (this): " + " | ".join(
        ln.strip() for ln in _kernels.build_log.get("bell_spmv", "").splitlines()
        if "registers" in ln or "spill" in ln
    ))
    for k, (src, padded) in enumerate(sources):
        lib = _kernels.load("bell_spmv", src)
        if padded:
            _bind_padded_abi(lib)
        libs[f"other{k}"] = (lib, padded)
        print(f"other{k}: {src}" + (" (padded-x entry points)" if padded else ""))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in names:
        for dtype in (torch.float32, torch.float64):
            run_case(name, dtype, gen, libs)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
