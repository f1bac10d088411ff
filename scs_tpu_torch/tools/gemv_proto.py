"""Batched dense GEMV on the card: the hand-written kernels against
torch.bmm — the counterpart of the entry point of tools/gemv_proto.py.

Times `gemv_rows` (M x), `gemv_cols` (M' u) and `torch.bmm` with TF32 off on
one (B, m, n) float32 batch at the prototype's size (B 128, m 1536, n 1024)
with CUDA events, and prints milliseconds and GB/s for each beside the
card's 3.35 TB/s memory rate, with the card's name and power limit. Needs a
CUDA card:

    python -m scs_tpu_torch.tools.gemv_proto [B m n] [--other OLD_GEMV.cu]

With --other, a second build of the kernels from that source (an earlier
version of ops/csrc/gemv.cu, with the same entry points) is timed against
the package's in turns within the one call: other, this, this, other.

Nothing runs on import.
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import torch

from ..ops.dense import gemv_cols, gemv_cols_ref, gemv_rows, gemv_rows_ref

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def time_ms(fn, reps=30):
    """Median CUDA-event time of `reps` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_sources(other_src, A, x, u):
    """gemv_rows_f32 / gemv_cols_f32 of the package's gemv.cu against the
    build of `other_src`, on the same tensors, in turns."""
    from ..ops import _kernels  # noqa: PLC0415
    from ..ops.dense import cols_splits  # noqa: PLC0415

    libs = {"this": _kernels.load("gemv"), "other": _kernels.load("gemv", other_src)}
    B, m, n = A.shape
    stream = torch.cuda.current_stream().cuda_stream
    splits = cols_splits(B, m, n, 4)
    scratch = torch.empty((B, splits, n), device="cuda")
    y_rows, y_cols = torch.empty((B, m), device="cuda"), torch.empty((B, n), device="cuda")

    def rows(tag):
        rc = libs[tag].gemv_rows_f32(A.data_ptr(), x.data_ptr(), y_rows.data_ptr(), B, m, n, stream)
        assert rc == 0, rc

    def cols(tag):
        rc = libs[tag].gemv_cols_f32(A.data_ptr(), u.data_ptr(), y_cols.data_ptr(),
                                     scratch.data_ptr(), B, m, n, splits, stream)
        assert rc == 0, rc

    for name, fn in (("gemv_rows", rows), ("gemv_cols", cols)):
        turns = [(tag, time_ms(lambda: fn(tag), 50)) for tag in ("other", "this", "this", "other")]
        print(f"{name} f32 ({B}, {m}, {n}): " + ", ".join(f"{t} {ms:.4f} ms" for t, ms in turns))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    other_src = None
    if "--other" in argv:
        i = argv.index("--other")
        other_src = argv[i + 1]
        del argv[i : i + 2]
    B, m, n = (int(a) for a in argv) if argv else (128, 1536, 1024)
    if not torch.cuda.is_available():
        sys.exit("gemv_proto: PyTorch sees no CUDA device; this runs only on the card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    A = torch.randn((B, m, n), generator=gen, device="cuda") / n**0.5
    x = torch.randn((B, n), generator=gen, device="cuda")
    u = torch.randn((B, m), generator=gen, device="cuda")
    ref = torch.einsum("bmn,bn->bm", A.double(), x.double())
    err = float((gemv_rows(A, x).double() - ref).abs().max() / ref.abs().max())
    ref_t = torch.einsum("bmn,bm->bn", A.double(), u.double())
    err_t = float((gemv_cols(A, u).double() - ref_t).abs().max() / ref_t.abs().max())
    print(f"({B}, {m}, {n}) f32: gemv_rows err {err:.2e}, gemv_cols err {err_t:.2e}")
    gb = A.numel() * A.element_size() / 1e9
    moved = (A.numel() + x.numel() + u.numel()) * A.element_size()
    print(f"bound (M, input and output once, at 3.35 TB/s): {moved / HBM_BYTES_PER_S * 1e3:.4f} ms")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        cases = [
            ("gemv_rows kernel", lambda: gemv_rows(A, x)),
            ("gemv_rows plain", lambda: gemv_rows_ref(A, x)),
            ("torch.bmm A x", lambda: torch.bmm(A, x[:, :, None])),
            ("gemv_cols kernel", lambda: gemv_cols(A, u)),
            ("gemv_cols plain", lambda: gemv_cols_ref(A, u)),
            ("torch.bmm A' u", lambda: torch.bmm(u[:, None, :], A)),
        ]
        for name, fn in cases:
            ms = time_ms(fn)
            rate = gb / ms * 1e3
            print(
                f"{name:>18}: {ms:.4f} ms, {rate:.0f} GB/s "
                f"({100 * rate * 1e9 / HBM_BYTES_PER_S:.0f}% of 3.35 TB/s)"
            )
    finally:
        torch.set_float32_matmul_precision(prev)
    if other_src:
        compare_sources(other_src, A, x, u)


if __name__ == "__main__":
    main()
