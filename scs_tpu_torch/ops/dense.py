"""Dense matrix-vector products of the dense solver path, single or batched
— the counterpart of scs_tpu's `Core._mv`/`Core._tv` pair and of the two
launchers of tools/gemv_proto.py (`pallas_gemv`, `vpu_gemv`).

  * gemv_rows(M, v)   — M @ v:   y[..., i] = sum_j M[..., i, j] v[..., j]
  * gemv_cols(M, u)   — M.T @ u: y[..., j] = sum_i M[..., i, j] u[..., i],
                        a reduction down the columns of the stored M, so
                        A'y needs no stored transpose of A
  * gemv_rows_ref, gemv_cols_ref — the plain PyTorch versions, written as
                        scs_tpu's own multiply-and-reduce forms

M is (r, c) with a vector, or (B, r, c) with a (B, k) batch of vectors. On
a CUDA tensor a wrapper launches the hand-written kernel of csrc/gemv.cu
(built with nvcc at first use) on the current stream: one launch per call
at every shape, 16-byte loads of M at any width and alignment, nothing
allocated but the output. It counts the launch in its `.launches` and, by
(B, r, c), in its `.shapes`; anything the kernel does not take raises, and
so does a failed build or launch. On a CPU tensor it is the plain version.

gemv_cols splits the rows of a small batch over a thread block cluster of
`cols_cluster(B, r, c, itemsize)` blocks, a function of the shape alone, so
every summation order is fixed by the shape and a repeated call is
bit-equal.
"""

from __future__ import annotations

from collections import Counter

import torch

# gemv_cols: a grid of fewer blocks than this (one matrix, a few column
# tiles) has the rows of each tile split over a cluster of blocks until it
# has about this many; each block keeps at least _MIN_CLUSTER_ROWS rows; 8
# is the portable cluster size. Larger grids gain nothing from a split
# (tools/gemv_proto.py --cluster-sweep)
_CLUSTER_BLOCKS = 64
_MIN_CLUSTER_ROWS = 32
_MAX_CLUSTER = 8

_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}
_FNS = {}  # (kernel name, dtype) -> bound ctypes function


def gemv_rows_ref(M, v):
    """Plain M @ v by multiply and reduce along the last axis."""
    return (M * v[..., None, :]).sum(-1)


def gemv_cols_ref(M, u):
    """Plain M.T @ u by multiply and reduce down the columns."""
    return (M * u[..., :, None]).sum(-2)


def _prepare(who, M, vec, vec_axis):
    """Check what csrc/gemv.cu takes and return (M3, vec2, squeeze): the
    (B, r, c) matrix, the contiguous (B, k) vectors, and whether the caller
    passed a single (r, c) problem."""
    if M.dtype not in _SUFFIX:
        raise TypeError(f"{who}: M must be float32 or float64, got {M.dtype}")
    if vec.dtype != M.dtype:
        raise TypeError(f"{who}: vector dtype {vec.dtype} != M dtype {M.dtype}")
    if vec.device != M.device:
        raise ValueError(f"{who}: vector on {vec.device}, M on {M.device}")
    if M.dim() not in (2, 3) or vec.dim() != M.dim() - 1:
        raise ValueError(
            f"{who}: M must be (r, c) with a vector or (B, r, c) with (B, k) "
            f"vectors, got {tuple(M.shape)} and {tuple(vec.shape)}"
        )
    squeeze = M.dim() == 2
    if squeeze:
        M, vec = M[None], vec[None]
    if vec.shape[0] != M.shape[0] or vec.shape[1] != M.shape[vec_axis]:
        raise ValueError(
            f"{who}: vector shape {tuple(vec.shape)} does not match M "
            f"{tuple(M.shape)}"
        )
    if not M.is_contiguous():
        raise ValueError(f"{who}: M must be contiguous")
    return M, vec.contiguous(), squeeze


def _fn(name, dtype):
    """The C entry point of csrc/gemv.cu for `name` and `dtype`, built,
    loaded and looked up once."""
    fn = _FNS.get((name, dtype))
    if fn is None:
        from . import _kernels  # noqa: PLC0415

        fn = _FNS[(name, dtype)] = getattr(_kernels.load("gemv"), name + _SUFFIX[dtype])
    return fn


def _launch(who, dev, fn, *args):
    """fn(*args, stream) on `dev`'s current stream, entering `dev` only
    when it is not the current device; raises on a failed launch. The raw
    stream handle is read without building a torch.cuda.Stream: the host's
    cost of a call is what the small products wait for."""
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"{who} kernel launch failed: cudaError {rc}")


def gemv_rows(M, v):
    """M @ v; shapes as the module docstring. On CUDA: the gemv_rows kernel."""
    dev = M.device
    if dev.type == "cpu":
        return gemv_rows_ref(M, v)
    if dev.type != "cuda":
        raise ValueError(f"gemv_rows: unsupported device {dev}")
    M3, v2, squeeze = _prepare("gemv_rows", M, v, 2)
    B, r, c = M3.shape
    y = torch.empty((B, r), dtype=M3.dtype, device=dev)
    _launch("gemv_rows", dev, _fn("gemv_rows", M3.dtype),
            M3.data_ptr(), v2.data_ptr(), y.data_ptr(), B, r, c)
    gemv_rows.launches += 1
    gemv_rows.shapes[(B, r, c)] += 1
    return y[0] if squeeze else y


gemv_rows.launches = 0  # kernel launches since the last reset
gemv_rows.shapes = Counter()  # the same launches by (B, r, c)


def cols_cluster(B, r, c, itemsize):
    """Blocks of the thread block cluster gemv_cols splits a (B, r, c)
    product's rows over: 1 when the batch alone fills the card, up to 8 for
    a few tall matrices. A function of the shape and the element size only,
    so a product's summation order never changes from launch to launch."""
    tiles = -(-c // (32 * (16 // itemsize)))  # column tiles of 32 16-byte groups
    want = -(-_CLUSTER_BLOCKS // max(B * tiles, 1))
    return max(1, min(want, r // _MIN_CLUSTER_ROWS, _MAX_CLUSTER))


def gemv_cols(M, u):
    """M.T @ u; shapes as the module docstring. On CUDA: the gemv_cols
    kernel, one launch, its rows split over cols_cluster(...) blocks."""
    dev = M.device
    if dev.type == "cpu":
        return gemv_cols_ref(M, u)
    if dev.type != "cuda":
        raise ValueError(f"gemv_cols: unsupported device {dev}")
    M3, u2, squeeze = _prepare("gemv_cols", M, u, 1)
    B, r, c = M3.shape
    y = torch.empty((B, c), dtype=M3.dtype, device=dev)
    _launch("gemv_cols", dev, _fn("gemv_cols", M3.dtype),
            M3.data_ptr(), u2.data_ptr(), y.data_ptr(), B, r, c,
            cols_cluster(B, r, c, M3.element_size()))
    gemv_cols.launches += 1
    gemv_cols.shapes[(B, r, c)] += 1
    return y[0] if squeeze else y


gemv_cols.launches = 0  # kernel launches since the last reset
gemv_cols.shapes = Counter()  # the same launches by (B, r, c)
