"""Build and bind the package's hand-written CUDA kernels.

Each kernel source in `csrc/` is compiled with nvcc into a shared library
with a plain C interface and loaded with ctypes: no PyTorch headers are
compiled, so a build takes seconds. Libraries go to `scs_tpu_torch/_build/`
(listed in .gitignore), named by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is reused. The build happens
at the first launch, never at import: machines without a CUDA toolkit
(the CPU test runs) import this module freely.

There is no fallback: a missing nvcc, a failed build or a missing symbol
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# C entry points per kernel source: name -> argtypes. Pointers and the
# stream are c_void_p (a plain int would be cut to 32 bits); sizes c_int.
_VP, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SYMBOLS = {
    "bell_spmv": {
        # (blocks, cols, x, y, nbr, width, bs, x_len, stream)
        "bell_spmv_f32": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
        "bell_spmv_f64": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
        # (blocks, cols, x, y, batch, nbr, width, bs, x_len, x_stride, stream)
        "bell_spmv_batched_f32": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
        "bell_spmv_batched_f64": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
    },
    "gemv": {
        # (M, x, y, batch, rows, cols, stream)
        "gemv_rows_f32": [_VP, _VP, _VP, _I, _I, _I, _VP],
        "gemv_rows_f64": [_VP, _VP, _VP, _I, _I, _I, _VP],
        # (M, u, y, batch, rows, cols, cluster, stream)
        "gemv_cols_f32": [_VP, _VP, _VP, _I, _I, _I, _I, _VP],
        "gemv_cols_f64": [_VP, _VP, _VP, _I, _I, _I, _I, _VP],
        # D1, the compensated products of ops/df32.py: the same arguments
        "gemv_rows_comp_f32": [_VP, _VP, _VP, _I, _I, _I, _VP],
        "gemv_cols_comp_f32": [_VP, _VP, _VP, _I, _I, _I, _I, _VP],
    },
    "cone_proj": {
        # (v, sign or null, out, evals, steps, cycles (each or null), k, group,
        #  explim, stream)
        "proj_exp_f32": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _D, _VP],
        "proj_exp_f64": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _D, _VP],
        # (v, a, sign or null, out, iters or null, k, stream)
        "proj_pow_f32": [_VP, _VP, _VP, _VP, _VP, _I, _VP],
        "proj_pow_f64": [_VP, _VP, _VP, _VP, _VP, _I, _VP],
        # (v, bl, bu, out, iters, cycles (each or null), batch, nb, bound_stride,
        #  stream)
        "proj_box_f32": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
        "proj_box_f64": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    },
    "spectral_proj": {
        # (t0, v0, w0, t, v, w, inner, outer (each or null), k, n, stream)
        "proj_logdet_vec_f32": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _VP],
        "proj_logdet_vec_f64": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _VP],
        # (t0, w0, t, w, inner, outer (each or null), k, n, kk, stream)
        "proj_sl_vec_f32": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
        "proj_sl_vec_f64": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    },
}

_LIBS = {}  # (kernel name, source or None) -> loaded ctypes.CDLL
build_log = {}  # kernel name -> nvcc output of the build (ptxas -v report)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels are built from source at first use"
    )


def build(name: str, src: str | None = None) -> str:
    """Compile csrc/<name>.cu (or another source `src` with the same entry
    points, e.g. an earlier version to time against) into a shared library;
    return its path."""
    src = src or os.path.join(_CSRC, name + ".cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    so = os.path.join(_BUILD, f"lib{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD, exist_ok=True)
    # build under a process-unique name, then install atomically, so
    # concurrent first launches never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", prefix=f"lib{name}_", dir=_BUILD)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, src, "-o", tmp],
            capture_output=True, text=True,
        )
        build_log[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                + build_log[name]
            )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def build_all() -> dict:
    """Build every kernel source at once, one nvcc process per source, all
    started together; returns {name: library path}."""
    from concurrent.futures import ThreadPoolExecutor  # noqa: PLC0415

    names = sorted(_SYMBOLS)
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        return dict(zip(names, ex.map(build, names)))


def load(name: str, src: str | None = None) -> ctypes.CDLL:
    """Build (if needed) and load kernel `name`, with its C signatures;
    `src` as in build()."""
    lib = _LIBS.get((name, src))
    if lib is None:
        lib = ctypes.CDLL(build(name, src))
        for sym, argtypes in _SYMBOLS[name].items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[(name, src)] = lib
    return lib
