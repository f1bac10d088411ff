"""G1 `gemv_rows` and G2 `gemv_cols` (ops.dense) in the traced batch
against their bound: the bytes the launches need (kernel_bytes.gemv, by
the wrappers' `.shapes` counters) over the card's memory bandwidth, divided
by the two kernels' device time. Only where every launch's matrix exceeds
the L2 cache many times over: a matrix that stays in L2 is read faster
than the bound assumes."""

from portbench.metrics import kernel_bytes
from portbench.peaks import peak

NAMES = ("gemv_rows_kernel", "gemv_cols_kernel")


def read(run):
    t = run.trace
    bw = peak(run.device.get("kind"), "hbm_bytes_per_s")
    if t is None or bw is None:
        return None
    secs = t.time_by_name(NAMES) / 1e9
    if not secs > 0:
        return None
    need = sum(
        n * kernel_bytes.gemv(B, r, c, run.itemsize)
        for key in ("gemv_rows", "gemv_cols")
        for (B, r, c), n in t.counters.get(key, {}).items()
    )
    return 100.0 * need / bw / secs
