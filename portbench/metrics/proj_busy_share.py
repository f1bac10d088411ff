"""The cone projection's named kernels (ops.projections: C1 `proj_exp`, C2
`proj_pow`, and the cuSOLVER kernels of the PSD blocks' eigh) over the
device's busy time in the traced batch. The projection's plain tensor code
(the SOC map, the PSD rebuild, the bucket gathers) runs in PyTorch's
generic kernels, which no name tells apart, so it is not counted here."""

NAMES = ("proj_exp_kernel", "proj_pow_kernel", "syevj", "syevd", "sytrd", "stedc", "ormtr", "jacobi")


def read(run):
    t = run.trace
    if t is None or not t.ops:
        return None
    share = t.time_by_name(NAMES)
    if share == 0:
        return None
    return 100.0 * share / t.busy_ns()
