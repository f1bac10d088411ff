"""Host syncs of the traced batch over its lockstep iterations (its largest
info["iter"]): the waits for the device that the program's recording
(`scs_tpu_torch.trace`, on while the profiler runs) counted inside the
traced span. None where the program records nothing, and on a run
without a card (no device operation in the window)."""


def read(run):
    t = run.trace
    if t is None or not t.ops or not t.iters:  # no card: nothing waits for a device
        return None
    try:
        from scs_tpu_torch.trace import Span, Sync, records  # noqa: PLC0415
    except ImportError:  # a program without the recording
        return None
    recs = records(*t.span_ns)
    if not any(isinstance(r, Span) for r in recs):
        return None
    return sum(isinstance(r, Sync) for r in recs) / t.iters
