"""The share of the traced batch's span in which the device sat idle while
the host was inside the solve loop's segments (the joined `solve.segment`
spans of the program's recording, `scs_tpu_torch.trace`): the idle time of
the DR iterations themselves, apart from set-up, probes, compaction and
result building. None where the program records nothing."""


def read(run):
    t = run.trace
    if t is None or not t.ops:
        return None
    try:
        from scs_tpu_torch.trace import Span, records  # noqa: PLC0415
    except ImportError:  # a program without the recording
        return None
    from portbench.trace import Trace  # noqa: PLC0415

    lo, hi = t.span_ns
    segs = sorted((r.t0, r.t1) for r in records(lo, hi)
                  if isinstance(r, Span) and r.name == "solve.segment")
    if not segs:
        return None
    joined = [list(segs[0])]
    for s, e in segs[1:]:
        if s <= joined[-1][1]:
            joined[-1][1] = max(joined[-1][1], e)
        else:
            joined.append([s, e])
    idle = sum(e - s - Trace(span_ns=(s, e), ops=t.ops, host=[]).busy_ns() for s, e in joined)
    return 100.0 * idle / (hi - lo)
