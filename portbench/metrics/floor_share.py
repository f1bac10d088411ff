"""The share of the traced batch's span from the start of its first
segment at the compaction floor (a `solve.segment` span of the program's
recording, `scs_tpu_torch.trace`, whose bucket is at most
`BatchedSCS._MIN_BUCKET` rows) to the end of its last segment: the lockstep
tail, where a few problems keep the whole loop going at small kernels. 0
where the solve never reached the floor; None where the program records
nothing, and on a run without a card (no device operation in the window)."""


def read(run):
    t = run.trace
    if t is None or not t.ops:  # a run without a card
        return None
    try:
        from scs_tpu_torch.trace import Span, records  # noqa: PLC0415
    except ImportError:  # a program without the recording
        return None
    from scs_tpu_torch.batch import BatchedSCS  # noqa: PLC0415

    lo, hi = t.span_ns
    segs = [r for r in records(lo, hi) if isinstance(r, Span) and r.name == "solve.segment"]
    if not segs:
        return None
    floor = [r.t0 for r in segs if r.attrs["bucket"] <= BatchedSCS._MIN_BUCKET]
    if not floor:
        return 0.0
    return 100.0 * (max(r.t1 for r in segs) - min(floor)) / (hi - lo)
