"""The share of the traced batch's span in which the device sat idle in a
gap that a counted host sync returned in: the device drained its queue
while the host waited to read it, then waited for the host's next launch.
The gaps are those of `device_idle`; the syncs are the program's
recording (`scs_tpu_torch.trace`). None where the program records
nothing."""

import bisect


def read(run):
    t = run.trace
    if t is None or not t.ops:
        return None
    try:
        from scs_tpu_torch.trace import Span, Sync, records  # noqa: PLC0415
    except ImportError:  # a program without the recording
        return None
    lo, hi = t.span_ns
    recs = records(lo, hi)
    if not any(isinstance(r, Span) for r in recs):
        return None
    stamps = sorted(r.t for r in recs if isinstance(r, Sync))
    idle, end = 0, lo
    gaps = []
    for _, _, s, e in sorted(t.ops, key=lambda o: o[2]):
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
    if end < hi:
        gaps.append((end, hi))
    for g0, g1 in gaps:
        i = bisect.bisect_left(stamps, g0)
        if i < len(stamps) and stamps[i] <= g1:
            idle += g1 - g0
    return 100.0 * idle / (hi - lo)
