"""The iterations the problems needed over those the masked lockstep ran
(BatchedSCS.device_prob_iters: batch size times iterations, segment by
segment, after each compaction): both counts."""


def read(run):
    need = sum(int(b.iters.sum()) for b in run.batches)
    ran = sum(b.device_prob_iters for b in run.batches)
    if not ran > 0:
        return None
    return 100.0 * need / ran
