"""batch_p95_s (end to end, host clock): the 95th percentile of the wall
of every batch of the window (call to `torch.cuda.synchronize()`),
linear between order statistics."""


def read(r):
    v = sorted(b.wall for b in r.batches)
    pos = (len(v) - 1) * 0.95
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
