"""host_syncs (solve loop, `solver/solve.py`; a program counter): the
device-to-host reads of the loop's "any lane active" tests a batch,
`stats["host_syncs"]`, the mean over the traced batches."""


def read(r):
    return sum(b.host_syncs for b in r.batches) / len(r.batches)
