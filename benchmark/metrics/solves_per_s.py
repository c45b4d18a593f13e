"""solves_per_s (end to end, host clock): lanes that met the contract,
summed over every batch of the window, over the window's time."""


def read(r):
    return sum(b.solved for b in r.batches) / r.window_s
