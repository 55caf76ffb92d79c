"""batch_proofs_per_s: the proofs of the batches completed in the window
over the window (host clock)."""


def read(data):
    n = sum(d.items for d in data.done if d.error is None)
    return n / data.window_s if n else None
