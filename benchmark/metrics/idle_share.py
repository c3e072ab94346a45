"""The share of the traced stretch in which nothing ran on the card: one
less the union of its kernels', copies' and sets' intervals over the
stretch."""

LAYER = "device"
UNIT = "%"
MOVES = "updates_per_s"


def read(m):
    if m.trace is None:
        return None
    return 100.0 * (1.0 - m.trace.busy_s / m.trace.window_s)
