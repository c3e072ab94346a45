"""The loop's share of its memory roofline in the traced stretch: the fused
engine's compulsory bytes a cell-iteration (80 B, exact dt 136 B) times the
cells of the batch times the iterations executed, at the card's published
bandwidth, over the summed kernel time. The same bytes are counted whatever
path computes the step."""

LAYER = "kernels (ops.mxu_fft, ops.fft, ops.kernels)"
UNIT = "%"
MOVES = "updates_per_s"


def read(m):
    if m.trace is None or m.trace.kernel_s <= 0 or m.stretch_executed <= 0:
        return None
    bound_s = m.bytes_per_cell * m.cells * m.stretch_executed / m.hbm_bytes_per_s
    return 100.0 * bound_s / m.trace.kernel_s
