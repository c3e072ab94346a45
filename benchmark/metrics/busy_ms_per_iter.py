"""Summed kernel time a loop iteration executed in the traced stretch."""

LAYER = "kernels (ops.mxu_fft, ops.fft, ops.kernels)"
UNIT = "ms"
MOVES = "updates_per_s"


def read(m):
    if m.trace is None or m.stretch_executed <= 0:
        return None
    return 1e3 * m.trace.kernel_s / m.stretch_executed
