"""The loop's share of the card's float32 peak in the traced stretch: the
step's transform operations a cell-iteration (5 log2(N^3) a complex 3-D
transform, four a step, seven in exact dt), times the cells of the batch
times the iterations executed, over the summed kernel time, against 67
TFLOP/s (H100 SXM, float32 without tensor cores)."""

import math

LAYER = "kernels (ops.mxu_fft, ops.fft, ops.kernels)"
UNIT = "%"
MOVES = "updates_per_s"
FP32_FLOP_PER_S = 67e12


def read(m):
    if m.trace is None or m.trace.kernel_s <= 0 or m.stretch_executed <= 0:
        return None
    transforms = 7 if m.dt_mode == "exact" else 4
    flops = transforms * 5.0 * math.log2(m.grid_cells) * m.cells * m.stretch_executed
    return 100.0 * flops / FP32_FLOP_PER_S / m.trace.kernel_s
