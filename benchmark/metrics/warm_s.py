"""Seconds from the first `init_state` (after a synchronize) to the window's
opening: the warm-up job, with every chunk graph's capture."""

LAYER = "set-up (stepper.init_state, graphs.ChunkGraphs)"
UNIT = "s"
MOVES = "setup_s"


def read(m):
    return m.window.t_open - m.window.t_build
