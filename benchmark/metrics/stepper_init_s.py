"""Seconds of the set-up's `Stepper.__init__` (the k^2 grids and tables,
the engine): the stepper's `stats["init_s"]` as the window opens. None
where the program keeps no such counter."""

LAYER = "set-up (stepper.init_state, graphs.ChunkGraphs)"
UNIT = "s"
MOVES = "setup_s"


def read(m):
    return (getattr(m.window, "stats_open", None) or {}).get("init_s")
