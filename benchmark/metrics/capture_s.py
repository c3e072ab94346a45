"""Host seconds the set-up spent capturing the loop's chunk graphs: the
stepper's `stats["capture_s"]` (`graphs.ChunkGraphs`) as the window opens,
after the warm-up job. None where the program keeps no such counter."""

LAYER = "set-up (stepper.init_state, graphs.ChunkGraphs)"
UNIT = "s"
MOVES = "setup_s"


def read(m):
    return (getattr(m.window, "stats_open", None) or {}).get("capture_s")
