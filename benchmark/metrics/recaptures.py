"""Chunk graphs captured inside the window: the stepper's
`stats["captures"]` (`graphs.ChunkGraphs`) over the window, which the
warm-up job should have left at 0. None where the program keeps no such
counter."""

LAYER = "device loop (stepper._run_chunks)"
UNIT = "captures"
MOVES = "updates_per_s"


def read(m):
    ends = (getattr(m.window, "stats_open", None), getattr(m.window, "stats_close", None))
    if not all(end and "captures" in end for end in ends):
        return None
    return m.window.counter("captures")
