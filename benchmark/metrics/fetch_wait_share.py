"""The share of the traced stretch (one whole job, the window's second) in
which the dump loop sat blocked on its fetches: the stepper's
`stats["fetch_wait_s"]` (host seconds in `simulator._Fetch.wait`) over the
stretch, over the stretch's seconds. None untraced, or where the program
keeps no such counter."""

LAYER = "dump loop (simulator._drive)"
UNIT = "%"
MOVES = "updates_per_s"


def read(m):
    stretch = getattr(m.window, "stretch", ())
    if m.trace is None or len(stretch) != 2 or not all("fetch_wait_s" in s for s in stretch):
        return None
    return 100.0 * m.window.stretch_counter("fetch_wait_s") / m.trace.window_s
