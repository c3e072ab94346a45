"""Host milliseconds a fetch takes to start, over the traced stretch (one
whole job, the window's second): the stepper's `stats["fetch_enqueue_s"]`
(`simulator._Fetch`'s pinned allocation, the copy's enqueue and its event)
over `stats["fetches"]`. None untraced, or where the program keeps no such
counter or fetched nothing."""

LAYER = "dump loop (simulator._drive)"
UNIT = "ms"
MOVES = "updates_per_s"


def read(m):
    stretch = getattr(m.window, "stretch", ())
    if m.trace is None or len(stretch) != 2 or not all(
            {"fetches", "fetch_enqueue_s"} <= set(s) for s in stretch):
        return None
    fetches = m.window.stretch_counter("fetches")
    if fetches <= 0:
        return None
    return 1e3 * m.window.stretch_counter("fetch_enqueue_s") / fetches
