"""The share of the window's fetches whose next block the dump loop
dispatched before it waited for them, so that the block computed while
the payload travelled: the stepper's `stats["fetches_overlapped"]` over
its `stats["fetches"]` (`simulator._drive`), × 100. None where the
program keeps no such counter, or the window fetched nothing."""

LAYER = "dump loop (simulator._drive)"
UNIT = "%"
MOVES = "updates_per_s"


def read(m):
    ends = (getattr(m.window, "stats_open", None), getattr(m.window, "stats_close", None))
    if not all(end and "fetches_overlapped" in end and "fetches" in end for end in ends):
        return None
    fetches = m.window.counter("fetches")
    if fetches <= 0:
        return None
    return 100.0 * m.window.counter("fetches_overlapped") / fetches
