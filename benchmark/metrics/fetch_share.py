"""The share of the traced stretch in which the card copied to the host:
every device->host copy (the dump fetches, the chunk reports, the prelude's
reads), from the device trace."""

LAYER = "dump loop (simulator._drive)"
UNIT = "%"
MOVES = "updates_per_s"


def read(m):
    if m.trace is None:
        return None
    return 100.0 * m.trace.d2h_s / m.trace.window_s
