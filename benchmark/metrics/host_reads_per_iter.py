"""Device->host reads a loop iteration over the window: the stepper's
`stats["host_reads"]` over its `stats["iterations"]` (one report a chunk,
one `more` a prelude dispatch)."""

LAYER = "device loop (stepper._run_chunks)"
UNIT = "reads/iter"
MOVES = "updates_per_s"


def read(m):
    iterations = m.window.counter("iterations")
    if iterations <= 0:
        return None
    return m.window.counter("host_reads") / iterations
