"""Iterations the chunks executed past what the loop needed, as a share of
what it needed: `stats["executed"]` over `stats["iterations"]`, less one,
over the window."""

LAYER = "device loop (stepper._run_chunks)"
UNIT = "%"
MOVES = "updates_per_s"


def read(m):
    iterations = m.window.counter("iterations")
    if iterations <= 0:
        return None
    return 100.0 * (m.window.counter("executed") / iterations - 1.0)
