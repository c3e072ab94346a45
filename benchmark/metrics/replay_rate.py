"""Replayed steps over accepted steps of every run in the window, from the
manifests' `replays` and `n_steps` (optimistic dt throws a replayed step's
work away)."""

LAYER = "dt mode (stepper._commit)"
UNIT = "%"
MOVES = "updates_per_s"


def read(m):
    if m.window.accepted <= 0:
        return None
    return 100.0 * m.window.replayed / m.window.accepted
