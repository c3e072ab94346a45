"""The yardstick's arithmetic: the step's compulsory bytes, the card's
published bandwidth, and interval sums over a trace.

Kept in the benchmark so that a change to the program cannot move it.
"""

from __future__ import annotations

# Published device-memory bandwidth of the H100 SXM (80 GB HBM3), bytes/s, at
# its 700 W limit (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12


def step_bytes_per_cell(dt_mode: str) -> float:
    """Device-memory bytes a cell of one loop iteration of the fused, skewed
    complex64 engine must move: each kernel's inputs read once and outputs
    written once. Optimistic and lagged, 80 B: K1 reads and writes the
    carrier q (16), K2 reads q and writes psi and the density (24), K3 reads
    the density and writes the potential (16), K4 reads the potential and psi
    and writes q (24). Exact adds the pre-step solve, 56 B: K1 without its
    sums (16), K10 (16), K3 (16) and K11, which reads the potential (8):
    136 B. The same work is counted whatever path computes the step."""
    return 136.0 if dt_mode == "exact" else 80.0


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, cursor = [], lo
    for a, b in sorted(intervals):
        if a > cursor:
            out.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]
