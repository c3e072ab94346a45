# Copied from msm_tpu/io/npy.py, which is JAX-free; keep the two in step.
"""npy pair I/O in the reference's on-disk layout.

A complex grid is stored as two npy files `{path}_real` / `{path}_imag`
(exact filenames, no `.npy` extension) shaped 4-D, matching
`complex_array_to_disk` (`simulator/src/utils/io.rs:34-97`) and
`load_complex`/`dump_complex` (`synthesizer/src/lib.rs:38-103`).

Writes go through a bounded async pool: the device->host transfer happens on
the submitting thread (so the device buffer can be reused immediately) and
the file writes run on worker threads, capped at MAX_CONCURRENT_GRID_WRITES
in-flight grids like the reference (`simulator/src/simulation_object.rs:39`).
When the native C++ writer (`msm_tpu_torch.io.native`) is available it is used for
the file writes; the pure-Python path is the fallback.
"""

from __future__ import annotations

import logging
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

log = logging.getLogger(__name__)

# Reference caps in-flight grid writes at 16 (x2 files each).
MAX_CONCURRENT_GRID_WRITES = 16


def write_npy_exact(path: str, arr: np.ndarray) -> None:
    """Write an npy file at *exactly* `path` (numpy's save() would append .npy)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype in (np.float32, np.float64):
        from . import native

        if native.available():
            native.write_npy(path, arr)
            return
    with open(path, "wb") as f:
        np.lib.format.write_array(f, arr, version=(1, 0))


def read_npy_exact(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return np.lib.format.read_array(f)


def write_complex_pair(path_base: str, arr: np.ndarray) -> None:
    """Write `{path_base}_real` and `{path_base}_imag` npy files.

    Complex input goes through the native writer when available: it splits
    interleaved data while streaming to disk, avoiding the `.real`/`.imag`
    numpy temporaries entirely.
    """
    arr = np.ascontiguousarray(arr)
    if arr.dtype in (np.complex64, np.complex128):
        from . import native

        if native.available():
            native.write_complex_pair(path_base, arr)
            return
    write_npy_exact(path_base + "_real", np.ascontiguousarray(arr.real))
    write_npy_exact(path_base + "_imag", np.ascontiguousarray(arr.imag))


def _read_header(path: str):
    """(shape, fortran_order, dtype) of an npy file (header only)."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            return np.lib.format.read_array_header_1_0(f)
        return np.lib.format.read_array_header_2_0(f)


def load_complex_pair(path_base: str, dtype=np.complex128) -> np.ndarray:
    """Load a complex grid from its `_real` / `_imag` pair.

    When the native reader is available and the on-disk precision matches
    the requested complex dtype, both planes stream straight into one
    interleaved complex buffer with the GIL released (the synthesizer's
    hot load path, `synthesizer/src/lib.rs:38-68` counterpart).
    """
    from . import native

    if native.can_read():
        shape, fortran, rdtype = _read_header(path_base + "_real")
        want = (
            np.complex128 if np.dtype(dtype) == np.complex128 else np.complex64
        )
        plane = np.float64 if want == np.complex128 else np.float32
        if not fortran and rdtype == plane:
            return native.read_complex_pair(path_base, shape, want)
    real = read_npy_exact(path_base + "_real")
    imag = read_npy_exact(path_base + "_imag")
    return (real + 1j * imag).astype(dtype)


class AsyncGridWriter:
    """Bounded asynchronous writer pool for grid dumps.

    `submit` blocks only when MAX_CONCURRENT_GRID_WRITES grids are already in
    flight (mirroring the reference's throttling loop,
    `simulation_object.rs:1123-1147`); `wait` joins all outstanding writes
    (end-of-run join, `:638-658`).
    """

    def __init__(
        self,
        max_concurrent: int = MAX_CONCURRENT_GRID_WRITES,
        workers: int = 8,
    ):
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._slots = threading.Semaphore(max_concurrent)
        self._pending: list[Future] = []
        self._failure: BaseException | None = None
        self._lock = threading.Lock()

    def submit(self, path_base: str, arr: np.ndarray) -> None:
        """Queue a complex grid for writing as an npy pair."""
        self.submit_task(lambda: write_complex_pair(path_base, arr))

    def submit_task(self, fn) -> None:
        """Queue an arbitrary grid-sized write/upload task under the same
        in-flight cap (the remote-storage transports ride this pool like
        the reference's tokio upload tasks, io.rs:427-463)."""
        self._slots.acquire()

        def work():
            try:
                fn()
            finally:
                self._slots.release()

        fut = self._pool.submit(work)
        with self._lock:
            # Prune completed futures, but never drop a failure: the first
            # exception is stashed and re-raised at wait()/close() so a
            # failed write/upload cannot pass silently just because later
            # submits happened to prune its future.
            kept = []
            for f in self._pending:
                if not f.done():
                    kept.append(f)
                    continue
                exc = f.exception()
                if exc is not None and self._failure is None:
                    self._failure = exc
            kept.append(fut)
            self._pending = kept

    def wait(self) -> None:
        """Block until all queued writes have completed (raises on failure,
        including failures of writes already pruned from the pending list)."""
        with self._lock:
            pending, self._pending = self._pending, []
            failure, self._failure = self._failure, None
        if failure is not None:
            for fut in pending:  # drain before raising; keep pool consistent
                try:
                    fut.result()
                except BaseException as e:
                    # first-error raise semantics, but don't lose the
                    # diagnostics of additional failures in the drain
                    log.error("additional async-write failure swallowed: %r", e)
            raise failure
        for fut in pending:
            fut.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def dump_dir(sim_name: str, data_root: str = "sim-data") -> str:
    """Per-sim dump directory `sim-data/{sim_name}` (simulation_object.rs:1116-1120)."""
    path = os.path.join(data_root, sim_name)
    os.makedirs(path, exist_ok=True)
    return path


def psi_path(sim_dir: str, dump_index: int, field: str = "psi") -> str:
    """Dump basename `{field}_{dump:05}` (simulation_object.rs:1153-1164)."""
    return os.path.join(sim_dir, f"{field}_{dump_index:05d}")
