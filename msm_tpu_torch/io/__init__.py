from .npy import (  # noqa: F401
    AsyncGridWriter,
    load_complex_pair,
    read_npy_exact,
    write_complex_pair,
    write_npy_exact,
)
from .checkpoint import load_manifest, write_manifest  # noqa: F401
