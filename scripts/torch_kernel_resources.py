#!/usr/bin/env python3
"""Registers, spills and stack of the port's CUDA kernels, from ptxas.

Compiles sources of `msm_tpu_torch/ops/csrc/` with the build's own flags
(`ops/build.py` COMPILE_FLAGS) plus `-Xptxas -v` into a temporary
directory, and prints one JSON line per kernel: its demangled name,
registers, spill stores and loads, stack frame and static shared memory;
then one line per source with its nvcc's wall seconds (all sources
started together, as the build starts them). Needs nvcc (the card's
machine); exits 1 without it.

    python3 scripts/torch_kernel_resources.py [--source fft_kernels.cu ...] [--match lane_fft]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from msm_tpu_torch.ops import build  # noqa: E402

_ENTRY = re.compile(r"Compiling entry function '(\S+)' for")
_PROPS = re.compile(r"Function properties for (\S+)")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def parse(text: str) -> dict:
    """ptxas -v output -> {mangled name: fields}."""
    kernels: dict = {}
    current = props = None
    for line in text.splitlines():
        if m := _ENTRY.search(line):
            current = m.group(1)
            kernels.setdefault(current, {})
        elif m := _PROPS.search(line):
            props = m.group(1)
        elif (m := _SPILL.search(line)) and props in kernels:
            kernels[props].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                                  spill_loads=int(m.group(3)))
        elif (m := _USED.search(line)) and current:
            kernels[current].update(registers=int(m.group(1)),
                                    static_smem_bytes=int(m.group(2) or 0))
    return kernels


def demangle(names: list) -> list:
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if not tool or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True).stdout
    return out.splitlines() if len(out.splitlines()) == len(names) else names


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append",
                    help="file name under csrc/ (repeatable; default: every source)")
    ap.add_argument("--match", default="", help="keep kernels whose name contains this")
    args = ap.parse_args(argv)
    try:
        nvcc = build.nvcc_path()
    except RuntimeError as err:
        print(f"torch_kernel_resources: {err}", file=sys.stderr)
        return 1
    sources = [os.path.join(build._CSRC, s) for s in args.source] if args.source else build.SOURCES
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        procs = [
            (src, subprocess.Popen(
                [nvcc, *build.COMPILE_FLAGS, "-Xptxas", "-v", "-o",
                 os.path.join(work, os.path.basename(src) + ".o"), src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
            for src in sources
        ]
        outputs, seconds = {}, {}

        def wait(src, proc):
            outputs[src] = proc.communicate()
            seconds[src] = time.perf_counter() - t0

        waiters = [threading.Thread(target=wait, args=pair) for pair in procs]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join()
        for src, proc in procs:
            out, err = outputs[src]
            if proc.returncode != 0:
                print(f"nvcc failed on {src}:\n{err}", file=sys.stderr)
                return 1
            kernels = parse(out + err)
            names = list(kernels)
            for mangled, name in zip(names, demangle(names)):
                if args.match in name:
                    print(json.dumps({"source": os.path.basename(src), "kernel": name,
                                      **kernels[mangled]}), flush=True)
        for src, _ in procs:
            print(json.dumps({"source": os.path.basename(src), "nvcc_seconds": seconds[src]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
