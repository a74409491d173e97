"""Build the CUDA sources with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library ``build/repro_torch/lib<name>-<hash>.so`` at the repository root,
named by a hash of its source and flags, so an edited source is rebuilt and
an unchanged one is not.  nvcc's output, ptxas's register, shared-memory
and spill report for every kernel among it, is kept beside it as
``lib<name>-<hash>.log`` (:func:`ptxas_report`).  Nothing is built when a
module is imported: the first call that needs a kernel builds it, and
:func:`build` starts one nvcc per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("kcore_peel", "domination", "gf2_reduce", "common_neighbors",
           "pairwise_l1", "sinkhorn_lse", "auction_lap", "hamming")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Build the named libraries that are missing, one nvcc each, in parallel.

    Returns the seconds each build took (0.0 for one already built).
    Raises with nvcc's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
            continue
        out.with_suffix(".log").write_bytes(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def ptxas_report(name: str) -> dict[str, dict[str, int]]:
    """Per kernel of library ``name`` (built), by mangled name: registers,
    shared-memory bytes and spill bytes (stores + loads), from the build's
    log (empty when there is none)."""
    log = library_path(name).with_suffix(".log")
    out, entry = {}, None
    for line in (log.read_text().splitlines() if log.exists() else ()):
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            entry = out.setdefault(hit.group(1), {})
        elif entry is not None and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
            entry["spill_bytes"] = sum(nums)
        elif entry is not None and "Used" in line and "registers" in line:
            entry["registers"] = int(re.search(r"Used (\d+) registers",
                                               line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            entry["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def stream_handle(device) -> int:
    """The raw ``cudaStream_t`` of ``device``'s current stream, read anew at
    every call, without the Stream object that
    ``torch.cuda.current_stream(device).cuda_stream`` builds for it (a
    large share of a small launch's host time)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def function(name: str, symbol: str, argtypes,
             restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of library ``name``, built on first use."""
    with _lock:
        fn = _fns.get(symbol)
        if fn is None:
            lib = _libs.get(name)
            if lib is None:
                build((name,))
                lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = restype
            _fns[symbol] = fn
    return fn
