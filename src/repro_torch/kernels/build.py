"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``_build/<name>-<hash>.so``; the hash covers the sources and the
flags, so an edit rebuilds and an unchanged source loads what is there.
Nothing is built at import: the first launch builds what it needs, and
``build`` compiles several libraries at once (one nvcc each, started
together).

Thread-safe: ``build`` runs under ``LOCK``, one process-wide lock that
``ops.Kernel`` also holds while it loads a library, so threads that first
launch one kernel at the same moment build and load it once. The
temporary output is named per process and per thread.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("slimsell_spmv", "slimsell_spmm", "slimsell_pull",
           "slimsell_pull_mm", "slimsell_spmv_packed", "slimsell_spmm_packed",
           "embedding_bag", "semiring_probe")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# held by build() and by ops.Kernel's first load (re-entrant: a load builds)
LOCK = threading.RLock()


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    """Where the built library of ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES, *, ptxas_info: bool = False) -> dict:
    """Compile every library in ``names`` that is not built yet, all nvcc
    processes running at once. Returns {name: compiler output} for the
    libraries it built; raises with the output if any build fails.
    ``ptxas_info`` adds ``-Xptxas -v`` (registers, shared memory, spills)."""
    with LOCK:
        return _build(names, ptxas_info)


def _build(names: Sequence[str], ptxas_info: bool) -> dict:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(
            f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_info else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs
