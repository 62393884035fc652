"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use into `_build/` beside the package (listed in .gitignore), as
`<name>-<hash>.so`, the hash covering the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Missing libraries
are compiled in parallel, one nvcc each. A failed build raises.

No fast math: the kernels are held bit for bit against plain PyTorch
versions, which round every op on its own (the sources say how).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    """Path of nvcc: on PATH, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH or /usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def compile_all(jobs: Dict[Path, Path]) -> Dict[Path, str]:
    """Compile every source of `jobs` {library: source} with nvcc, all at
    once, each into a temporary file moved onto its library when nvcc
    succeeds. Returns nvcc's output (ptxas register and spill report) per
    library; a failed build raises."""
    procs = {}
    for out, src in jobs.items():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[out] = (tmp, src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for out, (tmp, src, proc) in procs.items():
        logs[out] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{src} (nvcc exit {proc.returncode}):\n{logs[out]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named source whose library is missing, all at once.

    Returns nvcc's output (ptxas register and spill report) per compiled
    name; an empty dict when everything was already built.
    """
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    logs = compile_all({out: CSRC / f"{n}.cu" for n, out in todo.items()})
    return {n: logs[out] for n, out in todo.items()}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu`, building it if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build", "compile_all",
           "library_path", "load", "nvcc"]
