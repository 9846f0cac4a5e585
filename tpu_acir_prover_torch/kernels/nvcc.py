"""Builds a CUDA library of ``csrc/`` with ``nvcc`` for sm_90a, once.

``build(stem, sources)`` compiles the sources into one shared library with a
plain C interface in ``_build/``, keyed by a hash of the flags, the sources
and every header of ``csrc/``, and keeps ptxas's register and spill report
beside it.  A process compiles to a temporary name of its own and renames
it into place, so processes that build at once all load a whole library.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = os.path.join(home, "bin", "nvcc") if home else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if os.path.exists("/usr/local/cuda/bin/nvcc") else None)
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build(stem: str, sources) -> Path:
    """Compile ``sources`` (if not already built) into ``lib<stem>_<hash>.so``
    and return its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources, *sorted(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    tmp.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp.with_suffix(".log"), so.with_suffix(".log"))
    os.replace(tmp, so)
    return so


def ptxas_report(so: Path) -> list:
    """ptxas's lines on each kernel's registers, spills and shared memory,
    from the build of the library ``so``."""
    lines = so.with_suffix(".log").read_text().splitlines()
    return [ln.split(":", 1)[-1].strip() for ln in lines
            if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
