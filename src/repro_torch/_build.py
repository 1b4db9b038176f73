"""Build and load the port's CUDA kernels.

At first use every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, which ``ctypes`` loads.
All ``nvcc`` processes of one build start together and are all waited
for. Outputs go to ``build/kernels/`` at the repository root (ignored by
git), named by a hash of the source, the ``csrc`` headers and the flags,
so a changed source rebuilds and an unchanged one loads at once. Only the
sources in the repository are used; nothing is downloaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

__all__ = ["NVCC_FLAGS", "build", "library"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{home}/bin): the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Sequence[str]] = None) -> Dict[str, Path]:
    """Compile the sources not built yet; return {source stem: library}.

    ``names`` restricts the build to those ``csrc/<name>.cu`` stems. Each
    library's compiler output (with ``-Xptxas -v``: registers, shared
    memory and spills per kernel) is kept beside it as ``<library>.log``.
    Raises RuntimeError naming the source when ``nvcc`` fails.
    """
    srcs = sorted(_CSRC.glob("*.cu"))
    if names is not None:
        srcs = [s for s in srcs if s.stem in set(names)]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in srcs:
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        jobs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in jobs:           # wait for every process
        text, _ = proc.communicate()
        out.with_name(out.name + ".log").write_bytes(text)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name} "
                          f"(exit {proc.returncode}):\n{text.decode()}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {src.stem: _target(src) for src in srcs}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build([name])[name]
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
