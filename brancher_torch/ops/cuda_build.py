"""Build and load the hand-written CUDA kernels of ``brancher_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a
shared library under ``build/kernels/`` at the root of the checkout (a
directory git ignores) and loaded with ``ctypes``.  The library's file
name carries a digest of the source, of every ``csrc/`` header it
includes (``#include "..."``, followed through headers), and of the
compile and link flags, so an edited source or header is rebuilt and a
stale build is never loaded.

The bf16 GLM kernels' (K2, K4) TMA tensor maps are encoded by
``cuTensorMapEncodeTiled``, a libcuda call.  The library reaches it
through the CUDA runtime's entry-point query (``csrc/glm_sm90.cuh``), so
it links against nothing beyond the CUDA runtime: ``LINK_FLAGS`` is
empty.

Nothing here runs when the package is imported: a kernel wrapper calls
``load_library`` on its first launch.  ``nvcc``'s output (with ptxas's
register and shared-memory report) is kept in ``build/kernels/<name>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import re
import tempfile
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LINK_FLAGS: List[str] = []

_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home is None:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    if home is not None and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def included_headers(name: str) -> List[Path]:
    """The ``csrc/`` files that ``csrc/<name>.cu`` includes with quotes,
    directly or through another such header, in the order first met."""
    seen: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        for inc in _INCLUDE.findall(todo.pop(0).read_bytes()):
            path = CSRC / inc.decode()
            if path.exists() and path not in seen:
                seen.append(path)
                todo.append(path)
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for path in included_headers(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode() + b"\0" + " ".join(LINK_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _build(name: str) -> None:
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu"), *LINK_FLAGS]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    (BUILD_DIR / f"{name}.log").write_text(proc.stdout)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if not library_path(name).exists():
            _build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
