"""Builds the port's CUDA sources with ``nvcc`` and loads them with ``ctypes``.

Each ``asf_tpu_torch/csrc/<name>.cu`` has a plain C interface and becomes
``build/kernels/<name>-<hash>.so`` at the root of the checkout (the
directory is git-ignored). The hash covers every file under ``csrc/`` (the
``.cu`` and the headers it includes) and the flags, so an edited source or
header is rebuilt and a stale library is never loaded. Nothing is built when
a module is imported: ``load`` builds on first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, in the build log
]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        digest.update(str(path.relative_to(CSRC)).encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> str | None:
    """Compiles ``csrc/<name>.cu`` unless it is built already.

    Returns the ``nvcc`` output, or None when nothing was compiled; raises
    with that output if ``nvcc`` fails.
    """
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    os.replace(tmp, target)
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
