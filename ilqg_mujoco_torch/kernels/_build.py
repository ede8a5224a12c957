"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  The library lands in ``build/ilqg_mujoco_torch/`` beside the
package, under a name keyed by a hash of the source, the flags and the
compiler's version, so a changed source or toolkit is rebuilt and an
unchanged one is loaded as it is.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "ilqg_mujoco_torch"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("riccati_compat",)

_LOADED: dict = {}


def nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set NVCC or put nvcc on PATH)")


@functools.lru_cache(maxsize=None)
def nvcc_version() -> str:
    """``nvcc --version`` of the compiler in use, path included."""
    path = nvcc()
    out = subprocess.run([path, "--version"], capture_output=True, text=True,
                         check=True)
    return f"{os.path.realpath(path)}\n{out.stdout}"


def _target(name: str) -> pathlib.Path:
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                         + " ".join(FLAGS).encode()
                         + nvcc_version().encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def _build(name: str) -> str:
    """Build one kernel's library unless it is built already; returns the
    compiler output (the ``-Xptxas -v`` register and spill report)."""
    out = _target(name)
    log_path = out.with_suffix(".log")
    if out.exists():
        return log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    log_path.write_text(proc.stdout)
    os.replace(tmp, out)
    return proc.stdout


def build_all(names=KERNELS) -> dict:
    """Build every kernel; returns {name: compiler output}."""
    return {n: _build(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    if name not in _LOADED:
        _build(name)
        _LOADED[name] = ctypes.CDLL(str(_target(name)))
    return _LOADED[name]
