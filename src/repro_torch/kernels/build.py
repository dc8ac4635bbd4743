"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``repro_torch/csrc/`` compiles on its own into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds).  Libraries go to ``build/torch_kernels/`` at the repository root,
named by a hash of their source and the shared headers (``csrc/*.cuh``),
so an edited source or header is rebuilt and an unchanged one is reused.
Nothing is built when a module is imported: the first call of a kernel
wrapper builds what it needs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
LOGS: dict[str, str] = {}   # nvcc's output for each library built by this process


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from source at first use")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    if name not in _LIBS:
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(b"".join(
            p.read_bytes() for p in (src, *sorted(CSRC.glob("*.cuh"))))).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True, check=False)
            LOGS[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src.name}:\n{LOGS[name]}")
            os.replace(tmp, out)   # atomic: a reader never sees a partial library
        _LIBS[name] = ctypes.CDLL(str(out))
    return _LIBS[name]
