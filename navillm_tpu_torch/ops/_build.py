"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel under ``navillm_tpu_torch/csrc/`` is compiled on first use
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), in ``build/navillm_tpu_torch/`` at the repository
root. The file name carries a hash of the source and the flags, so an
edited source is rebuilt. There is no fallback: a missing ``nvcc`` or a
failed build raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "navillm_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float     # compile time in this process, 0.0 when reused
    log: str           # nvcc's output (ptxas register/shared-memory report)


_lock = threading.Lock()
_built: Dict[str, Built] = {}


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def load(name: str) -> Built:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    with _lock:
        if name in _built:
            return _built[name]
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        out = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
        seconds, log = 0.0, ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            t0 = time.perf_counter()
            proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                   str(src)], capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
            os.replace(tmp, out)
        built = Built(ctypes.CDLL(str(out)), out, seconds, log)
        _built[name] = built
        return built
