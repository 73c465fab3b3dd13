"""ctypes bindings for the native navsim library, with lazy self-build.

The port's copy of navillm_tpu/sim/native.py. It builds its own
``libnavsim`` from the port's copy of navsim.cpp (g++ -O3, no external
deps) into ``build/navillm_tpu_torch/`` at the repository root, never next
to its source; the file name carries a hash of the source and the flags,
so an edited source is rebuilt. If a C++ toolchain is unavailable, callers
fall back to the pure NumPy implementations in graph.py, as the
reference's host layer does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).with_name("navsim.cpp")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "navillm_tpu_torch"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"libnavsim_{digest[:16]}.so"


def _build(out: Path) -> bool:
    """Compile into a temporary file, then rename it into place, so
    processes building at once never load a half-written library."""
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
    except OSError:
        return False
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.CalledProcessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def load_library():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _library_path()
        if not path.exists() and not _build(path):
            return None
        lib = ctypes.CDLL(str(path))
        c = ctypes
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

        lib.ns_scan_create.restype = c.c_int64
        lib.ns_scan_create.argtypes = [c.c_int32, c.c_int32, i32p, f64p]
        lib.ns_scan_distance.restype = c.c_double
        lib.ns_scan_distance.argtypes = [c.c_int64, c.c_int32, c.c_int32]
        lib.ns_scan_dist_matrix.restype = None
        lib.ns_scan_dist_matrix.argtypes = [c.c_int64, f64p]
        lib.ns_scan_path.restype = c.c_int32
        lib.ns_scan_path.argtypes = [c.c_int64, c.c_int32, c.c_int32, i32p, c.c_int32]
        lib.ns_scan_distances.restype = None
        lib.ns_scan_distances.argtypes = [c.c_int64, c.c_int32, i32p, i32p, f64p]

        lib.ep_create.restype = c.c_int64
        lib.ep_create.argtypes = [c.c_int32]
        lib.ep_free.restype = None
        lib.ep_free.argtypes = [c.c_int64]
        lib.ep_reset.restype = None
        lib.ep_reset.argtypes = [c.c_int64]
        lib.ep_add_edge.restype = None
        lib.ep_add_edge.argtypes = [c.c_int64, c.c_int32, c.c_int32, c.c_double]
        lib.ep_update.restype = None
        lib.ep_update.argtypes = [c.c_int64, c.c_int32]
        lib.ep_visited.restype = c.c_int32
        lib.ep_visited.argtypes = [c.c_int64, c.c_int32]
        lib.ep_distance.restype = c.c_double
        lib.ep_distance.argtypes = [c.c_int64, c.c_int32, c.c_int32]
        lib.ep_distances_from.restype = None
        lib.ep_distances_from.argtypes = [c.c_int64, c.c_int32, f64p]
        lib.ep_num_nodes.restype = c.c_int32
        lib.ep_num_nodes.argtypes = [c.c_int64]
        lib.ep_path.restype = c.c_int32
        lib.ep_path.argtypes = [c.c_int64, c.c_int32, c.c_int32, i32p, c.c_int32]
        lib.ep_pair_dists.restype = None
        lib.ep_pair_dists.argtypes = [c.c_int64, c.c_int32, i32p, f64p]
        lib.ep_dist_steps.restype = None
        lib.ep_dist_steps.argtypes = [c.c_int64, c.c_int32, c.c_int32, i32p,
                                      f64p, i32p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_library() is not None
