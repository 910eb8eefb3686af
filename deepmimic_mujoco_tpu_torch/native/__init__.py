"""The ray tracer's host library: ``rasterizer.cpp`` (the JAX package's
``native/rasterizer.cpp``, copied) compiled with g++ and the JAX
package's flags at first use into ``build/torch_kernels/
librasterizer.so``, and bound with ctypes.

It is host C++ with OpenMP, not a device kernel: frames are drawn on the
CPU from geom poses that FK computes on the card. A failed compile or
load raises with g++'s output. Only where no g++ is on the PATH does
``rasterizer_lib`` return None, and ``tools/render.py`` then draws its
matplotlib sketch.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "rasterizer.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "torch_kernels")
LIBRARY = os.path.join(BUILD_DIR, "librasterizer.so")
GXX_FLAGS = ["-O2", "-fopenmp", "-shared", "-fPIC"]

_loaded = {}
_lock = threading.Lock()


def build(force: bool = False) -> float:
    """Compile ``SOURCE`` into ``LIBRARY`` when it is missing, older than
    the source, or ``force``; returns g++'s seconds (0.0 when nothing was
    built). The output is written beside the library and renamed into
    place, so processes that build at once never load a partial file.
    Raises RuntimeError with g++'s output when g++ is missing or fails."""
    if (not force and os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return 0.0
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the ray tracer is built from "
                           f"{SOURCE} at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [gxx, *GXX_FLAGS, SOURCE, "-o", tmp]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return time.perf_counter() - t


def rasterizer_lib() -> Optional[ctypes.CDLL]:
    """The ray tracer's library, built at first use and loaded once per
    process; None (with a printed line) when no g++ is on the PATH."""
    with _lock:
        if "lib" not in _loaded:
            if shutil.which("g++") is None:
                print("no g++ on the PATH: frames are drawn by the "
                      "matplotlib sketch, not the ray tracer")
                _loaded["lib"] = None
            else:
                build()
                _loaded["lib"] = _bind(ctypes.CDLL(LIBRARY))
        return _loaded["lib"]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The argument types of both entries, as the JAX package sets them."""
    fptr = ctypes.POINTER(ctypes.c_float)
    iptr = ctypes.POINTER(ctypes.c_int32)
    lib.render_scene.argtypes = [
        fptr, fptr, iptr, fptr, fptr, ctypes.c_int,
        fptr, fptr, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.render_scene.restype = None
    lib.render_scene_mesh.argtypes = [
        fptr, fptr, iptr, fptr, fptr, ctypes.c_int,
        fptr, iptr, iptr, fptr,
        fptr, fptr, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.render_scene_mesh.restype = None
    return lib
