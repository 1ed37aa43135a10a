"""Build and load the port's host-compiled loops (``csrc/*.cpp``).

The sources are compiled with the host C++ compiler (``$CXX``, else ``g++``
or ``c++`` on the PATH) into one shared library with a plain C interface,
loaded through ``ctypes`` (whose calls release the interpreter lock).  The
build happens at first use, into ``dss_tpu_torch/_build/host-<hash of the
sources and flags>/`` (listed in ``.gitignore``); importing this module
builds nothing.  No ``-ffast-math`` and ``-ffp-contract=off``: every
floating-point operation is rounded once, in the source's order.  nvcc
never sees these files (``ops/_cuda.py`` compiles ``*.cu`` only).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ._cuda import BUILD_ROOT, CSRC

CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-ffp-contract=off", "-std=c++17"]

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _sources():
    return sorted(CSRC.glob("*.cpp"))


def compiler() -> str:
    """The host C++ compiler: ``$CXX``, else g++ or c++ on the PATH."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError("the port's CPU sample loop needs a host C++ compiler "
                       "to build dss_tpu_torch/csrc/*.cpp: install g++ or set "
                       "CXX")


def build() -> Path:
    """Compile the host sources (if this source set was not built yet) and
    return the library's path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_ROOT / f"host-{h.hexdigest()[:16]}"
    lib_path = out_dir / "libdss_host.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libdss_host.{os.getpid()}.{threading.get_ident()}.so"
    cmd = [compiler(), *CXX_FLAGS, *map(str, _sources()), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the host loops failed (rc "
                           f"{proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded host library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.dss_dsp_synthesis_host.argtypes = [_P] * 10 + [_I] * 2
            lib.dss_dsp_synthesis_host.restype = _I
            lib.dss_deemphasis_host.argtypes = [_P, _L, _P, _P, _L, _P, _I,
                                                _L, ctypes.c_float]
            lib.dss_deemphasis_host.restype = _I
            _lib = lib
        return _lib
