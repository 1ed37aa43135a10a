"""Build and load the port's CUDA kernels (``dss_tpu_torch/csrc``).

Every ``.cu`` source is compiled with nvcc for ``sm_90a`` — one nvcc per
source, all started together — and linked into one shared library with a
plain C interface, loaded through ``ctypes``.  The build happens at first
use, into ``dss_tpu_torch/_build/<hash of the sources>/`` (listed in
``.gitignore``), so a fresh checkout builds itself.  Importing this module
builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if this source set was not built yet) and
    return the library's path.  ptxas's register and shared-memory report
    for each kernel lands in ``build.log`` beside it."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libdss_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    log = []
    failed = []
    for src, proc in procs:
        text = proc.communicate()[0].decode(errors="replace")
        log.append(f"== {src.name} (rc {proc.returncode})\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = out_dir / f"libdss_kernels.{os.getpid()}.so"
    subprocess.run([nvcc, "-shared", "-o", str(tmp),
                    *[str(out_dir / (s.stem + ".o")) for s in _sources()]],
                   check=True)
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.dss_log_power.argtypes = [_P, _P, _I, _I, _I, _I,
                                          ctypes.c_float, _P]
            lib.dss_log_power.restype = _I
            lib.dss_lpcnet_sampler.argtypes = [_P] * 26 + [_I] * 7 + [_P]
            lib.dss_lpcnet_sampler.restype = _I
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise when a launcher returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t "
                           f"{rc}")


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, for a launcher."""
    return torch.cuda.current_stream(t.device).cuda_stream
