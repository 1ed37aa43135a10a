"""Build and load the port's CUDA kernels (``dss_tpu_torch/csrc``).

Every ``.cu`` source is compiled with nvcc for ``sm_90a`` — one nvcc per
source, all started together — and linked into one shared library with a
plain C interface, loaded through ``ctypes``.  The build happens at first
use, into ``dss_tpu_torch/_build/<hash of the sources>/`` (listed in
``.gitignore``), so a fresh checkout builds itself.  Importing this module
builds nothing.  A measuring tool may ask for a second build with
preprocessor ``defines`` (the sampler's ``DSS_SAMPLER_TRACE`` and
``DSS_SAMPLER_CLUSTER=N``); the port itself uses the plain one only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[Tuple[str, ...], ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(defines: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *defines]).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(defines: Sequence[str] = ()) -> Path:
    """Compile the kernels (if this source set was not built yet with these
    ``defines``) and return the library's path.  ptxas's register and
    shared-memory report for each kernel lands in ``build.log`` beside it."""
    out_dir = BUILD_ROOT / _digest(defines)
    lib_path = out_dir / "libdss_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *[f"-D{d}" for d in defines], "-c", str(src),
             "-o", str(obj)],
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


def library(defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    key = tuple(defines)
    with _lock:
        if key not in _libs:
            lib = ctypes.CDLL(str(build(key)))
            lib.dss_log_power.argtypes = [_P, _P, _I, _I, _I, _I,
                                          ctypes.c_float, _P]
            lib.dss_log_power.restype = _I
            for fn in (lib.dss_filter_log_power,
                       lib.dss_filter_log_power_one_warp):
                fn.argtypes = [_P] * 7 + [_I] * 6 + [ctypes.c_float, _P]
                fn.restype = _I
            lib.dss_dsp_synthesis.argtypes = (
                [_P] * 16 + [ctypes.c_uint, ctypes.c_uint, ctypes.c_float]
                + [_I] * 3 + [_P])
            lib.dss_dsp_synthesis.restype = _I
            lib.dss_lpc_recursion.argtypes = ([_P] * 8 + [_I] * 4
                                              + [ctypes.c_float, _P])
            lib.dss_lpc_recursion.restype = _I
            lib.dss_empty_launch.argtypes = [_I, _P]
            lib.dss_empty_launch.restype = _I
            lib.dss_lpcnet_sampler_bunched.argtypes = (
                [_P] * 31 + [_I] * 11 + [_P])
            lib.dss_lpcnet_sampler_bunched.restype = _I
            lib.dss_lpcnet_sampler_plan.argtypes = [_I] * 9 + [_P]
            lib.dss_lpcnet_sampler_plan.restype = _I
            lib.dss_bilstm_decoder.argtypes = [_P] * 13 + [_I] * 7 + [_P]
            lib.dss_bilstm_decoder.restype = _I
            lib.dss_bilstm_plan.argtypes = [_I] * 4 + [_P]
            lib.dss_bilstm_plan.restype = _I
            lib.dss_cepstrum_lpc.argtypes = [_P, _L, _L, _L, _P, _P, _I, _I,
                                             _P]
            lib.dss_cepstrum_lpc.restype = _I
            lib.dss_deemphasis.argtypes = [_P, _L, _P, _P, _L, _P, _I, _L,
                                           ctypes.c_float, _P]
            lib.dss_deemphasis.restype = _I
            _libs[key] = lib
        return _libs[key]


def check(rc: int, name: str) -> None:
    """Raise when a launcher returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t "
                           f"{rc}")


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, for a launcher."""
    return torch.cuda.current_stream(t.device).cuda_stream
