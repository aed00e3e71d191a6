"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for ``sm_90a``. The first kernel call builds every
source at once (one ``nvcc`` process per source, all started together) into
``src/repro_torch/_build/`` (listed in ``.gitignore``); the file name carries
a hash of the sources and flags, so an edited source is rebuilt and a stale
library is never loaded. Nothing here runs at import time: the CPU tests
import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("bdmm", "fused_ffn", "masked_matmul", "paged_attention",
           "paged_prefill", "paged_verify")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the epilogue activations of bdmm and the masked matmul (csrc/common.cuh
# Act): every entry of kernels/ref.py ACTIVATIONS
ACT_CODES = {None: 0, "silu": 1, "gelu": 2, "relu": 3, "sigmoid": 4,
             "softplus": 5, "sqrelu": 6}

_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}      # nvcc output per source (ptxas -v lines)


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelError("nvcc not found: the CUDA kernels build only where the "
                      "CUDA toolkit is installed")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every source that has no up-to-date library, in parallel.
    Returns ``{name: library path}``; raises :class:`KernelError` with
    nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: BUILD_DIR / f"{n}-{_digest(n)}.so" for n in SOURCES}
    procs = {}
    for name, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed: List[str] = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)        # atomic: a half-written library never loads
    if failed:
        raise KernelError("nvcc failed:\n" + "\n".join(failed))
    return targets


def variants(name: str, defines: Dict[str, Dict[str, int]],
             out_dir: Path) -> Dict[str, ctypes.CDLL]:
    """``csrc/<name>.cu`` built once for each entry of ``defines`` (a label
    and its preprocessor symbols, such as a benchmark's phase cut
    ``{"REPRO_CUT": 1}``; no symbols: the package's own build), in
    parallel into ``out_dir``, and loaded. Raises :class:`KernelError` with
    nvcc's output when a build fails."""
    procs = {}
    for label, syms in defines.items():
        if not syms:
            continue
        out = out_dir / f"{name}_{label}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{k}={v}" for k, v in syms.items()),
               "-I", str(CSRC), "-o", str(out), str(CSRC / f"{name}.cu")]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), out)
    libs = {label: library(name) for label, syms in defines.items() if not syms}
    for label, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise KernelError(f"nvcc failed for {name} {label}:\n{log[-3000:]}")
        libs[label] = ctypes.CDLL(str(out))
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    if name not in _libs:
        paths = build_all()
        for n, path in paths.items():
            if n not in _libs:
                _libs[n] = ctypes.CDLL(str(path))
    return _libs[name]


def check(lib: ctypes.CDLL, op: str, code: int) -> None:
    """Raise when entry point ``op`` of ``lib`` reported a CUDA error (the
    message comes from the library's one ``<source>_error_string``)."""
    if code != 0:
        source = next(n for n, loaded in _libs.items() if loaded is lib)
        fn = getattr(lib, f"{source}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise KernelError(f"{op}: CUDA error {code}: "
                          f"{fn(code).decode(errors='replace')}")


def stream_ptr(device: torch.device) -> int:
    """The current PyTorch stream of ``device`` as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream


def copy_width(t: torch.Tensor, row_bytes: int) -> int:
    """The widest copy (16, 8, 4, 2 or 1 bytes) that every row start of the
    row-major ``t`` (rows of ``row_bytes``) is aligned to; 16 is what TMA
    needs."""
    for v in (16, 8, 4, 2):
        if t.data_ptr() % v == 0 and row_bytes % v == 0:
            return v
    return 1


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Kernel inputs must be contiguous CUDA tensors on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
