"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``build/repro_torch/``
at the repository root and loaded with ``ctypes``. The library's file
name carries a hash of its source, so an edited kernel is rebuilt and a
stale one is never loaded. Nothing is built when a module is imported:
the first launch builds what it needs, and :func:`build_all` builds
every kernel at once with one ``nvcc`` process per source, all started
together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("flash_prefill", "flash_decode", "ssd_scan", "mla_decode",
           "moe_gemm", "flash_prefill_bwd")
# entry points that live in another kernel's library: entry -> library
ENTRY_LIBRARY = {"moe_gemm_wgrad": "moe_gemm", "ssd_scan_bwd": "ssd_scan"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_c_p, _c_i, _c_i64, _c_f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                            ctypes.c_float)

# argtypes of each launch entry point <name>_launch (see the .cu sources);
# each library also exports <library>_error_string(int) -> const char*
SIGNATURES = {
    "flash_prefill": (
        [_c_p] * 6 + [_c_i] * 9 + [_c_i64] * 9
        + [_c_i, _c_i, _c_i, _c_f, _c_p]),
    "flash_prefill_bwd": (
        [_c_p] * 13 + [_c_i] * 10 + [_c_i64] * 9
        + [_c_i, _c_i, _c_i, _c_f, _c_p]),
    "flash_decode": (
        [_c_p] * 9 + [_c_i] * 8 + [_c_i64] * 8
        + [_c_i, _c_i, _c_i, _c_f, _c_p]),
    "ssd_scan": [_c_p] * 9 + [_c_i] * 9 + [_c_i64] * 12 + [_c_p],
    "ssd_scan_bwd": [_c_p] * 16 + [_c_i] * 11 + [_c_i64] * 12 + [_c_p],
    "mla_decode": (
        [_c_p] * 10 + [_c_i] * 11 + [_c_i64] * 8 + [_c_f, _c_p]),
    "moe_gemm": [_c_p] * 4 + [_c_i] * 7 + [_c_i64] * 5 + [_c_p],
    "moe_gemm_wgrad": [_c_p] * 4 + [_c_i] * 5 + [_c_i64] * 4 + [_c_p],
}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    """The library's path; its name hashes the source, the shared headers
    it may include and the flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _command(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build_all(names=KERNELS) -> Dict[str, str]:
    """Compile every kernel that has no library yet, one ``nvcc`` per
    source, all running at once. Returns each kernel's compiler output
    (ptxas register and shared-memory report). Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs: Dict[str, str] = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built on first use,
    with the argtypes of every entry point it holds."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_all([name])
    lib = ctypes.CDLL(str(path))
    for entry, sig in SIGNATURES.items():
        if ENTRY_LIBRARY.get(entry, entry) == name:
            launch = getattr(lib, f"{entry}_launch")
            launch.argtypes = sig
            launch.restype = ctypes.c_int
    err_str = getattr(lib, f"{name}_error_string")
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a kernel with no backward would be launched on an input
    that requires grad: its result would carry no gradient, and autograd
    would not say so. The decode kernels (flash_decode, mla_decode) have
    none: no training path runs them."""
    import torch                       # this module itself needs no torch
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: this decode kernel has no backward (training runs "
            "attention through flash_prefill); run it under torch.no_grad")


def launch(name: str, *args) -> None:
    """Call entry point ``name``'s C launch function; raise if it reports
    a CUDA error (a refused launch never runs, and a later synchronise
    would not report it)."""
    src = ENTRY_LIBRARY.get(name, name)
    lib = library(src)
    err = getattr(lib, f"{name}_launch")(*args)
    if err != 0:
        msg = getattr(lib, f"{src}_error_string")(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
