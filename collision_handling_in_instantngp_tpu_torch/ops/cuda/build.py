"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``.cu`` source in this directory compiles on its own, with a plain C
interface, into ``<package>/_build/<name>-<hash>.so`` (the hash covers the
source, every header of this directory and the flags, so an edited kernel
never loads a stale library).
Nothing is built when the package is imported: a library is built at its
first use on the card, or ahead of time by :func:`build_all`, which starts
one nvcc per source at once. A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(HERE)), "_build")
SOURCES = ("hidden", "hpd_stream", "hpd_tail", "hpd_full", "scatter", "probe")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-lineinfo",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _library_path(name: str) -> str:
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(HERE) if f.endswith(".cuh"))
    for fname in (f"{name}.cu", *headers):
        with open(os.path.join(HERE, fname), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library, one nvcc process per source, all
    started together. Returns {name: nvcc's -Xptxas -v report}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = _library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", tmp, os.path.join(HERE, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``<name>.cu``, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _library_path(name)
            if not os.path.exists(path):
                build_all([name])
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib


def check(code: int, lib: ctypes.CDLL, err_fn: str, what: str) -> None:
    """Raise if a launcher returned an error code (>0 CUDA, <0 shape)."""
    if code != 0:
        fn = getattr(lib, err_fn)
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what} failed: {fn(code).decode()} (code {code})")
