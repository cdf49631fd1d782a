"""Build and load the port's CUDA kernels.

Each source in csrc/ compiles with nvcc for sm_90a into a shared library
with a plain C interface, loaded with ctypes. Libraries go into the
package's build/ directory at first use; the file name carries a hash of
the source and flags, so an edited source rebuilds and a built one is
reused. The ptxas report (registers, local memory, spills) of each build
is kept beside its library as `<lib>.log`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("rac.cu", "lpf.cu", "itxfm.cu", "intra.cu", "splat.cu",
           "lf_grids.cu", "mc.cu", "lpf_replay.cu", "passa.cu", "digest.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def lib_path(source: str) -> str:
    h = hashlib.sha256()
    for name in (source, *sorted(n for n in os.listdir(CSRC_DIR)
                                 if n.endswith(".cuh"))):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build_all(sources=SOURCES) -> dict:
    """Compile every source that has no current library, one nvcc each,
    all started together. Returns {source: library path}; raises with
    nvcc's output if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for src in sources:
        path = lib_path(src)
        if os.path.exists(path):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, src)]
        jobs[src] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    errors = []
    for src, (path, tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode == 0:
            with open(path + ".log", "w") as f:
                f.write(log)
            os.replace(tmp, path)
        else:
            errors.append(f"nvcc {src} failed:\n{log}")
        if os.path.exists(tmp):
            os.unlink(tmp)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {src: lib_path(src) for src in sources}


def load(source: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of `source` (built if needed), with ctypes
    argument types set from {function: [ctypes types]}; every entry
    returns an int (cudaError_t)."""
    lib = _LIBS.get(source)
    if lib is None:
        path = build_all((source,))[source]
        lib = ctypes.CDLL(path)
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[source] = lib
    return lib
