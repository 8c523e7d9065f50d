"""Build the generated CUDA kernel sources with ``nvcc`` and load them.

Each source (generated header + a ``csrc/*.cuh`` kernel template) is
compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -I csrc

into a shared library with a plain C interface and loaded with ``ctypes``.
Libraries are cached by the hash of their full text (the ``csrc`` files
included) in ``build/repro_torch_kernels`` at the root of the checkout,
which ``.gitignore`` lists; ``ptxas`` output (registers, shared memory,
spills) is kept beside each library as ``<hash>.log``.  ``build_many``
starts one ``nvcc`` per source, all at once.  Nothing is built when the
module is imported; nothing outside the build directory is written.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Sequence

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[4] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}          # hash → library
_ENTRIES: Dict[tuple, object] = {}            # (source, entry) → C function


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def source_hash(source: str) -> str:
    """Hash of a source, the csrc templates it includes and the flags."""
    h = hashlib.sha256(source.encode())
    for f in sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:20]


def _paths(source: str):
    key = source_hash(source)
    return key, BUILD_DIR / f"{key}.cu", BUILD_DIR / f"lib{key}.so"


def build_many(sources: Sequence[str]) -> Dict[str, pathlib.Path]:
    """Compile every source not yet in the cache, one ``nvcc`` process per
    source started together; returns hash → library path.  Raises with
    ``nvcc``'s output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, []
    for src in dict.fromkeys(sources):
        key, cu, so = _paths(src)
        out[key] = so
        if so.exists():
            continue
        cu.write_text(src)
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(cu)]
        procs.append((key, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for key, so, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{key}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {key}.cu:\n{log}")
            continue
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(source: str, entry: str) -> ctypes._CFuncPtr:
    """The C entry ``entry(meta, scal, stream) -> int`` of ``source``'s
    library, building it first if needed.  All three arguments are
    ``c_void_p``; the result is ``cudaGetLastError()`` after the launch."""
    fn = _ENTRIES.get((source, entry))
    if fn is not None:
        return fn
    key, _, so = _paths(source)
    lib = _LOADED.get(key)
    if lib is None:
        if not so.exists():
            build_many([source])
        lib = ctypes.CDLL(str(so))
        _LOADED[key] = lib
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _ENTRIES[(source, entry)] = fn
    return fn


def ptxas_log(source: str) -> str:
    """``nvcc -Xptxas -v`` output of a built source ('' if not built)."""
    key, _, _ = _paths(source)
    log = BUILD_DIR / f"{key}.log"
    return log.read_text() if log.exists() else ""
