"""Build the port's CUDA kernel sources with ``nvcc`` and load them.

A source is the full text of one translation unit plus the directory its
``#include "..."`` headers live in (``Source``; a plain string is a
generated stencil source, whose headers are ``stencil/csrc``).  Each is
compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -I <include dir>

into a shared library with a plain C interface and loaded with ``ctypes``.
Libraries are cached by the hash of the text, the include directory's
headers (``*.cuh``) and the flags, in ``build/repro_torch_kernels`` at the
root of the checkout, which ``.gitignore`` lists; a header edit therefore
rebuilds every source that includes it.  ``ptxas`` output (registers,
shared memory, spills) is kept beside each library as ``<hash>.log``.
``build_many`` starts one ``nvcc`` per source, all at once.  Nothing is
built when the module is imported; nothing outside the build directory is
written.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, NamedTuple, Optional, Sequence, Union

KERNELS = pathlib.Path(__file__).resolve().parent
STENCIL_CSRC = KERNELS / "stencil" / "csrc"
BUILD_DIR = KERNELS.parents[2] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v")


class Source(NamedTuple):
    """One translation unit: its text and the directory of its headers."""
    text: str
    include: pathlib.Path = STENCIL_CSRC


SourceLike = Union[str, Source]

_LOADED: Dict[str, ctypes.CDLL] = {}          # hash → library
_ENTRIES: Dict[tuple, object] = {}            # (source, entry) → C function
_HASHES: Dict[Source, str] = {}               # source → hash


def _source(source: SourceLike) -> Source:
    return source if isinstance(source, Source) else Source(source)


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


def source_hash(source: SourceLike) -> str:
    """Hash of a source's text, the headers of its include directory and
    the flags."""
    src = _source(source)
    h = hashlib.sha256(src.text.encode())
    h.update(str(src.include.relative_to(KERNELS)).encode())
    for f in sorted(src.include.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:20]


def _paths(src: Source):
    key = _HASHES.get(src)
    if key is None:
        key = _HASHES[src] = source_hash(src)
    return key, BUILD_DIR / f"{key}.cu", BUILD_DIR / f"lib{key}.so"


def build_many(sources: Sequence[SourceLike]) -> Dict[str, pathlib.Path]:
    """Compile every source not yet in the cache, one ``nvcc`` process per
    source started together; returns hash → library path.  Raises with
    ``nvcc``'s output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, []
    for src in dict.fromkeys(map(_source, sources)):
        key, cu, so = _paths(src)
        out[key] = so
        if so.exists():
            continue
        cu.write_text(src.text)
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(src.include), "-o", str(tmp),
               str(cu)]
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


def load(source: SourceLike, entry: str,
         argtypes: Optional[Sequence] = None) -> ctypes._CFuncPtr:
    """The C entry ``entry`` of ``source``'s library, building it first if
    needed.  ``argtypes`` default to the stencil kernels' ``(meta, scal,
    stream)``, three ``c_void_p``; every entry returns
    ``cudaGetLastError()`` after its launch as an ``int``."""
    fn = _ENTRIES.get((source, entry))
    if fn is not None:
        return fn
    src = _source(source)
    key, _, so = _paths(src)
    lib = _LOADED.get(key)
    if lib is None:
        if not so.exists():
            build_many([src])
        lib = ctypes.CDLL(str(so))
        _LOADED[key] = lib
    fn = getattr(lib, entry)
    fn.argtypes = list(argtypes) if argtypes is not None else \
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _ENTRIES[(source, entry)] = fn
    return fn


def ptxas_log(source: SourceLike) -> str:
    """``nvcc -Xptxas -v`` output of a built source ('' if not built)."""
    key, _, _ = _paths(_source(source))
    log = BUILD_DIR / f"{key}.log"
    return log.read_text() if log.exists() else ""


def csrc_source(kernel_dir: str, name: str) -> Source:
    """The ``Source`` of ``kernels/<kernel_dir>/csrc/<name>``, its include
    directory that ``csrc``."""
    inc = KERNELS / kernel_dir / "csrc"
    return Source((inc / name).read_text(), inc)
