"""Build the port's native sources into its git-ignored ``build/`` directory
and load them with ctypes.

CUDA kernels (``csrc/*.cu``) are compiled by ``nvcc`` for ``sm_90a`` into
shared libraries with a plain C interface: every pointer and the stream
cross as ``c_void_p`` and every int as ``c_int``. A library's file name
carries a hash of its source and its compiler command, so an edited source
is rebuilt and a stale library is never loaded; a pack's prebuilt libraries
(``library_dirs``) are taken only under that same name. Nothing is built when this
module is imported: a kernel is built at its first launch, or up front by
``load_cuda`` (chip_smoke.py calls it to time the build).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Dict, List, Optional

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "build")

# name -> source under the package; one shared library per source
CUDA_SOURCES = {
    "roi_align": os.path.join("csrc", "roi_align.cu"),
    "bottleneck_stage": os.path.join("csrc", "bottleneck_stage.cu"),
    "nms": os.path.join("csrc", "nms.cu"),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}
lib_paths: Dict[str, str] = {}   # name -> the loaded library's file
# directories searched, before a build, for a library of a kernel's hashed
# name (runtime/aot.py enable_persistent_cache: a pack's kernels/)
library_dirs: List[str] = []


def cuda_tool(name: str) -> str:
    """A CUDA toolkit program (nvcc, cuobjdump): under $CUDA_HOME/bin or
    /usr/local/cuda/bin, else on the PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", name)
    return path if os.path.exists(path) else name


def library_name(src: str, compiler: List[str], stem: str) -> str:
    """The file name of ``src``'s library built by ``compiler``: the stem
    and a hash of the source and the command."""
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(compiler).encode())
    return f"lib{stem}-{digest.hexdigest()[:12]}.so"


def build_shared(src: str, compiler: List[str], stem: str) -> str:
    """Compile ``src`` with ``compiler + ["-o", out, src]`` unless a library
    of the same source and command exists. Returns the library path; raises
    RuntimeError with the compiler's output on failure."""
    out = os.path.join(BUILD_DIR, library_name(src, compiler, stem))
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(compiler + ["-o", tmp, src],
                              capture_output=True, text=True)
        build_logs[stem] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {src} failed ({proc.returncode}):\n"
                f"{build_logs[stem]}")
        os.replace(tmp, out)   # atomic: a concurrent build never sees half
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def prebuilt(name: str) -> Optional[str]:
    """A library of CUDA kernel ``name`` in ``library_dirs`` under the
    hashed name of this tree's source and this nvcc command, if any: a
    library of another source or command is never picked."""
    file = library_name(os.path.join(PKG_DIR, CUDA_SOURCES[name]),
                        [cuda_tool("nvcc")] + NVCC_FLAGS, name)
    for d in library_dirs:
        if os.path.exists(os.path.join(d, file)):
            return os.path.join(d, file)
    return None


def load_cuda(name: str) -> ctypes.CDLL:
    """The loaded shared library of CUDA kernel ``name``: a library of its
    hashed name (this source, this nvcc command) from ``library_dirs``, or
    else one built into ``BUILD_DIR`` if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = prebuilt(name) or build_shared(
            os.path.join(PKG_DIR, CUDA_SOURCES[name]),
            [cuda_tool("nvcc")] + NVCC_FLAGS, name)
        lib = _loaded[name] = ctypes.CDLL(path)
        lib_paths[name] = path
    return lib
