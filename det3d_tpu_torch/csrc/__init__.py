"""Build and load the port's native code: the hand-written CUDA kernels and
the host-plan builders.

Each ``*.cu`` file here (``CUDA_SOURCES``) is compiled by ``nvcc`` for
``sm_90a``, and each ``*.cc`` file (``HOST_SOURCES``: ``hostplan.cc``, the
C++ host-plan builders and host voxelizers) by ``g++``, at first use, into
a shared library with a plain C interface, which ``ctypes`` loads. The
library lands in ``csrc/_build/`` under a name keyed by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
reused; it is written under a temporary name and moved into place with one
atomic rename, so processes that build at once (test workers) never load a
half-written file. Beside it, ``build_log(name)`` keeps what the compiler
printed (nvcc's ``-Xptxas -v``: each kernel's registers, shared memory and
spills). A failed build raises with the compiler's output. Nothing is
built at import time.

    lib = load("rotated_nms")      # compiles rotated_nms.cu if needed
    lib = load("trace_marks")      # the layer markers of utils/trace.py
    lib = load("hostplan")         # compiles hostplan.cc if needed
    lib = load("pointops")         # compiles pointops.cc if needed
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "_build"

CUDA_SOURCES = ("rotated_nms", "window_conv",       # *.cu, nvcc
                "window_conv_bwd", "trace_marks")
HOST_SOURCES = ("hostplan", "pointops")            # *.cc, g++
SOURCES = CUDA_SOURCES + HOST_SOURCES

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Per-source flags. rotated_nms: --fmad=false keeps a*b - c*d as two
# rounded products and a rounded difference, as the plain PyTorch version
# computes it; its keep masks then match bit for bit. window_conv sums in
# another order than its plain version anyway, so it keeps fused FMAs.
EXTRA_FLAGS = {"rotated_nms": ("--fmad=false",)}

# No OpenMP: a data loader may fork workers after the builders have run.
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def source(name: str) -> Path:
    """The source file of ``name``: ``<name>.cu`` or ``<name>.cc`` here."""
    if name not in SOURCES:
        raise ValueError(f"no native source {name!r}; expected one of "
                         f"{SOURCES}")
    return _HERE / (f"{name}.cu" if name in CUDA_SOURCES else f"{name}.cc")


def nvcc_flags(name: str) -> tuple:
    """The nvcc flags ``<name>.cu`` is built with."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def flags(name: str) -> tuple:
    """The compiler flags ``name``'s source is built with."""
    return nvcc_flags(name) if name in CUDA_SOURCES else CXX_FLAGS


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels need the CUDA toolkit")
    return found


def find_cxx() -> str:
    """Path of ``g++`` on PATH."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the host-plan builders "
                           "and the data pipeline's geometry (csrc/"
                           "hostplan.cc, csrc/pointops.cc) need a C++17 "
                           "compiler")
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``name``'s source goes."""
    src = source(name).read_bytes()
    digest = hashlib.sha256(src + " ".join(flags(name)).encode()
                            ).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_log(name: str) -> Path:
    """Where the compiler's output for ``library_path(name)`` is kept."""
    return library_path(name).with_suffix(".log")


def build(name: str) -> Path:
    """Compile ``name``'s source unless its library already exists."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        compiler = find_nvcc() if name in CUDA_SOURCES else find_cxx()
        cmd = [compiler, *flags(name), "-o", tmp, str(source(name))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(compiler).name} failed "
                               f"({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        build_log(name).write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)        # atomic: concurrent builds are safe
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``name``'s library, once per process."""
    return ctypes.CDLL(str(build(name)))
