"""Build and load the hand-written CUDA kernels.

Each ``*.cu`` file here is compiled by ``nvcc`` at first use into a shared
library with a plain C interface, which ``ctypes`` loads. The library lands
in ``csrc/_build/`` under a name keyed by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one is reused; beside
it, ``build_log(name)`` keeps what nvcc printed (``-Xptxas -v``: each
kernel's registers, shared memory and spills). Nothing is built at import
time.

    lib = load("rotated_nms")      # compiles rotated_nms.cu if needed
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

SOURCES = ("rotated_nms", "window_conv")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Per-source flags. rotated_nms: --fmad=false keeps a*b - c*d as two
# rounded products and a rounded difference, as the plain PyTorch version
# computes it; its keep masks then match bit for bit. window_conv sums in
# another order than its plain version anyway, so it keeps fused FMAs.
EXTRA_FLAGS = {"rotated_nms": ("--fmad=false",)}


def nvcc_flags(name: str) -> tuple:
    """The nvcc flags ``<name>.cu`` is built with."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


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


def library_path(name: str) -> Path:
    """Where the library built from ``<name>.cu`` goes."""
    src = (_HERE / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(nvcc_flags(name)).encode()
                            ).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_log(name: str) -> Path:
    """Where nvcc's output for ``library_path(name)`` is kept."""
    return library_path(name).with_suffix(".log")


def build(name: str) -> Path:
    """Compile ``<name>.cu`` unless its library already exists."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [find_nvcc(), *nvcc_flags(name), "-o", tmp,
               str(_HERE / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        build_log(name).write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)        # atomic: concurrent builds are safe
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``<name>.cu``'s library, once per process."""
    return ctypes.CDLL(str(build(name)))
