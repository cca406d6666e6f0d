"""Build the port's CUDA sources with ``nvcc`` at first use, and load them.

Each source ``csrc/<name>.cu`` exposes a plain C interface and is
compiled for Hopper (``sm_90a``) into ``build/<name>-<hash>.so`` at the
root of the repository, where ``<hash>`` covers the source and the
flags: an edited source builds anew, an unchanged one is built once.
The library is loaded with ``ctypes``. Nothing here runs at import
time, so the CPU tests import every module without a compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# per-source extra flags
SOURCES: dict[str, tuple[str, ...]] = {
    # no FMA contraction: apply_flat matches its plain version bit for bit
    "lars_kernels": ("-fmad=false",),
    "flash_decode": (),
}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return path


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + SOURCES[name]


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update("\0".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = library_path(name)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=None) -> dict[str, Path]:
    """Build every missing library, one ``nvcc`` per source, all started
    together. Raises with the compiler's output if one fails."""
    names = list(SOURCES if names is None else names)
    jobs = [_start(n) for n in names if not library_path(n).exists()]
    errors = []
    for proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)        # atomic: concurrent builds agree
        else:
            tmp.unlink(missing_ok=True)
            errors.append(f"{out.name}: nvcc exited {proc.returncode}\n{log}")
    if errors:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(errors))
    return {n: library_path(n) for n in names}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (building it if needed)."""
    return ctypes.CDLL(str(build_all([name])[name]))
