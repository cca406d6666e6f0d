"""Build the port's CUDA sources with ``nvcc`` at first use, and load them.

Each source ``csrc/<name>.cu`` exposes a plain C interface and is
compiled for Hopper (``sm_90a``) into ``build/<name>-<hash>.so`` at the
root of the repository, where ``<hash>`` covers the source and the
flags: an edited source builds anew, an unchanged one is built once.
The library is loaded with ``ctypes``. Nothing here runs at import
time, so the CPU tests import every module without a compiler.

``ptxas`` reports each kernel's registers, spills and shared memory
(``-Xptxas -v``); the build keeps that report beside the library
(``build/<name>-<hash>.log``), and :func:`ptxas_usage` reads it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
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
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)        # atomic: concurrent builds agree
        else:
            tmp.unlink(missing_ok=True)
            errors.append(f"{out.name}: nvcc exited {proc.returncode}\n{log}")
    if errors:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(errors))
    return {n: library_path(n) for n in names}


def _kernel_label(mangled: str) -> str | None:
    """``flash_decode_mma_kernel<256>`` for the Itanium-mangled name of
    a ``..._kernel`` (a length-prefixed identifier, then its template's
    int argument, if any); a second, bool template argument that is true
    (``flash_decode``'s softcap flag) gives ``<256,softcap>``, and a
    third that is true (its log-sum-exp flag) ``<256,lse>`` or
    ``<256,softcap,lse>``. None for any other function. Where digits
    inside a namespace's name also read as a length, the shortest
    identifier is the kernel's own."""
    found = []
    for m in re.finditer(r"\d+(?=[A-Za-z_])", mangled):
        for k in range(len(m.group())):           # the prefix's digits
            n = int(m.group()[k:])
            ident = mangled[m.end():m.end() + n]
            if len(ident) == n and ident.endswith("_kernel"):
                t = re.match(r"ILi(\d+)E(?:Lb([01])E)?(?:Lb([01])E)?",
                             mangled[m.end() + n:])
                args = "" if not t else t.group(1) + (
                    ",softcap" if t.group(2) == "1" else "") + (
                    ",lse" if t.group(3) == "1" else "")
                found.append(ident + (f"<{args}>" if t else ""))
    return min(found, key=len) if found else None


def parse_ptxas(log: str) -> dict[str, dict]:
    """{kernel: {"registers", "spill_stores", "spill_loads", "stack",
    "smem"}} from nvcc's output under ``-Xptxas -v``, each kernel named
    by its function and its template's int argument
    (``flash_decode_mma_kernel<256>``); bytes but for the registers."""
    out: dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\S+?)'?(?: for |$)", line)
        if m:
            cur = _kernel_label(m.group(1))
            if cur is not None:
                out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[cur]["smem"] = int(smem.group(1)) if smem else 0
    return out


def ptxas_usage(name: str) -> dict[str, dict]:
    """:func:`parse_ptxas` of the report that ``csrc/<name>.cu``'s build
    kept (built first if it is not)."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        build_all([name])
    return parse_ptxas(log.read_text())


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (building it if needed)."""
    return ctypes.CDLL(str(build_all([name])[name]))
