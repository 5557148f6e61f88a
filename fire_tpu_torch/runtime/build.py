"""Build a host C++ or a CUDA source into a shared library at first use.

A host library goes to ``fire_tpu_torch/_build/<stem>_<hash>.so``, the
hash covering the source, the flags and the host CPU (``-march=native``
compiles for it), so a library built on one host is never loaded on
another.  A CUDA library (:func:`build_cuda`, ``nvcc`` for sm_90a) is
named by the hash of its source and flags.  A failed build raises with
the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
from typing import Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native")


def cxx() -> str:
    for name in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        path = shutil.which(name) if name else None
        if path:
            return path
    raise RuntimeError("no C++ compiler found (c++, g++ or clang++) to build the port's "
                       "host libraries from fire_tpu_torch/csrc/")


def _cpu_identity() -> bytes:
    """What ``-march=native`` compiles for: the CPU's model and feature
    flags."""
    lines = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features") and line not in lines:
                    lines.append(line)
                if not line.strip() and len(lines) > 1:
                    break  # the first processor tells
    except OSError:
        pass
    return "".join(lines).encode()


def library_path(source: str, stem: str, flags: Sequence[str] = CXX_FLAGS) -> str:
    h = hashlib.sha256()
    with open(source, "rb") as f:
        h.update(f.read())
    h.update(" ".join(flags).encode())
    h.update(_cpu_identity())
    return os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:12]}.so")


def build(source: str, stem: str, flags: Sequence[str] = CXX_FLAGS) -> str:
    """Compile ``source`` unless this source and these flags have a
    library already.  Returns the library's path."""
    out = library_path(source, stem, flags)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    res = subprocess.run([cxx(), *flags, "-o", tmp, source], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"C++ build failed for {source}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "fire_tpu_torch/csrc/ with the CUDA toolkit")


def cuda_library_path(source: str, stem: str, flags: Sequence[str]) -> str:
    h = hashlib.sha256()
    with open(source, "rb") as f:
        h.update(f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:12]}.so")


def build_cuda(source: str, stem: str, flags: Sequence[str]) -> Tuple[str, str]:
    """Compile ``source`` with ``nvcc`` unless this source and these flags
    have a library already.  Returns the library's path and nvcc's output
    (empty when nothing was built)."""
    out = cuda_library_path(source, stem, flags)
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    res = subprocess.run([nvcc(), *flags, "-o", tmp, source], capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{log}")
    os.replace(tmp, out)
    return out, log
