"""Build a host C++ source into a shared library at first use.

The library goes to ``fire_tpu_torch/_build/<stem>_<hash>.so``, the hash
covering the source, the flags and the host CPU (``-march=native``
compiles for it), so a library built on one host is never loaded on
another.  A failed build raises with the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
from typing import Sequence

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
