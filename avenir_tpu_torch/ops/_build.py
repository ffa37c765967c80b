"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/lib<name>-<digest>.so`` inside the package, where ``digest``
covers the source and the flags, so an edited source is rebuilt and a
current build is reused.  Nothing is built at import: the first call that
needs a kernel builds it.  ``build()`` starts one ``nvcc`` per source, all
at once, and waits for every one of them.  Each start runs under
``core.resilience.with_retries``, as the native C library's compile does:
a transient failure to start a process backs off and tries again.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    """Names of every CUDA source of the package."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(nvcc on PATH or under /usr/local/cuda)")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _nvcc_start(cmd: list) -> subprocess.Popen:
    """Start one ``nvcc`` (run under ``with_retries``: a transient OSError
    starting the process backs off and tries again)."""
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(names: Optional[Iterable[str]] = None) -> None:
    """Compile every named source (default: all) that has no current
    build, one ``nvcc`` process each, all started together.  Raises with
    the compiler's output if any of them fails."""
    from ..core.resilience import with_retries

    names = list(sources() if names is None else names)
    with _lock:
        jobs = []
        try:
            for name in names:
                so = library_path(name)
                if so.exists():
                    continue
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC_DIR / f"{name}.cu")]
                jobs.append((name, so, tmp, with_retries(
                    _nvcc_start, cmd, op="cuda.compile")))
        finally:
            failures = []
            for name, so, tmp, proc in jobs:
                log, _ = proc.communicate()
                if proc.returncode == 0:
                    os.replace(tmp, so)
                else:
                    failures.append(f"nvcc failed for {name}.cu "
                                    f"(exit {proc.returncode}):\n{log}")
        if failures:
            raise RuntimeError("\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                _libs[name] = lib
    return lib
