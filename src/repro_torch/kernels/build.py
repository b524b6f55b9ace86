"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on first
use into a shared library under ``_build/`` beside this module (listed in
``.gitignore``), named by the hash of its source so an edited kernel is
rebuilt and an unchanged one is loaded as is::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o _build/<name>-<hash>.so <source>

Nothing here runs at import time: the CPU tests import every module and
have no nvcc.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


@dataclasses.dataclass
class Built:
    lib: ctypes.CDLL
    path: pathlib.Path
    seconds: float  # 0.0 when an up-to-date library was reused
    log: str  # nvcc/ptxas output (registers, shared memory, spills)


_loaded: dict[str, Built] = {}  # source path -> library, per process


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def compile_source(source: pathlib.Path) -> tuple[pathlib.Path, float, str]:
    """Compile ``source`` unless a library built from the same bytes exists.
    Returns (library path, build seconds, compiler log)."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}-{digest}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, seconds, log


def load(source: pathlib.Path) -> Built:
    """Build (if needed) and load one CUDA source; cached per process."""
    key = str(source)
    if key not in _loaded:
        path, seconds, log = compile_source(source)
        _loaded[key] = Built(ctypes.CDLL(str(path)), path, seconds, log)
    return _loaded[key]
