"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on first
use into a shared library under ``_build/`` beside this module (listed in
``.gitignore``), named by the hash of its source and the ``*.cuh``
headers beside it, so an edited kernel is rebuilt and an unchanged one is
loaded as is.  :func:`load_all` starts one nvcc per source, all
together::

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


def _target(source: pathlib.Path) -> pathlib.Path:
    """The library built from ``source`` and the headers beside it."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def compile_sources(sources) -> dict[pathlib.Path, tuple[float, str]]:
    """Compile every source without an up-to-date library, one nvcc each,
    all started together.  Returns {source: (build seconds, log)} for the
    sources it built."""
    todo = [s for s in sources if not _target(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    t0 = time.perf_counter()
    for source in todo:
        tmp = _target(source).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o", str(tmp), str(source)]
        procs.append((source, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built, failed = {}, []
    for source, tmp, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({proc.returncode}) on {source}:\n{log}")
            continue
        os.replace(tmp, _target(source))  # atomic: loaders never see half a file
        built[source] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def load_all(sources) -> list[Built]:
    """Build (in parallel, where needed) and load CUDA sources; cached per
    process."""
    sources = [pathlib.Path(s) for s in sources]
    fresh = compile_sources([s for s in sources if str(s) not in _loaded])
    for s in sources:
        if str(s) not in _loaded:
            seconds, log = fresh.get(s, (0.0, ""))
            path = _target(s)
            _loaded[str(s)] = Built(ctypes.CDLL(str(path)), path, seconds, log)
    return [_loaded[str(s)] for s in sources]


def load(source: pathlib.Path) -> Built:
    """Build (if needed) and load one CUDA source; cached per process."""
    return load_all([source])[0]
