"""Torch port isolation: every ``repro_torch`` module imports, and the
reduced CPU engine serves, in a process where ``jax`` and ``repro`` cannot
be imported at all; no port source names them."""
from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None  # any import of them raises ImportError
import numpy as np
import torch
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
from repro_torch.configs import get_config, reduced
from repro_torch.serve.step import UnifiedServeEngine
cfg = reduced(get_config("granite-8b"), num_layers=1)
if not torch.cuda.is_available():
    try:
        UnifiedServeEngine(cfg, num_slots=1, max_len=32)
    except RuntimeError as e:
        assert "CUDA is not available" in str(e), e
    else:
        raise AssertionError("engine without device= ran on the CPU")
eng = UnifiedServeEngine(cfg, device="cpu", num_slots=1, max_len=32)
req = eng.submit(np.arange(9, dtype=np.int32), 5)
out = eng.run()
assert len(out[req.rid]) == 5, out
assert not any(k == "jax" or k.startswith(("jax.", "repro."))
               for k, v in sys.modules.items() if v is not None)
print("ok", len(mods))
"""


def test_port_runs_without_jax_or_repro():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("ok")


def test_no_port_source_imports_jax_or_repro():
    pat = re.compile(r"^\s*(import jax|from jax|from repro\.|import repro\b)",
                     re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = [str(f) for f in files if f.exists() and pat.search(f.read_text())]
    assert len(files) > 20 and not bad, bad
