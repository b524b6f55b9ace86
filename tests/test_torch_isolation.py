"""Torch port isolation: every ``repro_torch`` module imports (the ssm,
moe and RG-LRU models, the SSD scan package and the spec proposers
included), and the reduced CPU engines serve (the legacy one traced into
a ``.prv``; mamba2 unified and legacy; the n-gram and draft-model spec
lanes; deepseek-moe unified with a fork and a beam search, and legacy
with a session; recurrentgemma unified and legacy with a tail of rec
layers; internvl2 unified and fixed-batch with patch embeddings), in a
process where ``jax`` and ``repro`` cannot be imported at all; no port
source names them."""
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
import tempfile
from repro_torch import core as xtrace
from repro_torch.serve.engine import ContinuousServeEngine
tracer = xtrace.Tracer("isolated").init()
legacy = ContinuousServeEngine(cfg, eng.model, device="cpu", num_slots=1,
                               max_len=32, tracer=tracer)
req = legacy.submit(np.arange(9, dtype=np.int32), 5)
assert len(legacy.run()[req.rid]) == 5
with tempfile.TemporaryDirectory() as tmp:
    paths = xtrace.write_prv(tracer.finish(), tmp + "/serve")
    lat = xtrace.serve_latency_summary(xtrace.parse_prv(paths["prv"]))
assert lat["ttft_us"]["count"] == 1, lat
ssm = UnifiedServeEngine(reduced(get_config("mamba2-370m"), num_layers=1),
                         device="cpu", num_slots=1, max_len=32)
req = ssm.submit(np.arange(9, dtype=np.int32), 5)
assert len(ssm.run()[req.rid]) == 5 and ssm.pool is None
ssm_legacy = ContinuousServeEngine(ssm.cfg, ssm.model, device="cpu",
                                   num_slots=1, max_len=32)
req = ssm_legacy.submit(np.arange(9, dtype=np.int32), 5)
assert len(ssm_legacy.run()[req.rid]) == 5
from repro_torch.serve.spec import make_proposer
for kind in ("ngram", "draft:granite-8b"):
    spec = UnifiedServeEngine(cfg, eng.model, device="cpu", num_slots=1,
                              max_len=32, spec=make_proposer(
                                  kind, cfg, num_slots=1, max_len=32,
                                  device="cpu"))
    req = spec.submit(np.arange(9, dtype=np.int32), 5)
    assert len(spec.run()[req.rid]) == 5 and spec.stats["spec_dispatches"]
moe = UnifiedServeEngine(reduced(get_config("deepseek-moe-16b"), num_layers=1),
                         device="cpu", num_slots=2, max_len=32)
req = moe.submit(np.arange(9, dtype=np.int32), 5, n_samples=2)
out = moe.run()
assert len(out) == 2 and all(len(t) == 5 for t in out.values()), out
assert len(moe.beam_search(np.arange(9, dtype=np.int32), 4, width=2)) == 2
moe_legacy = ContinuousServeEngine(moe.cfg, moe.model, device="cpu",
                                   num_slots=1, max_len=32)
req = moe_legacy.submit(np.arange(9, dtype=np.int32), 5, session="s")
assert len(moe_legacy.run()[req.rid]) == 5
hyb = UnifiedServeEngine(reduced(get_config("recurrentgemma-9b"), num_layers=5),
                         device="cpu", num_slots=2, max_len=48)
req = hyb.submit(np.arange(20, dtype=np.int32), 5)
assert len(hyb.run()[req.rid]) == 5 and not hyb.chunkable
hyb_legacy = ContinuousServeEngine(hyb.cfg, hyb.model, device="cpu",
                                   num_slots=1, max_len=48)
req = hyb_legacy.submit(np.arange(20, dtype=np.int32), 5)
assert len(hyb_legacy.run()[req.rid]) == 5
from repro_torch.serve.engine import ServeEngine
vlm = UnifiedServeEngine(reduced(get_config("internvl2-2b"), num_layers=1),
                         device="cpu", num_slots=1, max_len=32)
patches = np.ones((vlm.cfg.num_patches, vlm.cfg.vision_dim), np.float32)
req = vlm.submit(np.arange(9, dtype=np.int32), 5,
                 extras={"patch_embeds": patches})
assert len(vlm.run()[req.rid]) == 5 and not req.extras
static = ServeEngine(vlm.cfg, vlm.model, device="cpu", max_len=32)
got = static.generate(np.arange(9, dtype=np.int32)[None], num_tokens=5,
                      extras={"patch_embeds": patches[None]})
assert got.shape == (1, 5)
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
