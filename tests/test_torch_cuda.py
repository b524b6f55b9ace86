"""Torch port on the card: the CUDA paged kernels against their plain torch
versions, and the engine's kernel-vs-plain greedy invariant.

Every test here needs an NVIDIA GPU and nvcc (a CUDA kernel has no CPU
mode) and skips elsewhere.  The file imports neither jax nor ``repro``,
so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.attention import ops, paged  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.step import UnifiedServeEngine  # noqa: E402

# max |kernel - plain|: float32 differs only in summation order and exp;
# bf16 adds the plain path's bf16 rounding of the softmax weights and one
# output rounding (2^-8 relative)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA paged kernels "
                    "have no CPU mode")
    return torch.device("cuda")


def _case(dev, dtype, *, b, q_len, starts, lens, hkv=8, g=4, d=128, bs=16,
          w=34, nb=512, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
    kp, vp, q = mk(nb, bs, hkv, d), mk(nb, bs, hkv, d), mk(b, q_len, hkv * g, d)
    bt = torch.zeros((b, w), dtype=torch.int32)
    ids = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(seed))
    ids = (ids[:b * w] + 1).reshape(b, w).to(torch.int32)
    for i, (s, n) in enumerate(zip(starts, lens)):
        live = (s + max(n, 1) - 1) // bs + 1  # NULL tail after the last block
        bt[i, :live] = ids[i, :live]
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    return q, kp, vp, bt.to(dev), i32(starts), i32(lens)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 100])
def test_decode_kernel_matches_plain(cuda_device, dtype, window):
    q, kp, vp, bt, idx, _ = _case(cuda_device, dtype, b=4, q_len=1,
                                  starts=[0, 17, 300, 543], lens=[1] * 4)
    out = paged.paged_decode_fwd(q, kp, vp, bt, idx, window=window)
    ref = paged.paged_decode_plain(q, kp, vp, bt, idx, window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 100])
def test_span_kernel_matches_plain(cuda_device, dtype, window):
    q, kp, vp, bt, st, ln = _case(cuda_device, dtype, b=3, q_len=32,
                                  starts=[192, 421, 0], lens=[32, 17, 0])
    out = paged.paged_span_fwd(q, kp, vp, bt, st, ln, window=window)
    ref = paged.paged_span_plain(q, kp, vp, bt, st, ln, window=window)
    valid = (torch.arange(32, device=cuda_device)[None] < ln[:, None])
    err = ((out.float() - ref.float()).abs() * valid[..., None, None]).max()
    assert err.item() <= TOL[dtype]
    assert (out[2] == 0).all()  # row_len == 0: zeros, never NaN
    assert torch.isfinite(out).all()


@pytest.mark.cuda
def test_engine_kernel_equals_plain_greedy(cuda_device):
    """kernel_mode pallas (CUDA kernels) and xla (plain path) serve the
    same greedy streams on reduced granite in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, (n,)).astype(np.int32) for n in (7, 16, 21, 30)]
    streams = []
    for mode in ("pallas", "xla"):
        cfg = reduced(get_config("granite-8b"), kernel_mode=mode)
        eng = UnifiedServeEngine(cfg, build_model(cfg, device=cuda_device),
                                 device=cuda_device, num_slots=2, max_len=48,
                                 chunk_size=8)
        ops.reset_counts()
        reqs = [eng.submit(p, 10) for p in prompts]
        out = eng.run()
        streams.append([out[r.rid] for r in reqs])
        launched = ops.paged_attention.launches + ops.paged_span_attention.launches
        assert (launched > 0) == (mode == "pallas")
    for a, b in zip(*streams):
        np.testing.assert_array_equal(a, b)
