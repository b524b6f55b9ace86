"""Torch port on the card: the CUDA paged and flash kernels against their
plain torch versions, and the engines' kernel-vs-plain greedy invariant.

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
from repro_torch.kernels.attention import flash, ops, paged  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import ContinuousServeEngine, ServeEngine  # noqa: E402
from repro_torch.serve.step import UnifiedServeEngine  # noqa: E402

# max |kernel - plain|: float32 differs only in summation order and exp;
# bf16 adds the plain path's bf16 rounding of the softmax weights and one
# output rounding (2^-8 relative)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have "
                    "no CPU mode")
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # sq, skv, causal, window, q_offset: prompt, prefix-hit tail, window,
    # ragged causal, ragged bidirectional, one query
    (512, 512, True, None, 0), (256, 512, True, None, 256),
    (512, 512, True, 100, 0), (333, 333, True, None, 0),
    (200, 333, False, None, 0), (1, 40, True, None, 39),
], ids=["prompt", "tail", "window", "ragged", "bidirectional", "one-query"])
def test_flash_kernel_matches_plain(cuda_device, dtype, case):
    sq, skv, causal, window, q_offset = case
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda_device).to(dtype)
    q, k, v = mk(2, sq, 32, 128), mk(2, skv, 8, 128), mk(2, skv, 8, 128)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = flash.flash_attention_fwd(q, k, v, **kw)
    ref = flash.flash_attention_plain(q, k, v, **kw)
    assert out.shape == q.shape and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=0)


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(cuda_device):
    """q/k/v as head slices of one fused [B, S, H, D] buffer: read in place."""
    x = torch.randn(1, 96, 48, 128, device=cuda_device)
    q, k, v = x[:, :, :32], x[:, :, 32:40], x[:, :, 40:]
    torch.testing.assert_close(flash.flash_attention_fwd(q, k, v),
                               flash.flash_attention_plain(q, k, v),
                               atol=TOL[torch.float32], rtol=0)


@pytest.mark.cuda
def test_legacy_and_fixed_batch_kernel_equals_plain_greedy(cuda_device):
    """The grouped-prefill and fixed-batch engines serve the same greedy
    streams with the CUDA kernels (pallas) and the plain path (xla)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, (n,)).astype(np.int32) for n in (7, 16, 21, 30)]
    streams = []
    for mode in ("pallas", "xla"):
        cfg = reduced(get_config("granite-8b"), kernel_mode=mode)
        model = build_model(cfg, device=cuda_device)
        ops.reset_counts()
        eng = ContinuousServeEngine(cfg, model, device=cuda_device,
                                    num_slots=2, max_len=48)
        reqs = [eng.submit(p, 10) for p in prompts]
        out = eng.run()
        static = ServeEngine(cfg, model, device=cuda_device, max_len=48)
        streams.append([out[r.rid] for r in reqs]
                       + [static.generate(p[None], num_tokens=10)[0]
                          for p in prompts])
        assert (ops.flash_attention.launches > 0) == (mode == "pallas")
    for a, b in zip(*streams):
        np.testing.assert_array_equal(a, b)


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
