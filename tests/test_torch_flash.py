"""Torch port, dense flash attention on the CPU: the plain version
(``flash_attention_plain``, what the CUDA kernel is held to on the card)
against the JAX package's Pallas kernel in interpret mode and the float64
``ref.attention_ref`` over the flash kernel test's eight cases; the
``dense`` dispatch decisions; and the CPU path of the ops wrapper, which
launches nothing.  Inputs are drawn from a numpy seed."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.attention import attention_ref  # noqa: E402
from repro.kernels.attention import flash_attention as jax_flash  # noqa: E402
from repro_torch.kernels.attention import dispatch, flash, ops  # noqa: E402

# tests/test_kernels_flash.py's CASES:
# b, sq, skv, hq, hkv, d, causal, window, q_offset
CASES = [
    (2, 128, 128, 4, 4, 64, True, None, 0),      # MHA causal
    (2, 256, 256, 4, 1, 64, True, None, 0),      # MQA
    (1, 256, 256, 8, 2, 128, True, None, 0),     # GQA, d=128
    (1, 128, 128, 2, 2, 64, False, None, 0),     # bidirectional
    (1, 384, 384, 2, 1, 64, True, 128, 0),       # sliding window
    (2, 200, 200, 2, 2, 64, True, None, 0),      # ragged length
    (1, 128, 384, 2, 2, 64, True, None, 256),    # chunked prefill (q_offset)
    (1, 64, 512, 4, 4, 64, True, 96, 448),       # SWA + offset
]
# allclose tolerances (atol = rtol): float32 differs in summation order
# only; bf16 adds one output rounding and the plain path's bf16 rounding
# of the softmax weights (the JAX XLA path's), which the kernel skips
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(case, dtype, seed=0):
    b, sq, skv, hq, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    # identical values on both sides: round through jax's dtype first
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
def test_plain_matches_jax_kernel_and_f64_ref(case, dtype):
    causal, window, q_offset = case[6:]
    (jq, jk, jv), (q, k, v) = _inputs(case, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    mine = flash.flash_attention_plain(q, k, v, **kw)
    assert mine.shape == q.shape and mine.dtype == q.dtype
    mine = mine.float().numpy()
    theirs = np.asarray(jax_flash(jq, jk, jv, interpret=True, **kw), np.float32)
    ref = np.asarray(attention_ref(jq, jk, jv, **kw), np.float32)
    tol = TOL[dtype]
    np.testing.assert_allclose(mine, theirs, rtol=tol, atol=tol)
    np.testing.assert_allclose(mine, ref, rtol=tol, atol=tol)


def test_ragged_bidirectional_attends_only_real_keys():
    """The port masks the true Skv; the JAX kernel is handed lengths padded
    to its 128 block, so a non-causal call with a ragged Skv also attends
    the zero padding there (causal calls agree: causality hides it)."""
    case = (1, 128, 200, 2, 2, 64, False, None, 0)
    (jq, jk, jv), (q, k, v) = _inputs(case, "float32", seed=1)
    mine = flash.flash_attention_plain(q, k, v, causal=False).numpy()
    ref = np.asarray(attention_ref(jq, jk, jv, causal=False))
    np.testing.assert_allclose(mine, ref, rtol=2e-5, atol=2e-5)
    padded = np.asarray(jax_flash(jq, jk, jv, causal=False, interpret=True))
    assert np.abs(padded - ref).max() > 1e-2


@pytest.mark.parametrize("mode,platform,backend", [
    ("auto", "cuda", "cuda"), ("auto", "cpu", "torch"),
    ("pallas", "cuda", "cuda"), ("pallas", "cpu", "cuda"),
    ("xla", "cuda", "torch"), ("xla", "cpu", "torch"),
])
def test_dense_dispatch_decisions(mode, platform, backend):
    d = dispatch.resolve(mode, "dense", head_dim=128, dtype="bfloat16",
                         platform=platform)
    assert (d.variant, d.backend) == ("dense", backend)
    assert d.event_value == dispatch.KERNEL_VARIANT_IDS[f"dense:{backend}"]
    assert d.event_value in (1, 2)


def test_dense_dispatch_never_falls_back_on_cuda():
    with pytest.raises(NotImplementedError, match="no silent fallback"):
        dispatch.resolve("auto", "dense", head_dim=48, dtype="float32",
                         platform="cuda")
    with pytest.raises(NotImplementedError, match="no silent fallback"):
        dispatch.resolve("pallas", "dense", head_dim=128, dtype="float16",
                         platform="cuda")
    cpu = dispatch.resolve("auto", "dense", head_dim=48, dtype="float32",
                           platform="cpu")
    assert cpu.backend == "torch" and "head_dim" in cpu.reason


def test_cpu_wrapper_launches_nothing():
    (_, _, _), (q, k, v) = _inputs(CASES[2], "float32")
    ops.reset_counts()
    out = ops.flash_attention(q, k, v, causal=True, q_offset=0)
    assert ops.flash_attention.launches == 0
    assert flash.flash_attention_plain.calls == 1
    torch.testing.assert_close(out, flash.flash_attention_plain(q, k, v))
    ops.reset_counts()
    assert flash.flash_attention_plain.calls == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash.flash_attention_fwd(q, k, v)
