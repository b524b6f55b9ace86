"""Torch port, paged attention: the plain torch decode/span functions and
the in-place pool writes against the JAX package (Pallas kernels in
interpret mode, the float64 oracles in ``kernels/attention/ref.py``, the
functional ``cache_utils`` writes) and the dispatch table.  The CUDA
kernels are held against these plain versions in test_torch_cuda.py."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.attention import (  # noqa: E402
    paged_attention, paged_attention_ref, paged_span_attention, paged_span_ref,
)
from repro.models import cache_utils as jax_cu  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels.attention import dispatch, ops, paged  # noqa: E402
from repro_torch.models import cache_utils as cu  # noqa: E402

TOL = dict(atol=2e-6, rtol=2e-6)  # float32 vs float32 / float64 oracles


def _t(x):
    return torch.from_numpy(np.array(x))


def _decode_case(seed, B, W, bs, Hkv, G, D, NB):
    """The JAX kernel tests' decode case: distinct non-NULL blocks per
    slot, trailing table entries NULL."""
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((NB, bs, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((NB, bs, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((B, 1, Hkv * G, D)).astype(np.float32)
    bt = np.zeros((B, W), np.int32)
    ids = rng.permutation(np.arange(1, NB))[:B * W].reshape(B, W)
    alloc = rng.integers(1, W + 1, B)
    for b in range(B):
        bt[b, :alloc[b]] = ids[b, :alloc[b]]
    idx = np.array([int(rng.integers(0, alloc[b] * bs)) for b in range(B)],
                   np.int32)
    return q, kp, vp, bt, idx


def _span_case(seed, B, W, bs, Hkv, G, D, NB, Q, empty_row=True):
    """Ragged rows at block-unaligned starts; the last row has row_len 0
    (an inactive chunk row of the unified step)."""
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((NB, bs, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((NB, bs, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((B, Q, Hkv * G, D)).astype(np.float32)
    bt = np.zeros((B, W), np.int32)
    ids = rng.permutation(np.arange(1, NB))[:B * W].reshape(B, W)
    row_len = rng.integers(1, Q + 1, B).astype(np.int32)
    row_start = np.zeros((B,), np.int32)
    for b in range(B):
        row_start[b] = int(rng.integers(0, W * bs - row_len[b]))
        alloc = (row_start[b] + row_len[b] - 1) // bs + 1
        bt[b, :alloc] = ids[b, :alloc]
    if empty_row:
        row_len[-1] = 0
    return q, kp, vp, bt, row_start, row_len


def _mask_pad(out, row_len):
    q = out.shape[1]
    valid = (np.arange(q)[None, :] < np.asarray(row_len)[:, None])[..., None, None]
    return np.where(valid, np.asarray(out, np.float64), 0.0)


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("G", [1, 4])
def test_plain_decode_matches_pallas_and_oracle(window, G):
    q, kp, vp, bt, idx = _decode_case(0, B=3, W=4, bs=8, Hkv=2, G=G, D=16, NB=32)
    out = paged.paged_decode_plain(_t(q), _t(kp), _t(vp), _t(bt), _t(idx),
                                   window=window).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp)
    kern = paged_attention({"k": jk, "v": jv}, jq, jnp.asarray(bt),
                           jnp.asarray(idx), window=window, interpret=True)
    ref = paged_attention_ref(jq, jk, jv, bt, idx, window=window)
    np.testing.assert_allclose(out, np.asarray(kern), **TOL)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("G", [1, 4])
def test_plain_span_matches_pallas_and_oracle(window, G):
    q, kp, vp, bt, st, ln = _span_case(2, B=4, W=4, bs=8, Hkv=2, G=G, D=16,
                                       NB=32, Q=6)
    out = paged.paged_span_plain(_t(q), _t(kp), _t(vp), _t(bt), _t(st), _t(ln),
                                 window=window).numpy()
    assert np.isfinite(out).all()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp)
    kern = paged_span_attention({"k": jk, "v": jv}, jq, jnp.asarray(bt),
                                jnp.asarray(st), jnp.asarray(ln), window=window,
                                interpret=True)
    ref = paged_span_ref(jq, jk, jv, bt, st, ln, window=window)
    np.testing.assert_allclose(_mask_pad(out, ln), _mask_pad(kern, ln), **TOL)
    np.testing.assert_allclose(_mask_pad(out, ln), np.asarray(ref), **TOL)


def test_single_token_span_equals_decode():
    """A 1-token span IS a paged decode row."""
    q, kp, vp, bt, idx = _decode_case(3, B=3, W=4, bs=8, Hkv=2, G=2, D=16, NB=32)
    dec = paged.paged_decode_plain(_t(q), _t(kp), _t(vp), _t(bt), _t(idx))
    span = paged.paged_span_plain(_t(q), _t(kp), _t(vp), _t(bt), _t(idx),
                                  torch.ones(3, dtype=torch.int32))
    np.testing.assert_allclose(dec.numpy(), span.numpy(), atol=1e-6, rtol=1e-6)


def test_cpu_wrappers_take_plain_path_and_launch_nothing():
    q, kp, vp, bt, idx = _decode_case(1, B=2, W=3, bs=8, Hkv=2, G=4, D=32, NB=16)
    ops.reset_counts()
    out = ops.paged_attention({"k": _t(kp), "v": _t(vp)}, _t(q), _t(bt), _t(idx))
    ref = paged.paged_decode_plain(_t(q), _t(kp), _t(vp), _t(bt), _t(idx))
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    assert ops.paged_attention.launches == 0
    assert paged.paged_decode_plain.calls == 2
    # a quantized pool on the CPU takes the plain path with its scales;
    # codes without their scales are refused, never attended raw
    kc, ks = quant.kv_quantize(_t(kp), "int8")
    vc, vs = quant.kv_quantize(_t(vp), "int8")
    out = ops.paged_attention({"k": kc, "v": vc, "k_scale": ks, "v_scale": vs},
                              _t(q), _t(bt), _t(idx))
    ref = paged.paged_decode_plain(_t(q), kc, vc, _t(bt), _t(idx),
                                   k_scales=ks, v_scales=vs)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    assert ops.paged_attention.launches == ops.paged_attention.quant_launches == 0
    with pytest.raises(ValueError, match="scales"):
        ops.paged_attention({"k": kc, "v": vc}, _t(q), _t(bt), _t(idx))
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged.paged_decode_fwd(_t(q), _t(kp), _t(vp), _t(bt), _t(idx))


def _jax_pool(kp, vp):
    return jnp.asarray(kp), jnp.asarray(vp)


def test_paged_cache_write_matches_jax_incl_null_routing():
    rng = np.random.default_rng(4)
    nb, bs, hkv, d, b, w = 12, 4, 2, 8, 3, 3
    kp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    kn = rng.standard_normal((b, 1, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((b, 1, hkv, d)).astype(np.float32)
    bt = np.array([[3, 5, 0], [7, 0, 0], [0, 0, 0]], np.int32)  # row 2 masked
    idx = np.array([6, 2, 9], np.int32)
    jk, jv = jax_cu.paged_cache_write(*_jax_pool(kp, vp), jnp.asarray(kn),
                                      jnp.asarray(vn), jnp.asarray(bt),
                                      jnp.asarray(idx))
    tk, tv = _t(kp), _t(vp)
    cu.paged_cache_write(tk, tv, _t(kn), _t(vn), _t(bt), _t(idx))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the masked row landed in the NULL block, no live block changed twice
    np.testing.assert_array_equal(tk.numpy()[0, 9 % bs], kn[2, 0])


def test_paged_span_write_matches_jax_incl_null_routing():
    """Padding columns and positions past the table go to the NULL block,
    never into the row's last live block."""
    rng = np.random.default_rng(5)
    nb, bs, hkv, d, b, q = 16, 4, 2, 8, 3, 6
    kp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    kn = rng.standard_normal((b, q, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((b, q, hkv, d)).astype(np.float32)
    bt = np.array([[2, 4, 6], [8, 9, 0], [11, 0, 0]], np.int32)
    st = np.array([3, 5, 1], np.int32)
    ln = np.array([6, 2, 0], np.int32)  # row 0 runs past its 3-block table
    st[0] = 8  # positions 8..13: 12, 13 are past W * bs = 12
    jk, jv = jax_cu.paged_span_write(*_jax_pool(kp, vp), jnp.asarray(kn),
                                     jnp.asarray(vn), jnp.asarray(bt),
                                     jnp.asarray(st), jnp.asarray(ln))
    tk, tv = _t(kp), _t(vp)
    cu.paged_span_write(tk, tv, _t(kn), _t(vn), _t(bt), _t(st), _t(ln))
    live = np.arange(1, nb)  # NULL block 0 holds last-writer-wins garbage
    np.testing.assert_array_equal(tk.numpy()[live], np.asarray(jk)[live])
    np.testing.assert_array_equal(tv.numpy()[live], np.asarray(jv)[live])
    np.testing.assert_array_equal(tk.numpy()[6], np.asarray(jk)[6])
    untouched = [1, 3, 5, 7, 10, 12, 13, 14, 15]
    np.testing.assert_array_equal(tk.numpy()[untouched], kp[untouched])


def test_copy_pool_blocks_matches_jax():
    rng = np.random.default_rng(6)
    leaf = rng.standard_normal((2, 8, 4, 2, 8)).astype(np.float32)
    src, dst = np.array([1, 3], np.int32), np.array([5, 6], np.int32)
    ref = jax_cu.copy_pool_blocks(jnp.asarray(leaf), jnp.asarray(src),
                                  jnp.asarray(dst))
    t = _t(leaf)
    cu.copy_pool_blocks(t, _t(src).long(), _t(dst).long())
    np.testing.assert_array_equal(t.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode,platform,dtype,hd,backend,reason", [
    ("xla", "cuda", "bfloat16", 128, "torch", "mode=xla"),
    ("auto", "cpu", "float32", 32, "torch", "auto: cpu has no CUDA"),
    ("auto", "cuda", "bfloat16", 128, "cuda", "auto: cuda"),
    ("pallas", "cpu", "float32", 32, "cuda", "mode=pallas"),
    ("auto", "cpu", "float16", 32, "torch", "dtype float16 unsupported"),
    ("pallas", "cpu", "float32", 40, "torch", "head_dim 40 not lane-tileable"),
])
def test_dispatch_decisions(mode, platform, dtype, hd, backend, reason):
    for variant in dispatch.VARIANTS:
        d = dispatch.resolve(mode, variant, head_dim=hd, dtype=dtype,
                             platform=platform)
        assert (d.backend, d.reason) == (backend, reason)
        assert d.event_value == dispatch.KERNEL_VARIANT_IDS[d.tag]
    assert dispatch.KERNEL_VARIANT_IDS["paged_decode:cuda"] == 4
    assert dispatch.KERNEL_VARIANT_IDS["paged_span:cuda"] == 6


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_dispatch_takes_quantized_pools_on_paged_variants_only(kv_dtype):
    """The paged kernels fuse the dequant; the dense kernel reads no pool
    and refuses quantized K/V on CUDA instead of falling back."""
    for variant in ("paged_decode", "paged_span"):
        d = dispatch.resolve("auto", variant, head_dim=128, dtype="bfloat16",
                             platform="cuda", kv_dtype=kv_dtype)
        assert d.backend == "cuda"
        assert d.event_value == dispatch.KERNEL_VARIANT_IDS[f"{variant}:cuda"]
    with pytest.raises(NotImplementedError, match="no silent fallback"):
        dispatch.resolve("auto", "dense", head_dim=128, dtype="bfloat16",
                         platform="cuda", kv_dtype=kv_dtype)
    cpu = dispatch.resolve("pallas", "dense", head_dim=32, dtype="float32",
                           platform="cpu", kv_dtype=kv_dtype)
    assert cpu.backend == "torch" and kv_dtype in cpu.reason
    with pytest.raises(ValueError, match="kv_dtype"):
        dispatch.resolve("auto", "paged_decode", head_dim=128,
                         dtype="bfloat16", platform="cuda", kv_dtype="int4")


def test_dispatch_never_falls_back_silently_on_cuda():
    with pytest.raises(NotImplementedError, match="no silent fallback"):
        dispatch.resolve("auto", "paged_decode", head_dim=128,
                         dtype="float16", platform="cuda")
