"""Torch port, the host side of the paged-decode kernel's key splits
(kernels 1/1q), which the CPU reaches without a card: the split plan from
the shapes; the kernel's split-and-merge computation written in plain f32
torch (each split's (m, l, acc) over the source's ``split_range``, then
``paged_merge_kernel``'s formula) held to the unsplit plain path, to the
float64 oracle and to the JAX package's ``paged_attention_ref``; the
launcher's ``splits`` checks, which run before its CUDA-device check; and
the decode CTA's shared-memory budget against the source layout."""
from __future__ import annotations

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.attention import paged_attention_ref as jax_decode_ref  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels.attention import paged, ref  # noqa: E402

LOG2E = 1.4426950408889634


@pytest.mark.parametrize("b,hkv,w,sms,splits", [
    (4, 8, 34, 132, 8),    # the main path: 4 slots x 8 kv heads, capped
                           # at 34 // MIN_SPLIT_BLOCKS
    (4, 8, 160, 132, 9),   # the same slots over a longer table
    (64, 8, 34, 132, 1),   # enough CTAs without a split: no merge
    (1, 8, 160, 132, 16),  # a 2560-token slot: capped at MAX_SPLITS
    (4, 8, 3, 132, 1),     # a table below MIN_SPLIT_BLOCKS entries
    (4, 32, 34, 132, 3),   # codeqwen, G 1
    (4, 4, 34, 132, 8),    # yi, G 8
    (4, 1, 34, 132, 8),    # recurrentgemma, G 16
])
def test_decode_split_plan(b, hkv, w, sms, splits):
    assert paged.decode_split_plan(b, hkv, w, sms) == splits
    assert 1 <= splits <= paged.MAX_SPLITS
    assert splits == 1 or w // splits >= paged.MIN_SPLIT_BLOCKS
    # no more splits than fill the SMs DECODE_FILL times
    assert splits == 1 or b * hkv * (splits - 1) < paged.DECODE_FILL * sms


def _split_range(start, w, bs, window, split, splits):
    """The source's split_range for one query at ``start``."""
    w_hi = min(w - 1, start // bs)
    w_lo = 0
    if window and start - window - bs + 1 >= 0:
        w_lo = (start - window - bs + 1) // bs + 1
    per = (w_hi - w_lo + splits) // splits
    s_lo = w_lo + split * per
    return s_lo, max(0, min(w_hi + 1, s_lo + per) - s_lo)


def split_and_merge(q, kp, vp, bt, index, *, window=None, splits,
                    k_scales=None, v_scales=None):
    """The decode kernel's computation in plain f32 torch: per (slot,
    split), an f32 online-softmax state (m, l, acc) in log2 units over the
    split's table entries (NULL entries skipped, keys masked to the causal
    window), then out = sum_s 2^(m_s - M) acc_s / max(sum_s 2^(m_s - M)
    l_s, 1e-30), a split that saw no key adding nothing."""
    b, _, hq, d = q.shape
    w, bs, hkv = bt.shape[1], kp.shape[1], kp.shape[2]
    k = paged._gathered_view(kp, k_scales, bt, torch.float32)
    v = paged._gathered_view(vp, v_scales, bt, torch.float32)
    scale = LOG2E / d ** 0.5
    out = torch.zeros(b, 1, hq, d)
    for i in range(b):
        qg = q[i, 0].float().reshape(hkv, hq // hkv, d)
        pos = int(index[i])
        parts = []
        for split in range(splits):
            s_lo, n = _split_range(pos, w, bs, window, split, splits)
            keys = [e * bs + t for e in range(s_lo, s_lo + n) if bt[i, e] != 0
                    for t in range(bs)]
            keys = [t for t in keys if t <= pos and (not window or t > pos - window)]
            if not keys:
                parts.append((torch.full((hkv, hq // hkv), -torch.inf), None, None))
                continue
            kk, vv = k[i, keys].transpose(0, 1), v[i, keys].transpose(0, 1)
            s = torch.einsum("kgd,ktd->kgt", qg, kk) * scale
            m = s.amax(-1)
            p = torch.exp2(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgt,ktd->kgd", p, vv)))
        big = torch.stack([m for m, _, _ in parts]).amax(0)
        num, den = torch.zeros(hkv, hq // hkv, d), torch.zeros(hkv, hq // hkv)
        for m, l, acc in parts:
            if l is None:
                continue
            wgt = torch.exp2(m - big)
            num += wgt[..., None] * acc
            den += wgt * l
        out[i, 0] = (num / den.clamp(min=1e-30)[..., None]).reshape(hq, d)
    return out


def _case(seed):
    """Seeded numpy inputs: 4 slots at 0 (one key), 17, 300 and 319 over a
    40-entry table of 8-token blocks, distinct live blocks up to each
    slot's position and NULL (block 0) tails after it."""
    rng = np.random.default_rng(seed)
    nb, w, bs, hkv, g, d = 200, 40, 8, 2, 4, 32
    kp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    q = rng.standard_normal((4, 1, hkv * g, d)).astype(np.float32)
    idx = np.array([0, 17, 300, 319], np.int32)
    bt = np.zeros((4, w), np.int32)
    ids = rng.permutation(np.arange(1, nb))[:4 * w].reshape(4, w)
    for i, p in enumerate(idx):
        bt[i, :p // bs + 1] = ids[i, :p // bs + 1]
    return q, kp, vp, bt, idx


@pytest.mark.parametrize("splits", [1, 2, 5, 16])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("kv_dtype", ["fp16", "int8"])
def test_split_and_merge_matches_plain_oracle_and_jax(kv_dtype, window, splits):
    """Window 100 at 300 (and at 319) leaves 13 table entries: 16 splits
    leave three of them without an entry, and the first covers an entry
    the window cuts."""
    q, kp, vp, bt, idx = _case(3)
    tq, tk, tv, tbt, tidx = (torch.from_numpy(x) for x in (q, kp, vp, bt, idx))
    sc, k64, v64 = {}, kp.astype(np.float64), vp.astype(np.float64)
    if kv_dtype != "fp16":
        tk, ks = quant.kv_quantize(tk, kv_dtype)
        tv, vs = quant.kv_quantize(tv, kv_dtype)
        sc = {"k_scales": ks, "v_scales": vs}
        k64, v64 = (c.float().double().numpy() * s.double().numpy()[..., None]
                    for c, s in ((tk, ks), (tv, vs)))
    got = split_and_merge(tq, tk, tv, tbt, tidx, window=window, splits=splits,
                          **sc)
    plain = paged.paged_decode_plain(tq, tk, tv, tbt, tidx, window=window,
                                     **sc)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    want = ref.paged_attention_ref(tq, tk, tv, tbt, tidx, window=window, **sc)
    assert ref.check_ratio(got, want) <= 1.0
    with jax.enable_x64(True):
        jax_out = np.asarray(jax_decode_ref(q.astype(np.float64), k64, v64, bt,
                                            idx, window=window))
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=1e-5, atol=1e-5)


def _decode_args(dtype=torch.bfloat16, *, d=128, bs=16):
    q = torch.zeros((2, 1, 8, d), dtype=dtype)
    pool = torch.zeros((12, bs, 2, d), dtype=dtype)
    return [q, pool, pool.clone(), torch.zeros((2, 6), dtype=torch.int32),
            torch.zeros((2,), dtype=torch.int32)]


@pytest.mark.parametrize("splits", [0, paged.MAX_SPLITS + 1, 2.0, "2", -1])
def test_decode_launcher_refuses_splits_before_the_device(splits):
    with pytest.raises(ValueError, match="splits"):
        paged.paged_decode_fwd(*_decode_args(), splits=splits)


@pytest.mark.parametrize("splits", [None, 1, paged.MAX_SPLITS])
def test_decode_launcher_takes_splits_then_needs_cuda(splits):
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged.paged_decode_fwd(*_decode_args(), splits=splits)


@pytest.mark.parametrize("bs,d,item,quantized", [
    (8, 32, 1, True), (16, 128, 2, False), (16, 128, 1, True),
    (48, 256, 2, False), (8, 256, 4, False),
])
def test_decode_smem_budget_matches_the_source_layout(bs, d, item, quantized):
    """decode_smem_bytes: the 4-stage ring of K and V blocks (+ their f32
    scales), whose bytes then hold the 4 warps' acc[4][d] and (m, l)[4];
    the ring is the larger for every block size the launcher takes, so
    the budget is the ring's, as before the warps split keys."""
    ring = 4 * (2 * bs * d * item + (8 * bs if quantized else 0))
    states = 4 * 4 * (d + 2) * 4
    assert paged._decode_smem(bs, d, item, quantized) == max(ring, states) == ring
    assert ring <= paged._SMEM_LIMIT
