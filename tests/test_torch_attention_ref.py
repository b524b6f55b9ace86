"""Torch port, the float64 attention oracle (``kernels/attention/ref.py``)
against the JAX package's ``paged_span_ref`` / ``paged_attention_ref``
(run under float64), on native and quantized pools; the plain span path
held to the oracle's check; the check itself; and the host side of the
tensor-core span body (its key-split plan and the launcher's argument
checks), which the CPU reaches without a card."""
from __future__ import annotations

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.attention import paged_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.attention import paged_span_ref as jax_span_ref  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels.attention import paged, ref  # noqa: E402

# the oracle and the JAX reference compute the same float64 expression
# in another order: they agree to a few float64 ulps of |out| <= ~4
TOL64 = 1e-12


def _pool_case(seed, *, B, W, bs, Hkv, G, D, NB, Q, starts, lens):
    """Seeded numpy inputs: distinct live blocks for every position up to a
    row's last query, NULL (block 0) entries after it."""
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((NB, bs, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((NB, bs, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((B, Q, Hkv * G, D)).astype(np.float32)
    bt = np.zeros((B, W), np.int32)
    ids = rng.permutation(np.arange(1, NB))[:B * W].reshape(B, W)
    for b in range(B):
        live = (starts[b] + max(lens[b], 1) - 1) // bs + 1
        bt[b, :live] = ids[b, :live]
    return q, kp, vp, bt, np.asarray(starts, np.int32), np.asarray(lens, np.int32)


SPAN = dict(B=3, W=6, bs=8, Hkv=2, G=4, D=32, NB=40, Q=7,
            starts=[0, 13, 30], lens=[7, 5, 0])


def _quantized(kp, vp, kv_dtype):
    """Codes and scales as the engine stores them, and the pool each
    dequantizes to in float64."""
    kc, ks = quant.kv_quantize(torch.from_numpy(kp), kv_dtype)
    vc, vs = quant.kv_quantize(torch.from_numpy(vp), kv_dtype)
    deq = [c.float().double().numpy() * s.double().numpy()[..., None]
           for c, s in ((kc, ks), (vc, vs))]
    return kc, vc, ks, vs, deq


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("kv_dtype", ["fp16", "int8", "fp8"])
def test_span_oracle_matches_jax_reference(kv_dtype, window):
    q, kp, vp, bt, st, ln = _pool_case(0, **SPAN)
    q64 = q.astype(np.float64)
    if kv_dtype == "fp16":
        got = ref.paged_span_ref(q64, kp, vp, bt, st, ln, window=window)
        k_deq, v_deq = kp.astype(np.float64), vp.astype(np.float64)
    else:
        kc, vc, ks, vs, (k_deq, v_deq) = _quantized(kp, vp, kv_dtype)
        got = ref.paged_span_ref(q64, kc, vc, bt, st, ln, window=window,
                                 k_scales=ks, v_scales=vs)
    with jax.enable_x64(True):
        want = np.asarray(jax_span_ref(q64, k_deq, v_deq, bt, st, ln,
                                       window=window))
    assert got.dtype == np.float64 and want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL64)
    assert (got[2] == 0).all()  # row_len == 0: zeros


@pytest.mark.parametrize("kv_dtype", ["fp16", "int8"])
def test_decode_oracle_matches_jax_reference(kv_dtype):
    q, kp, vp, bt, idx, _ = _pool_case(1, B=3, W=5, bs=8, Hkv=2, G=4, D=32,
                                       NB=32, Q=1, starts=[0, 17, 39],
                                       lens=[1, 1, 1])
    q64 = q.astype(np.float64)
    if kv_dtype == "fp16":
        got = ref.paged_attention_ref(q64, kp, vp, bt, idx, window=11)
        k_deq, v_deq = kp.astype(np.float64), vp.astype(np.float64)
    else:
        kc, vc, ks, vs, (k_deq, v_deq) = _quantized(kp, vp, kv_dtype)
        got = ref.paged_attention_ref(q64, kc, vc, bt, idx, window=11,
                                      k_scales=ks, v_scales=vs)
    with jax.enable_x64(True):
        want = np.asarray(jax_decode_ref(q64, k_deq, v_deq, bt, idx, window=11))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL64)


def test_oracle_takes_torch_float64_and_numpy_alike():
    q, kp, vp, bt, st, ln = _pool_case(2, **SPAN)
    t = [torch.from_numpy(x) for x in (q, kp, vp, bt, st, ln)]
    out = ref.paged_span_ref(*t, window=9)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float64
    np.testing.assert_array_equal(out.numpy(),
                                  ref.paged_span_ref(q, kp, vp, bt, st, ln,
                                                     window=9))


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("kv_dtype", ["fp16", "int8", "fp8"])
def test_plain_span_f32_holds_to_oracle(kv_dtype, window):
    """The plain path in float32 (its softmax weights stay float32, a
    quantized view dequantizes to float32) within the float32 check
    (1e-4, 1e-4) of the oracle on every valid query."""
    q, kp, vp, bt, st, ln = (torch.from_numpy(x) for x in _pool_case(3, **SPAN))
    scales = {}
    if kv_dtype != "fp16":
        kp, ks = quant.kv_quantize(kp, kv_dtype)
        vp, vs = quant.kv_quantize(vp, kv_dtype)
        scales = {"k_scales": ks, "v_scales": vs}
    out = paged.paged_span_plain(q, kp, vp, bt, st, ln, window=window, **scales)
    want = ref.paged_span_ref(q, kp, vp, bt, st, ln, window=window, **scales)
    valid = ref.span_valid(ln, q.shape[1])
    assert ref.check_ratio(out, want, valid=valid) <= 1.0
    assert out.dtype == torch.float32


@pytest.mark.parametrize("factor,passes", [(0.9, True), (1.1, False)])
def test_check_ratio_edge(factor, passes):
    """An error of ``factor`` times the allowance, on every element."""
    rng = np.random.default_rng(4)
    want = torch.from_numpy(rng.standard_normal((3, 5, 4, 8)))
    rtol, atol = ref.CHECK[torch.bfloat16]
    allow = rtol * want.abs() + atol * want.abs().max()
    got = want + factor * allow * torch.sign(torch.from_numpy(
        rng.standard_normal(want.shape)))
    ratio = ref.check_ratio(got, want, rtol, atol)
    assert ratio == pytest.approx(factor, rel=1e-9)
    assert (ratio <= 1.0) is passes
    got[0, 0, 0, 0] = float("nan")
    assert ref.check_ratio(got, want, rtol, atol) == float("inf")


def test_check_ratio_reads_valid_rows_only():
    want = torch.zeros((2, 3, 1, 4), dtype=torch.float64)
    want[:, :2] = 1.0
    got = want.clone()
    got[1, 2] = 7.0  # a query past row_len: garbage by contract
    valid = ref.span_valid(torch.tensor([3, 2]), 3)
    assert ref.check_ratio(got, want, 1e-4, 1e-4, valid=valid) == 0.0
    assert ref.check_ratio(got, want, 1e-4, 1e-4) > 1.0


# ----------------------------------------------------------------------
# the tensor-core span body's host side
# ----------------------------------------------------------------------
@pytest.mark.parametrize("b,hkv,rows,w,sms,plan", [
    (2, 8, 128, 34, 132, (1, 8)),    # the main path: 2 chunk rows x 8 kv heads
    (3, 8, 128, 34, 132, (1, 6)),    # + a row_len == 0 row
    (1, 8, 20, 34, 132, (1, 8)),     # a 5-token spec row: one ragged tile
    (1, 8, 128, 160, 132, (1, 16)),  # a 2560-token table: capped at 16
    (2, 8, 128, 3, 132, (1, 1)),     # a table too short to split
    (64, 8, 128, 34, 132, (1, 1)),   # enough CTAs without a split
    (1, 8, 384, 34, 132, (3, 6)),    # G = 12: three row tiles
])
def test_span_split_plan(b, hkv, rows, w, sms, plan):
    tiles, splits = paged.span_split_plan(b, hkv, rows, w, sms)
    assert (tiles, splits) == plan
    assert tiles * paged.SPAN_TILE_ROWS >= rows > (tiles - 1) * paged.SPAN_TILE_ROWS
    assert 1 <= splits <= paged.MAX_SPLITS
    assert splits == 1 or w // splits >= paged.MIN_SPLIT_BLOCKS


def _span_args(dtype=torch.bfloat16, *, d=128, bs=16, kv=None, b=2, q_len=32):
    nb, hkv = 12, 2
    q = torch.zeros((b, q_len, hkv * 4, d), dtype=dtype)
    pool = torch.zeros((nb, bs, hkv, d), dtype=kv or dtype)
    bt = torch.zeros((b, 6), dtype=torch.int32)
    st = torch.zeros((b,), dtype=torch.int32)
    return [q, pool, pool.clone(), bt, st, st.clone()]


@pytest.mark.parametrize("mutate,match", [
    (lambda a, kw: a.__setitem__(0, a[0].half()), "dtype"),
    (lambda a, kw: a.__setitem__(2, a[2].float()), "differ"),
    (lambda a, kw: a.__setitem__(0, a[0].transpose(1, 2)), "contiguous"),
    (lambda a, kw: a.__setitem__(0, a[0][..., :48].contiguous()), "head_dim"),
    (lambda a, kw: a.__setitem__(0, a[0][:, :, :5].contiguous()), "multiple of kv"),
    (lambda a, kw: [a.__setitem__(i, a[i][:, :12].contiguous()) for i in (1, 2)],
     "block_size"),
    (lambda a, kw: a.__setitem__(3, a[3].long()), "block_tables"),
    (lambda a, kw: a.__setitem__(5, a[5].long()), "row_len"),
    (lambda a, kw: kw.update(splits=0), "splits"),
    (lambda a, kw: kw.update(splits=paged.MAX_SPLITS + 1), "splits"),
    (lambda a, kw: kw.update(splits=2.0), "splits"),
    (lambda a, kw: kw.update(window=0), "window"),
], ids=["f16-q", "pool-mismatch", "strided-q", "head-dim", "gqa", "block-size",
        "table-dtype", "len-dtype", "splits-0", "splits-17", "splits-float",
        "window-0"])
def test_span_launcher_refuses_what_the_kernel_cannot_take(mutate, match):
    args, kw = _span_args(), {}
    mutate(args, kw)
    with pytest.raises(ValueError, match=match):
        paged.paged_span_fwd(*args, **kw)


def test_span_launcher_checks_the_tensor_core_body_by_q_dtype():
    """bf16 q: the tensor-core CTA's shared memory (a 128-row q tile on top
    of the ring) must fit; f32 q keeps the CUDA-core body's budget and
    takes no key split.  Arguments that pass every check then need CUDA."""
    big = _span_args(d=256, bs=48)  # 67.6 KB q tile + 4 x 50.7 KB stages
    with pytest.raises(ValueError, match="shared memory"):
        paged.paged_span_fwd(*big)
    with pytest.raises(ValueError, match="CUDA tensors"):  # decode: 4 x 48 KB
        paged.paged_decode_fwd(big[0][:, :1].contiguous(), *big[1:4], big[4])
    with pytest.raises(ValueError, match="CUDA tensors"):  # f32: 4 x 32 KB
        paged.paged_span_fwd(*_span_args(torch.float32, d=256, bs=16))
    with pytest.raises(ValueError, match="does not split"):
        paged.paged_span_fwd(*_span_args(torch.float32), splits=2)
    for kv in (None, torch.int8, torch.float8_e4m3fn):
        args = _span_args(kv=kv)
        scales = {}
        if kv is not None:
            s = torch.ones(args[1].shape[:3])
            scales = {"k_scales": s, "v_scales": s.clone()}
        with pytest.raises(ValueError, match="CUDA tensors"):
            paged.paged_span_fwd(*args, splits=1, **scales)
        with pytest.raises(ValueError, match="scales"):  # codes alone
            paged.paged_span_fwd(*args, **({} if kv else
                                           {"k_scales": torch.ones(1),
                                            "v_scales": torch.ones(1)}))


@pytest.mark.parametrize("bs,d,quantized", [(16, 128, False), (16, 128, True),
                                             (8, 32, False), (16, 256, True)])
def test_span_smem_budget_matches_the_source_layout(bs, d, quantized):
    """The launcher's shared-memory sum is the source's tc_smem_bytes:
    q tile 128 x (d + 8) bf16, 4 ring stages, one converted block."""
    ld, bs16 = d + 8, -(-bs // 16) * 16
    stage = (2 * bs * d + 8 * bs) if quantized else 2 * bs16 * ld * 2
    want = 128 * ld * 2 + 4 * stage + (2 * bs16 * ld * 2 if quantized else 0)
    assert paged._span_tc_smem(bs, d, 1 if quantized else 2, quantized) == want
    assert want <= paged._SMEM_LIMIT
