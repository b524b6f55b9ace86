"""Torch port, dense flash attention on the CPU: the plain version
(``flash_attention_plain``, what the CUDA kernel is held to on the card)
against the JAX package's Pallas kernel in interpret mode and the float64
``ref.attention_ref`` over the flash kernel test's eight cases; the port's
float64 oracle (``kernels/attention/ref.py`` ``dense_ref`` with
``causal``, and its ``flash_ref`` adapter) against the JAX ``dense_ref``,
and the plain version held to its check; the host side of the
tensor-core body (its tile plan, shared-memory budget and the launcher's
argument checks, which run before the CUDA-device check); the ``dense``
dispatch decisions; and the CPU path of the ops wrapper, which launches
nothing.  Inputs are drawn from a numpy seed."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.attention import attention_ref  # noqa: E402
from repro.kernels.attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.attention.ref import dense_ref as jax_dense_ref  # noqa: E402
from repro_torch.kernels.attention import dispatch, flash, ops, ref  # noqa: E402

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


# ----------------------------------------------------------------------
# the float64 oracle the kernel is held to on the card
# ----------------------------------------------------------------------
# the port's oracle and the JAX reference compute the same float64
# expression in another order: a few float64 ulps of |out| <= ~4
TOL64 = 1e-12


@pytest.mark.parametrize("g", [1, 4, 8, 12])
@pytest.mark.parametrize("q_offset", [0, 256])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_dense_ref_matches_jax_dense_ref(causal, window, q_offset, g):
    """Ragged Sq 37 against Skv = q_offset + 45 (keys past the last query
    attend only without causality), 2 kv heads x G, D 16, batch 2."""
    rng = np.random.default_rng(g * 10 + q_offset + (window or 0))
    sq, skv, hkv, d = 37, q_offset + 45, 2, 16
    q = rng.standard_normal((2, sq, hkv * g, d))
    k = rng.standard_normal((2, skv, hkv, d))
    v = rng.standard_normal((2, skv, hkv, d))
    q_pos, kv_pos = q_offset + np.arange(sq), np.arange(skv)
    want = jax_dense_ref(q, k, v, q_pos, kv_pos, causal=causal, window=window)
    got = ref.dense_ref(q, k, v, q_pos, kv_pos, causal=causal, window=window)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL64)
    adapter = ref.flash_ref(q, k, v, causal=causal, window=window,
                            q_offset=q_offset)
    np.testing.assert_array_equal(adapter, got)
    as_torch = ref.flash_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=causal, window=window, q_offset=q_offset)
    np.testing.assert_array_equal(as_torch.numpy(), got)


def test_dense_ref_default_is_causal_and_masked_rows_are_zero():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s) for s in ((1, 6, 2, 8), (1, 9, 1, 8),
                                                (1, 9, 1, 8)))
    pos = np.arange(6)
    np.testing.assert_array_equal(
        ref.dense_ref(q, k, v, pos, np.arange(9)),
        ref.dense_ref(q, k, v, pos, np.arange(9), causal=True))
    # keys at 20.. are all in every query's future: zeros, never NaN
    out = ref.dense_ref(q, k, v, pos, 20 + np.arange(9))
    assert (out == 0).all()


@pytest.mark.parametrize("case", CASES + [
    (1, 96, 96, 8, 8, 32, True, None, 0),        # G 1
    (1, 64, 200, 16, 2, 32, False, 50, 100),     # G 8, bidirectional window
    (2, 70, 170, 24, 2, 64, True, 40, 100),      # G 12, window + offset
], ids=[str(i) for i in range(len(CASES) + 3)])
def test_plain_f32_holds_to_oracle(case):
    """The plain version in float32 within the float32 check (1e-4, 1e-4)
    of the float64 oracle: its softmax weights stay float32."""
    causal, window, q_offset = case[6:]
    (_, _, _), (q, k, v) = _inputs(case, "float32", seed=3)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = flash.flash_attention_plain(q, k, v, **kw)
    assert ref.check_ratio(out, ref.flash_ref(q, k, v, **kw)) <= 1.0


# ----------------------------------------------------------------------
# the tensor-core body's host side
# ----------------------------------------------------------------------
@pytest.mark.parametrize("sq,hq,hkv,plan", [
    (512, 32, 8, (16, 32)),      # granite-8b: 32 tiles x 8 kv heads
    (256, 32, 8, (16, 16)),      # the prefix-hit tail
    (333, 32, 8, (16, 21)),      # ragged: the last tile 13 queries
    (512, 32, 32, (64, 8)),      # codeqwen G 1
    (512, 32, 4, (8, 64)),       # yi G 8
    (512, 96, 8, (5, 103)),      # mistral-large G 12: 60 of 64 rows
    (1, 32, 8, (16, 1)),         # one query
])
def test_flash_tile_plan(sq, hq, hkv, plan):
    queries, tiles = flash.tile_plan(sq, hq, hkv)
    assert (queries, tiles) == plan
    assert hq // hkv * queries <= flash.TILE_ROWS
    assert tiles * queries >= sq > (tiles - 1) * queries


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_smem_budget_matches_the_source_layout(d):
    """bf16: TcTile<D>::smem, the 64-row q tile and 2 ring stages of K and
    V tiles (64 keys; 32 at D 256) at the padded row of D + 8 bf16, small
    enough for two CTAs an SM; f32: Tile<float, D>::smem, q [D][64],
    K [D][68], V [64][D], P [64][65] f32.  Both fit one CTA."""
    ld, keys = d + 8, (64 if d <= 128 else 32)
    bf16 = 64 * ld * 2 + 2 * 2 * keys * ld * 2
    assert 2 * (bf16 + 1024) <= 228 * 1024  # two CTAs an SM
    f32 = 4 * (d * 64) + 4 * (d * (64 + 4)) + 4 * (64 * d) + 4 * (64 * 65)
    assert flash._smem_bytes(torch.bfloat16, d) == bf16
    assert flash._smem_bytes(torch.float32, d) == f32
    assert max(bf16, f32) <= flash._SMEM_LIMIT


def _flash_args(dtype=torch.bfloat16, d=64):
    q = torch.zeros((2, 16, 8, d), dtype=dtype)
    k = torch.zeros((2, 20, 2, d), dtype=dtype)
    return [q, k, k.clone()], {}


@pytest.mark.parametrize("mutate,match", [
    (lambda a, kw: a.__setitem__(0, a[0].half()), "unsupported"),
    (lambda a, kw: a.__setitem__(2, a[2].float()), "differs"),
    (lambda a, kw: a.__setitem__(0, a[0][0]), r"\[B, Sq, Hq, D\]"),
    (lambda a, kw: a.__setitem__(1, a[1][:, :7]), r"\[B, Sq, Hq, D\]"),
    (lambda a, kw: [a.__setitem__(i, a[i][:1]) for i in (1, 2)], "do not match"),
    (lambda a, kw: [a.__setitem__(i, a[i][..., :48]) for i in range(3)],
     "head_dim"),
    (lambda a, kw: a.__setitem__(0, a[0][:, :, :5]), "multiple of kv"),
    (lambda a, kw: [a.__setitem__(0, torch.zeros(2, 16, 130, 64, dtype=a[0].dtype)),
                    [a.__setitem__(i, a[i][:, :, :1]) for i in (1, 2)]],
     "rows a CTA"),
    (lambda a, kw: a.__setitem__(0, torch.zeros(2, 16, 8, 68, dtype=a[0].dtype)[..., :64]),
     "strides"),
    (lambda a, kw: a.__setitem__(0, torch.zeros(2, 16, 64, 8, dtype=a[0].dtype)
                                 .transpose(2, 3)), "strides"),
    (lambda a, kw: kw.update(window=0), "window"),
    (lambda a, kw: kw.update(q_offset=-1), "q_offset"),
], ids=["f16", "dtype-mismatch", "q-dims", "kv-shape", "batch", "head-dim",
        "gqa", "gqa-fold", "stride", "head-dim-stride", "window-0", "q-offset"])
def test_flash_launcher_refuses_what_the_kernel_cannot_take(mutate, match):
    args, kw = _flash_args()
    mutate(args, kw)
    with pytest.raises(ValueError, match=match):
        flash.flash_attention_fwd(*args, **kw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_launcher_args_that_pass_every_check_need_cuda(dtype, d):
    """Strided views of a fused buffer, a window and an offset pass every
    argument check; only the device is left."""
    x = torch.zeros((2, 40, 12, d), dtype=dtype)
    q, k, v = x[:, :, :8], x[:, :, 8:10], x[:, :, 10:]
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash.flash_attention_fwd(q, k, v, window=7, q_offset=3)


def test_flash_f32_body_takes_any_gqa_group():
    """The f32 CUDA-core body runs one q head a CTA, so the bf16 body's
    64-row fold does not bound its G."""
    q = torch.zeros((1, 8, 130, 64))
    k = torch.zeros((1, 8, 1, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash.flash_attention_fwd(q, k, k.clone())
