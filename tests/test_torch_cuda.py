"""Torch port on the card: the CUDA paged kernels (native and quantized
int8/fp8 pools) and the flash kernel against their plain torch versions,
the paged decode and span bodies and the flash kernel against the float64
attention oracle (span at GQA groups 1, 4, 8 and 12; decode at 1, 4, 8, 12
and 16, a 2560-token slot, 64 slots and position 0, with the plan's key
splits and one forced split; the beam-prefill span row of Q 512 at G 4
and 1), the moe block on the card against the CPU at bf16, an int8
fork's CoW copy of codes and scales,
the SSD scan kernel and its plain version against the float64 oracle
(the bf16 tensor-core body also at 2560 tokens, S 1 and 17, ragged
tails, the narrow P tiles, padded N and strided views), the flash and
decode kernels at recurrentgemma's (G 16, D 256, window 2048) and
internvl2's (G 2, D 128) shapes, and the engines' kernel-vs-plain greedy
invariant (reduced recurrentgemma and internvl2 on all three engines
too).

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
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels.attention import flash, ops, paged  # noqa: E402
from repro_torch.kernels.attention import ref as attn_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import scan as ssd_scan  # noqa: E402
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
@pytest.mark.parametrize("kv_dtype", ["fp16", "int8", "fp8"])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("case", [
    # q_len, d, w, nb, starts, lens: the main-path rows (+ a row_len == 0
    # row), a block-unaligned start with a 5-token row (Q*G = 20), a
    # 2560-token table (the key split at work), head dim 64
    (32, 128, 34, 512, [192, 416, 0], [32, 17, 0]),
    (5, 128, 34, 512, [203, 37, 0], [5, 3, 0]),
    (32, 128, 160, 512, [2500, 1203], [32, 9]),
    (32, 64, 34, 512, [192, 416, 0], [32, 17, 0]),
], ids=["main", "unaligned-5", "long-table", "d64"])
def test_span_tensor_core_body_holds_to_f64_oracle(cuda_device, kv_dtype,
                                                   window, case):
    """Kernel 2/2q with bf16 q (the tensor-core body), with the plan's key
    splits and with one forced split, each within the stated check of the
    float64 oracle on every valid query; the two differ by at most one
    bf16 rounding (``ref.SPLIT_CHECK``); row_len == 0 rows are zeros."""
    q_len, d, w, nb, starts, lens = case
    q, kp, vp, bt, st, ln = _case(cuda_device, torch.bfloat16, b=len(starts),
                                  q_len=q_len, starts=starts, lens=lens, d=d,
                                  w=w, nb=nb)
    sc = {}
    if kv_dtype != "fp16":
        kp, vp, sc = _quantize_pool(kp, vp, kv_dtype)
    out = paged.paged_span_fwd(q, kp, vp, bt, st, ln, window=window, **sc)
    one = paged.paged_span_fwd(q, kp, vp, bt, st, ln, window=window, splits=1,
                               **sc)
    want = attn_ref.paged_span_ref(q, kp, vp, bt, st, ln, window=window, **sc)
    valid = attn_ref.span_valid(ln, q_len)
    assert torch.isfinite(out).all()
    assert attn_ref.check_ratio(out, want, valid=valid) <= 1.0
    assert attn_ref.check_ratio(one, want, valid=valid) <= 1.0
    assert attn_ref.check_ratio(out, one, *attn_ref.SPLIT_CHECK,
                                valid=valid) <= 1.0
    assert (out[ln == 0] == 0).all() and (one[ln == 0] == 0).all()


# configs whose GQA group the oracle cases fold: (q heads, kv heads)
GROUPS = {"codeqwen-G1": (32, 32), "yi-G8": (32, 4), "mistral-large-G12": (96, 8)}


@pytest.mark.cuda
@pytest.mark.parametrize("heads", list(GROUPS.values()), ids=list(GROUPS))
@pytest.mark.parametrize("kv_dtype", ["fp16", "int8"])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("case", [
    (32, [192, 416, 0], [32, 17, 0]), (5, [203, 37, 0], [5, 3, 0]),
], ids=["main", "5-token"])
def test_span_tensor_core_body_holds_to_f64_oracle_at_group(
        cuda_device, heads, kv_dtype, window, case):
    """Kernel 2/2q with bf16 q at G 1 (32 folded rows: 6 of 8 warps idle),
    8 and 12 (256 and 384 rows: two and three row tiles), the plan's splits
    and one forced split each within the check of the f64 oracle."""
    (hq, hkv), (q_len, starts, lens) = heads, case
    q, kp, vp, bt, st, ln = _case(cuda_device, torch.bfloat16, b=3,
                                  q_len=q_len, starts=starts, lens=lens,
                                  hkv=hkv, g=hq // hkv)
    sc = {}
    if kv_dtype != "fp16":
        kp, vp, sc = _quantize_pool(kp, vp, kv_dtype)
    out = paged.paged_span_fwd(q, kp, vp, bt, st, ln, window=window, **sc)
    one = paged.paged_span_fwd(q, kp, vp, bt, st, ln, window=window, splits=1,
                               **sc)
    want = attn_ref.paged_span_ref(q, kp, vp, bt, st, ln, window=window, **sc)
    valid = attn_ref.span_valid(ln, q_len)
    assert torch.isfinite(out).all()
    assert attn_ref.check_ratio(out, want, valid=valid) <= 1.0
    assert attn_ref.check_ratio(one, want, valid=valid) <= 1.0
    assert attn_ref.check_ratio(out, one, *attn_ref.SPLIT_CHECK,
                                valid=valid) <= 1.0
    assert (out[ln == 0] == 0).all() and (one[ln == 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(32, 8), (32, 32)], ids=["G4", "G1"])
@pytest.mark.parametrize("kv_dtype", ["fp16", "int8"])
def test_span_body_holds_beam_prefill_row_to_f64_oracle(cuda_device, heads,
                                                        kv_dtype):
    """Beam search prefills its prompt as ONE span row: Q 512 at start 0
    (2048 folded rows at granite's G 4, 512 at G 1), bf16 q on the tensor
    cores, the plan's splits and one forced split, held to the float64
    oracle."""
    hq, hkv = heads
    q, kp, vp, bt, st, ln = _case(cuda_device, torch.bfloat16, b=1, q_len=512,
                                  starts=[0], lens=[512], hkv=hkv, g=hq // hkv)
    sc = {}
    if kv_dtype != "fp16":
        kp, vp, sc = _quantize_pool(kp, vp, kv_dtype)
    out = paged.paged_span_fwd(q, kp, vp, bt, st, ln, **sc)
    one = paged.paged_span_fwd(q, kp, vp, bt, st, ln, splits=1, **sc)
    want = attn_ref.paged_span_ref(q, kp, vp, bt, st, ln, **sc)
    valid = attn_ref.span_valid(ln, 512)
    assert torch.isfinite(out).all()
    assert attn_ref.check_ratio(out, want, valid=valid) <= 1.0
    assert attn_ref.check_ratio(one, want, valid=valid) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["einsum", "sort"])
@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_moe_block_on_the_card_matches_the_cpu_at_bf16(cuda_device, impl, cf):
    """The moe block on bf16 weights and activations: the same expert
    choices and dropped slots on the card as on the CPU (the router runs
    in float32), and outputs within bf16 rounding (the gate product
    accumulated and kept in float32 on both: cuBLAS's float32 output on
    the card, widened operands on the CPU)."""
    from repro_torch.models import moe

    cfg = reduced(get_config("deepseek-moe-16b"), dtype="bfloat16",
                  capacity_factor=cf, moe_impl=impl)
    m_cpu = build_model(cfg, device="cpu", seed=3).layers[0].moe
    m_gpu = moe.MoE({n: p.to(cuda_device) for n, p in m_cpu.named_parameters()})
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((4, 64, cfg.d_model))
                          + rng.standard_normal(cfg.d_model)).astype(
                              np.float32)).to(torch.bfloat16)
    xg = x.reshape(1, 256, -1)
    with torch.inference_mode():
        _, i_cpu, _ = moe.router(m_cpu, xg, cfg)
        _, i_gpu, _ = moe.router(m_gpu, xg.to(cuda_device), cfg)
        y_cpu, a_cpu = moe.moe_block(m_cpu, x, cfg)
        y_gpu, a_gpu = moe.moe_block(m_gpu, x.to(cuda_device), cfg)
    assert torch.equal(i_gpu.cpu(), i_cpu)
    c = moe.capacity(256, cfg)
    keep = moe.einsum_slots(i_cpu, cfg.num_experts, c)[1]
    assert not keep.all()  # capacity binds: the drops are compared too
    assert y_gpu.dtype == torch.bfloat16 and torch.isfinite(y_gpu).all()
    torch.testing.assert_close(y_gpu.float().cpu(), y_cpu.float(),
                               atol=TOL[torch.bfloat16], rtol=0)
    torch.testing.assert_close(a_gpu.cpu(), a_cpu, atol=0, rtol=1e-6)


@pytest.mark.cuda
def test_fork_cow_copy_on_int8_pool_keeps_codes_and_scales(cuda_device):
    """A copy-on-write block copy of an int8 pool moves the codes and the
    f32 scales bit for bit; a greedy n=3 fan over that pool (pallas: the
    quantized kernels) equals the unforked stream."""
    cfg = reduced(get_config("granite-8b"), kv_dtype="int8",
                  kernel_mode="pallas")
    model = build_model(cfg, device=cuda_device, seed=0)
    eng = UnifiedServeEngine(cfg, model, device=cuda_device, num_slots=4,
                             max_len=96, chunk_size=16)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    for name, leaf in eng._caches.items():
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen,
                                     device=cuda_device, dtype=torch.int8))
        else:
            leaf.copy_(torch.rand(leaf.shape, generator=gen,
                                  device=cuda_device))
    src = eng.pool.alloc(2)
    eng.pool.fork(src)
    for b in src:
        fresh, copied = eng.pool.cow(b)
        assert copied
        eng._cow_pairs.append((b, fresh))
    pairs = list(eng._cow_pairs)
    eng._flush_cow()
    assert set(eng._caches) == {"k", "v", "k_scale", "v_scale"}
    for name, leaf in eng._caches.items():
        for a, b in pairs:
            assert torch.equal(leaf[:, a], leaf[:, b]), name
    eng = UnifiedServeEngine(cfg, model, device=cuda_device, num_slots=4,
                             max_len=96, chunk_size=16)
    prompt = np.random.default_rng(2).integers(0, 512, (45,)).astype(np.int32)
    r0 = eng.submit(prompt, 6)
    want = eng.run()[r0.rid]
    rp = eng.submit(prompt, 6, n_samples=3)
    out = eng.run()
    for r in [rp] + rp.forks:
        np.testing.assert_array_equal(out[r.rid], want)
    assert eng.pool.stats["cow_copies"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("dtype,kv_dtype", [
    (torch.bfloat16, "fp16"), (torch.bfloat16, "int8"),
    (torch.bfloat16, "fp8"), (torch.float32, "fp16"),
], ids=["bf16", "bf16-int8", "bf16-fp8", "f32"])
def test_decode_kernel_holds_to_f64_oracle(cuda_device, d, window, dtype,
                                           kv_dtype):
    """Kernel 1/1q at the main path's slots (0, 17, 300, 543) within the
    stated check of the float64 oracle (bf16 (2^-8, 1e-3), f32 (1e-4,
    1e-4))."""
    q, kp, vp, bt, idx, _ = _case(cuda_device, dtype, b=4, q_len=1,
                                  starts=[0, 17, 300, 543], lens=[1] * 4, d=d)
    sc = {}
    if kv_dtype != "fp16":
        kp, vp, sc = _quantize_pool(kp, vp, kv_dtype)
    out = paged.paged_decode_fwd(q, kp, vp, bt, idx, window=window, **sc)
    want = attn_ref.paged_attention_ref(q, kp, vp, bt, idx, window=window, **sc)
    assert torch.isfinite(out).all()
    assert attn_ref.check_ratio(out, want) <= 1.0


# decode past the main path's slots: the GQA groups of the configs the port
# carries at their own head counts (recurrentgemma's G 16 at D 256 is the
# largest group the launcher takes), a 2560-token slot (the plan's 16
# splits; window 100 leaves most of them without a key), 64 slots (one
# split, no merge) and a slot at position 0 (one key).  (q heads, kv
# heads, D, slot positions, table width W)
DECODE_CASES = {
    "codeqwen-G1": (32, 32, 128, [0, 17, 300, 543], 34),
    "yi-G8": (32, 4, 128, [0, 17, 300, 543], 34),
    "mistral-large-G12": (96, 8, 128, [0, 17, 300, 543], 34),
    "recurrentgemma-G16-D256": (16, 1, 256, [0, 17, 300, 543], 34),
    "long-slot": (32, 8, 128, [2559], 160),
    "64-slots": (32, 8, 128, [(37 * i) % 544 for i in range(64)], 34),
    "position-0": (32, 8, 128, [0], 34),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DECODE_CASES.values()), ids=list(DECODE_CASES))
@pytest.mark.parametrize("kv_dtype", ["fp16", "int8"])
@pytest.mark.parametrize("window", [None, 100])
def test_decode_splits_hold_to_f64_oracle(cuda_device, case, kv_dtype, window):
    """Kernel 1/1q with bf16 q: the plan's key splits and one forced split
    each within the check of the f64 oracle, and within one bf16 ulp of
    each other (``ref.SPLIT_CHECK``)."""
    hq, hkv, d, starts, w = case
    q, kp, vp, bt, idx, _ = _case(cuda_device, torch.bfloat16, b=len(starts),
                                  q_len=1, starts=starts, lens=[1] * len(starts),
                                  hkv=hkv, g=hq // hkv, d=d, w=w,
                                  nb=max(512, len(starts) * w + 1))
    sc = {}
    if kv_dtype != "fp16":
        kp, vp, sc = _quantize_pool(kp, vp, kv_dtype)
    out = paged.paged_decode_fwd(q, kp, vp, bt, idx, window=window, **sc)
    one = paged.paged_decode_fwd(q, kp, vp, bt, idx, window=window, splits=1,
                                 **sc)
    want = attn_ref.paged_attention_ref(q, kp, vp, bt, idx, window=window, **sc)
    assert torch.isfinite(out).all()
    assert attn_ref.check_ratio(out, want) <= 1.0
    assert attn_ref.check_ratio(one, want) <= 1.0
    assert attn_ref.check_ratio(out, one, *attn_ref.SPLIT_CHECK) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("splits", [None, 1, 7, 16])
def test_decode_f32_splits_hold_to_f64_oracle(cuda_device, window, splits):
    """f32 q runs the same body and splits too: the long slot and a slot at
    0 within the f32 check (1e-4, 1e-4) at any split count."""
    q, kp, vp, bt, idx, _ = _case(cuda_device, torch.float32, b=2, q_len=1,
                                  starts=[2559, 0], lens=[1, 1], w=160)
    out = paged.paged_decode_fwd(q, kp, vp, bt, idx, window=window,
                                 splits=splits)
    want = attn_ref.paged_attention_ref(q, kp, vp, bt, idx, window=window)
    assert attn_ref.check_ratio(out, want) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["fp16", "int8", "fp8"])
def test_span_f32_body_holds_to_f64_oracle(cuda_device, kv_dtype):
    """f32 q keeps the CUDA-core body, within the f32 check (1e-4, 1e-4)."""
    q, kp, vp, bt, st, ln = _case(cuda_device, torch.float32, b=3, q_len=32,
                                  starts=[192, 421, 0], lens=[32, 17, 0])
    sc = {}
    if kv_dtype != "fp16":
        kp, vp, sc = _quantize_pool(kp, vp, kv_dtype)
    out = paged.paged_span_fwd(q, kp, vp, bt, st, ln, window=100, **sc)
    want = attn_ref.paged_span_ref(q, kp, vp, bt, st, ln, window=100, **sc)
    assert attn_ref.check_ratio(out, want,
                                valid=attn_ref.span_valid(ln, 32)) <= 1.0


def _quantize_pool(kp, vp, kv_dtype):
    """The case's pool as codes + scales, as the engine stores it."""
    kc, ks = quant.kv_quantize(kp, kv_dtype)
    vc, vs = quant.kv_quantize(vp, kv_dtype)
    return kc, vc, {"k_scales": ks, "v_scales": vs}


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 100])
def test_quantized_decode_kernel_matches_plain(cuda_device, kv_dtype, dtype,
                                               window):
    """Kernel 1q: fused dequant against the plain dequant-gather path on
    the same quantized pool (bf16: the plain path dequantizes to bf16)."""
    q, kp, vp, bt, idx, _ = _case(cuda_device, dtype, b=4, q_len=1,
                                  starts=[0, 17, 300, 543], lens=[1] * 4)
    kc, vc, sc = _quantize_pool(kp, vp, kv_dtype)
    ops.reset_counts()
    out = ops.paged_attention({"k": kc, "v": vc, "k_scale": sc["k_scales"],
                               "v_scale": sc["v_scales"]}, q, bt, idx,
                              window=window)
    ref = paged.paged_decode_plain(q, kc, vc, bt, idx, window=window, **sc)
    assert ops.paged_attention.quant_launches == 1
    assert ops.paged_attention.launches == 0
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 100])
def test_quantized_span_kernel_matches_plain(cuda_device, kv_dtype, dtype,
                                             window):
    q, kp, vp, bt, st, ln = _case(cuda_device, dtype, b=3, q_len=32,
                                  starts=[192, 421, 0], lens=[32, 17, 0])
    kc, vc, sc = _quantize_pool(kp, vp, kv_dtype)
    out = paged.paged_span_fwd(q, kc, vc, bt, st, ln, window=window, **sc)
    ref = paged.paged_span_plain(q, kc, vc, bt, st, ln, window=window, **sc)
    valid = (torch.arange(32, device=cuda_device)[None] < ln[:, None])
    err = ((out.float() - ref.float()).abs() * valid[..., None, None]).max()
    assert err.item() <= TOL[dtype]
    assert (out[2] == 0).all()
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="scales"):  # codes alone: refused
        paged.paged_span_fwd(q, kc, vc, bt, st, ln)


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
    out = flash.flash_attention_fwd(q, k, v)
    torch.testing.assert_close(out, flash.flash_attention_plain(q, k, v),
                               atol=TOL[torch.float32], rtol=0)
    assert attn_ref.check_ratio(out, attn_ref.flash_ref(q, k, v)) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # b, sq, skv, hq, hkv, d, causal, window, q_offset: chip_smoke.py's six
    # cases at granite-8b's heads, one query, the GQA groups 1, 8 and 12
    # of codeqwen / yi / mistral-large, head dims 32, 64 and 256, a
    # 2048-token prompt
    (1, 512, 512, 32, 8, 128, True, None, 0),
    (1, 256, 512, 32, 8, 128, True, None, 256),
    (1, 512, 512, 32, 8, 128, True, 100, 0),
    (1, 333, 333, 32, 8, 128, True, None, 0),
    (1, 77, 333, 32, 8, 128, True, None, 256),
    (1, 200, 333, 32, 8, 128, False, None, 0),
    (2, 1, 40, 32, 8, 128, True, None, 39),
    (1, 512, 512, 32, 32, 128, True, None, 0),
    (1, 512, 512, 32, 4, 128, True, None, 0),
    (1, 512, 512, 96, 8, 128, True, None, 0),
    (1, 512, 512, 32, 8, 32, True, None, 0),
    (1, 512, 512, 32, 8, 64, True, None, 0),
    (1, 512, 512, 32, 8, 256, True, None, 0),
    (1, 2048, 2048, 32, 8, 128, True, None, 0),
], ids=["prompt", "tail", "window", "ragged", "ragged-tail", "bidirectional",
        "one-query", "G1", "G8", "G12", "d32", "d64", "d256", "2048"])
def test_flash_kernel_holds_to_f64_oracle(cuda_device, dtype, case):
    """Kernel 3 within the stated check of the float64 oracle (bf16 (2^-8,
    1e-3), f32 (1e-4, 1e-4)) on every query; out in q's dtype."""
    b, sq, skv, hq, hkv, d, causal, window, q_offset = case
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda_device).to(dtype)
    q, k, v = mk(b, sq, hq, d), mk(b, skv, hkv, d), mk(b, skv, hkv, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = flash.flash_attention_fwd(q, k, v, **kw)
    assert out.shape == q.shape and out.dtype == dtype
    assert torch.isfinite(out).all()
    assert attn_ref.check_ratio(out, attn_ref.flash_ref(q, k, v, **kw)) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_holds_strided_views_to_f64_oracle(cuda_device, dtype):
    """q/k/v as head slices of one fused bf16 or f32 buffer, windowed."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(2, 300, 48, 128, generator=gen, device=cuda_device).to(dtype)
    q, k, v = x[:, :, :32], x[:, :, 32:40], x[:, :, 40:]
    out = flash.flash_attention_fwd(q, k, v, window=100)
    want = attn_ref.flash_ref(q, k, v, window=100)
    assert attn_ref.check_ratio(out, want) <= 1.0


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
@pytest.mark.parametrize("arch,kv_dtype", [("granite-8b", "fp16"),
                                           ("granite-8b", "int8"),
                                           ("mamba2-370m", "fp16")],
                         ids=["fp16", "int8", "mamba2"])
def test_engine_kernel_equals_plain_greedy(cuda_device, arch, kv_dtype):
    """kernel_mode pallas (CUDA kernels) and xla (plain path) serve the
    same greedy streams on reduced granite in float32, over a native and
    an int8 pool, and on reduced mamba2 (the SSD scan kernel)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, (n,)).astype(np.int32) for n in (7, 16, 21, 30)]
    streams = []
    for mode in ("pallas", "xla"):
        cfg = reduced(get_config(arch), kernel_mode=mode, kv_dtype=kv_dtype)
        eng = UnifiedServeEngine(cfg, build_model(cfg, device=cuda_device),
                                 device=cuda_device, num_slots=2, max_len=48,
                                 chunk_size=8)
        ops.reset_counts()
        ssd_ops.reset_counts()
        reqs = [eng.submit(p, 10) for p in prompts]
        out = eng.run()
        streams.append([out[r.rid] for r in reqs])
        if arch == "mamba2-370m":
            launched = [ssd_ops.ssd_scan.launches]
            assert (ssd_scan.ssd_chunked_plain.calls == 0) == (mode == "pallas")
        else:
            count = "launches" if kv_dtype == "fp16" else "quant_launches"
            launched = [getattr(w, count) for w in (ops.paged_attention,
                                                    ops.paged_span_attention)]
        assert all(n > 0 for n in launched) == (mode == "pallas"), launched
        assert sum(launched) == 0 or mode == "pallas"
    for a, b in zip(*streams):
        np.testing.assert_array_equal(a, b)


def _ssd_inputs(dev, dtype, b, s, h=32, p=64, n=128, g=1, *, seed=0,
                dt_max=None):
    """x/B/C normal in ``dtype``; dt and a_log drawn as the model's inits
    (dt in [1e-3, 0.1] log-uniform, A ~ U[1, 16]) or, with ``dt_max``,
    dt ~ U[0, dt_max] (large dt * |a|: exp overflows above the diagonal)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(dtype)
    u = torch.rand((b, s, h), generator=gen, device=dev)
    if dt_max is None:
        dt = torch.exp(u * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
    else:
        dt = u * dt_max
    a_log = torch.log(1 + 15 * torch.rand((h,), generator=gen, device=dev))
    return mk(b, s, h, p), dt, a_log, mk(b, s, g, n), mk(b, s, g, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # b, s, h, p, n, g, dt_max: full width (ragged, a long prompt, a wave
    # of 4), an overflow-prone dt, the JAX test's grouped cases
    (1, 200, 32, 64, 128, 1, None), (4, 300, 32, 64, 128, 1, None),
    (1, 512, 32, 64, 128, 1, None), (1, 300, 32, 64, 128, 1, 3.0),
    (1, 100, 2, 32, 16, 2, None), (2, 64, 8, 16, 8, 4, None),
], ids=["200", "4x300", "512", "overflow", "g2", "g4"])
def test_ssd_kernel_and_plain_hold_to_f64_oracle(cuda_device, dtype, shape):
    """Kernel and plain version each within the stated check of the
    float64 recurrence (``ref.check_ratio`` <= 1), finite, y in x's dtype."""
    b, s, h, p, n, g, dt_max = shape
    x, dt, a_log, bm, cm = _ssd_inputs(cuda_device, dtype, b, s, h, p, n, g,
                                       dt_max=dt_max)
    y, state = ssd_scan.ssd_scan_fwd(x, dt, a_log, bm, cm)
    py, pstate = ssd_scan.ssd_chunked_plain(x, dt, a_log, bm, cm, 256)
    ry, rstate = ssd_ref.ssd_sequential_ref(x, dt, a_log, bm, cm)
    assert y.dtype == dtype and state.dtype == torch.float32
    for got, want in ((y, ry), (state, rstate), (py, ry), (pstate, rstate)):
        assert torch.isfinite(got).all()
        assert ssd_ref.check_ratio(got, want) <= 1.0


@pytest.mark.cuda
def test_ssd_kernel_reads_strided_views_and_refuses_what_it_cannot_take(
        cuda_device):
    """x as a slice of a wider projection, B/C as group slices of one
    buffer: read in place.  float16 under kernel_mode pallas raises and
    runs no plain path."""
    x, dt, a_log, _, _ = _ssd_inputs(cuda_device, torch.float32, 2, 77)
    wide = torch.randn(2, 77, 2, 128, device=cuda_device)  # [.., B|C, N]
    bm, cm = wide[:, :, :1], wide[:, :, 1:]
    xs = torch.cat([x, x], dim=3)[..., :64]
    y, state = ssd_scan.ssd_scan_fwd(xs, dt, a_log, bm, cm)
    ry, rstate = ssd_ref.ssd_sequential_ref(xs, dt, a_log, bm, cm)
    assert ssd_ref.check_ratio(y, ry) <= 1 and ssd_ref.check_ratio(state, rstate) <= 1
    ssd_ops.reset_counts()
    with pytest.raises(NotImplementedError, match="no silent fallback"):
        ssd_ops.ssd_scan(x.half(), dt, a_log, bm.half(), cm.half(), chunk=256,
                         mode="pallas")
    assert ssd_ops.ssd_scan.launches == 0
    assert ssd_scan.ssd_chunked_plain.calls == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # b, s, h, p, n, g, dt_max: a 2560-token prompt (40 chunks), one token,
    # 17 tokens (one part chunk), 4 sequences at S 300 with ragged tails
    # and an overflow-prone dt
    (1, 2560, 32, 64, 128, 1, None), (1, 1, 32, 64, 128, 1, None),
    (1, 17, 32, 64, 128, 1, None), (4, 300, 32, 64, 128, 1, 3.0),
], ids=["2560", "S1", "S17", "4x300-overflow"])
def test_ssd_kernel_holds_to_f64_oracle_at_chunk_edges(cuda_device, dtype, shape):
    """The kernel within the stated check of the float64 recurrence
    (``ref.check_ratio`` <= 1) for y and the final state, finite."""
    b, s, h, p, n, g, dt_max = shape
    x, dt, a_log, bm, cm = _ssd_inputs(cuda_device, dtype, b, s, h, p, n, g,
                                       seed=s, dt_max=dt_max)
    y, state = ssd_scan.ssd_scan_fwd(x, dt, a_log, bm, cm)
    ry, rstate = ssd_ref.ssd_sequential_ref(x, dt, a_log, bm, cm)
    assert y.dtype == dtype and state.dtype == torch.float32
    for got, want in ((y, ry), (state, rstate)):
        assert torch.isfinite(got).all()
        assert ssd_ref.check_ratio(got, want) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    # b, s, h, p, n, g: the P tiles 32 and 16, N padded to the mma depth,
    # G 2 and 4 read by index
    (1, 130, 4, 32, 16, 2), (2, 70, 8, 16, 8, 4), (1, 100, 2, 48, 24, 1),
], ids=["p32-n16-g2", "p16-n8-g4", "p48-n24"])
def test_ssd_bf16_kernel_holds_to_f64_oracle_at_narrow_widths(cuda_device, shape):
    b, s, h, p, n, g = shape
    x, dt, a_log, bm, cm = _ssd_inputs(cuda_device, torch.bfloat16, b, s, h, p,
                                       n, g, seed=7)
    y, state = ssd_scan.ssd_scan_fwd(x, dt, a_log, bm, cm)
    ry, rstate = ssd_ref.ssd_sequential_ref(x, dt, a_log, bm, cm)
    assert ssd_ref.check_ratio(y, ry) <= 1.0
    assert ssd_ref.check_ratio(state, rstate) <= 1.0


@pytest.mark.cuda
def test_ssd_bf16_kernel_reads_strided_views(cuda_device):
    """bf16: x as a slice of a wider projection, B/C as group slices of one
    buffer, read in place; y and the state within the check."""
    x, dt, a_log, _, _ = _ssd_inputs(cuda_device, torch.bfloat16, 2, 77)
    wide = torch.randn(2, 77, 2, 128, device=cuda_device).bfloat16()
    bm, cm = wide[:, :, :1], wide[:, :, 1:]
    xs = torch.cat([x, x], dim=3)[..., :64]
    y, state = ssd_scan.ssd_scan_fwd(xs, dt, a_log, bm, cm)
    ry, rstate = ssd_ref.ssd_sequential_ref(xs, dt, a_log, bm, cm)
    assert ssd_ref.check_ratio(y, ry) <= 1 and ssd_ref.check_ratio(state, rstate) <= 1


# ----------------------------------------------------------------------
# the speculative lane's verify rows, and mamba2 on the legacy and
# fixed-batch engines
# ----------------------------------------------------------------------
# four slot rows of K + 1 <= 5 valid queries (one idle slot) beside two
# chunk rows, at Q = 32: the spec dispatch's span batch
VERIFY_ROWS = ([543, 17, 0, 300, 192, 421], [5, 3, 0, 2, 32, 17])


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["fp16", "int8", "fp8"])
def test_span_verify_rows_hold_to_f64_oracle(cuda_device, kv_dtype):
    """Kernel 2/2q with bf16 q at the verify rows' shape: rows of 2-5
    valid queries of 32 and an idle row, the plan's splits and one forced
    split within the check of the f64 oracle; the idle row is zeros."""
    starts, lens = VERIFY_ROWS
    q, kp, vp, bt, st, ln = _case(cuda_device, torch.bfloat16, b=len(starts),
                                  q_len=32, starts=starts, lens=lens)
    sc = {}
    if kv_dtype != "fp16":
        kp, vp, sc = _quantize_pool(kp, vp, kv_dtype)
    out = paged.paged_span_fwd(q, kp, vp, bt, st, ln, **sc)
    one = paged.paged_span_fwd(q, kp, vp, bt, st, ln, splits=1, **sc)
    want = attn_ref.paged_span_ref(q, kp, vp, bt, st, ln, **sc)
    valid = attn_ref.span_valid(ln, 32)
    assert torch.isfinite(out).all()
    assert attn_ref.check_ratio(out, want, valid=valid) <= 1.0
    assert attn_ref.check_ratio(one, want, valid=valid) <= 1.0
    assert (out[ln == 0] == 0).all() and (one[ln == 0] == 0).all()


def _greedy_oracle(model, vocab, prompt, gen, device):
    """Greedy full recompute through forward()."""
    with torch.inference_mode():
        ctx = torch.tensor(prompt, device=device)[None]
        for _ in range(gen):
            nxt = model(ctx)[0, -1, :vocab].argmax()
            ctx = torch.cat([ctx, nxt.view(1, 1).to(ctx.dtype)], 1)
    return ctx[0, len(prompt):].cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("spec,kv_dtype", [("ngram", "fp16"),
                                           ("ngram", "int8"),
                                           ("draft", "fp16")],
                         ids=["ngram", "ngram-int8", "draft"])
def test_spec_engine_kernel_equals_plain_greedy(cuda_device, spec, kv_dtype):
    """The spec lane on reduced granite in float32: kernel_mode pallas
    (every verify and chunk row on kernel 2/2q, the decode kernel never
    launched) and xla serve the same greedy streams, equal to the
    non-spec engine and (native pool) to the forward() oracle."""
    from repro_torch.serve.spec import DraftModelProposer, NGramProposer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(3)
    motif = rng.integers(0, 512, (6,)).astype(np.int32)
    prompts = [np.tile(motif, 4), rng.integers(0, 512, (7,)).astype(np.int32),
               np.tile(motif, 3)[:17], rng.integers(0, 512, (30,)).astype(np.int32)]
    streams = []
    for mode in ("pallas", "xla"):
        cfg = reduced(get_config("granite-8b"), kernel_mode=mode,
                      kv_dtype=kv_dtype)
        model = build_model(cfg, device=cuda_device)
        prop = (NGramProposer() if spec == "ngram" else DraftModelProposer(
            reduced(get_config("granite-8b"), num_layers=1), num_slots=2,
            max_len=64, device=cuda_device))
        eng = UnifiedServeEngine(cfg, model, device=cuda_device, num_slots=2,
                                 max_len=64, chunk_size=8, spec=prop, spec_k=4)
        ops.reset_counts()
        reqs = [eng.submit(p, 10) for p in prompts]
        out = eng.run()
        streams.append([out[r.rid] for r in reqs])
        count = "launches" if kv_dtype == "fp16" else "quant_launches"
        span = getattr(ops.paged_span_attention, count)
        decode = (ops.paged_attention.launches
                  + ops.paged_attention.quant_launches)
        assert decode == 0, decode
        assert (span > 0) == (mode == "pallas"), span
        assert eng.stats["spec_dispatches"] > 0
        ref = UnifiedServeEngine(cfg, model, device=cuda_device, num_slots=2,
                                 max_len=64, chunk_size=8)
        rr = [ref.submit(p, 10) for p in prompts]
        ref_out = ref.run()
        for r, a in zip(rr, streams[-1]):
            np.testing.assert_array_equal(a, ref_out[r.rid])
        if kv_dtype == "fp16":
            for p, a in zip(prompts, streams[-1]):
                np.testing.assert_array_equal(
                    a, _greedy_oracle(model, cfg.vocab_size, p, 10, cuda_device))
    for a, b in zip(*streams):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_mamba2_legacy_and_fixed_batch_kernel_equals_plain_greedy(cuda_device):
    """Reduced mamba2 in float32 on the grouped-prefill engine (three
    same-length prompts prefill as one B 3 launch of kernel 4) and the
    fixed-batch engine: pallas and xla streams identical, equal to the
    forward() oracle."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, (n,)).astype(np.int32)
               for n in (16, 16, 16, 7, 30)]
    streams = []
    for mode in ("pallas", "xla"):
        cfg = reduced(get_config("mamba2-370m"), kernel_mode=mode)
        model = build_model(cfg, device=cuda_device)
        ssd_ops.reset_counts()
        eng = ContinuousServeEngine(cfg, model, device=cuda_device,
                                    num_slots=3, max_len=48,
                                    max_prefills_per_iter=3)
        reqs = [eng.submit(p, 10) for p in prompts]
        out = eng.run()
        static = ServeEngine(cfg, model, device=cuda_device, max_len=48)
        batch = static.generate(np.stack(prompts[:3]), num_tokens=10)
        streams.append([out[r.rid] for r in reqs] + list(batch))
        launched = ssd_ops.ssd_scan.launches
        plain = ssd_scan.ssd_chunked_plain.calls
        assert (launched > 0 and plain == 0) if mode == "pallas" \
            else (launched == 0 and plain > 0), (launched, plain)
        assert eng.stats["host_syncs"] - eng.stats["decode_syncs"] < len(prompts)
    for a, b in zip(*streams):
        np.testing.assert_array_equal(a, b)
    for p, a in zip(prompts, streams[0]):
        np.testing.assert_array_equal(
            a, _greedy_oracle(model, cfg.vocab_size, p, 10, cuda_device))


# ----------------------------------------------------------------------
# the hybrid (recurrentgemma) and vlm (internvl2) families
# ----------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # sq, hq, hkv, d, window: recurrentgemma's prefill past its window,
    # internvl2's 1,024 patches + 512 text tokens
    (2304, 16, 1, 256, 2048), (2560, 16, 1, 256, 2048), (1536, 16, 8, 128, None),
], ids=["rg-2304", "rg-2560", "internvl2-1536"])
def test_flash_holds_family_prefill_to_f64_oracle(cuda_device, case):
    sq, hq, hkv, d, window = case
    gen = torch.Generator(device=cuda_device).manual_seed(28)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    q, k, v = mk(1, sq, hq, d), mk(1, sq, hkv, d), mk(1, sq, hkv, d)
    out = flash.flash_attention_fwd(q, k, v, window=window)
    plain = flash.flash_attention_plain(q, k, v, window=window)
    assert (out.float() - plain.float()).abs().max() <= TOL[torch.bfloat16]
    want = attn_ref.flash_ref(q, k, v, window=window)
    assert attn_ref.check_ratio(out, want) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["fp16", "int8"])
@pytest.mark.parametrize("case", [
    # hq, hkv, d, starts, window: recurrentgemma's decode past its window,
    # internvl2's slots after 1,024 patches
    (16, 1, 256, [2047, 2048, 2300, 4000], 2048),
    (16, 8, 128, [0, 17, 1300, 1543], None),
], ids=["rg-G16-D256", "internvl2-G2-D128"])
def test_decode_holds_family_slots_to_f64_oracle(cuda_device, case, kv_dtype):
    """The plan's key splits and one forced split, each within the check
    of the f64 oracle and within one bf16 ulp of each other."""
    hq, hkv, d, starts, window = case
    w = max(starts) // 16 + 2
    q, kp, vp, bt, idx, _ = _case(cuda_device, torch.bfloat16, b=4, q_len=1,
                                  starts=starts, lens=[1] * 4, hkv=hkv,
                                  g=hq // hkv, d=d, w=w, nb=4 * w + 8)
    sc = {}
    if kv_dtype != "fp16":
        kp, vp, sc = _quantize_pool(kp, vp, kv_dtype)
    out = paged.paged_decode_fwd(q, kp, vp, bt, idx, window=window, **sc)
    one = paged.paged_decode_fwd(q, kp, vp, bt, idx, window=window, splits=1,
                                 **sc)
    want = attn_ref.paged_attention_ref(q, kp, vp, bt, idx, window=window, **sc)
    assert attn_ref.check_ratio(out, want) <= 1.0
    assert attn_ref.check_ratio(one, want) <= 1.0
    assert attn_ref.check_ratio(out, one, *attn_ref.SPLIT_CHECK) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["unified", "legacy", "static"])
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "internvl2-2b"])
def test_family_engines_kernel_equals_plain_greedy(cuda_device, arch, engine):
    """Reduced recurrentgemma (5 layers, window 16, prompts past it) and
    internvl2 (8 patches a request) in float32: kernel_mode pallas (flash
    prefill, decode kernel on the paged engines) and xla (plain path)
    serve the same greedy streams."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, (n,)).astype(np.int32) for n in (7, 20, 33)]
    kw = {"num_layers": 5} if arch == "recurrentgemma-9b" else {}
    base = reduced(get_config(arch), **kw)
    extras = [{"patch_embeds": rng.standard_normal(
        (base.num_patches, base.vision_dim)).astype(np.float32)}
        if base.family == "vlm" else {} for _ in prompts]
    streams = []
    for mode in ("pallas", "xla"):
        cfg = base.replace(kernel_mode=mode)
        model = build_model(cfg, device=cuda_device)
        ops.reset_counts()
        if engine == "static":
            eng = ServeEngine(cfg, model, device=cuda_device, max_len=64)
            out = [eng.generate(p[None], num_tokens=10, extras={
                k: v[None] for k, v in e.items()})[0]
                for p, e in zip(prompts, extras)]
        else:
            cls = UnifiedServeEngine if engine == "unified" \
                else ContinuousServeEngine
            eng = cls(cfg, model, device=cuda_device, num_slots=2, max_len=64)
            reqs = [eng.submit(p, 10, extras=e) for p, e in zip(prompts, extras)]
            res = eng.run()
            out = [res[r.rid] for r in reqs]
            assert (ops.paged_attention.launches > 0) == (mode == "pallas")
        assert (ops.flash_attention.launches > 0) == (mode == "pallas")
        streams.append(out)
    for a, b in zip(*streams):
        np.testing.assert_array_equal(a, b)
