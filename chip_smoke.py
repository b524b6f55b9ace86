#!/usr/bin/env python3
"""Chip smoke test of the torch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, torch version, compute
   capability (must be 9.x, Hopper);
2. build the CUDA kernels from ``csrc/`` (paged attention, flash
   attention), one nvcc per source, started together;
3. each kernel against its plain torch version on the card at the main
   paths' shapes (granite-8b: 32 q / 8 kv heads, D = 128; block 16 for
   the paged kernels) in bf16 and f32 — sliding-window, NULL-tail and
   ``row_len == 0`` cases for the paged kernels; causal, a prefix-hit
   tail at ``q_offset`` 256, a sliding window and ragged lengths (causal
   and bidirectional) for the flash kernel; then its time (CUDA events,
   L2 flushed before each launch) beside the plain version's, one
   PyTorch library call computing the same function
   (``F.scaled_dot_product_attention`` — a yardstick only, the port never
   calls it) and the least time the card could take (bytes over
   3.35 TB/s vs flops over the dtype's peak);
4. full-width granite-8b (36 layers, d_model 4096, bf16, random weights
   from a seed), one model object for both waves:
   a. through ``UnifiedServeEngine(device="cuda")``: 8 requests of
      200-512 prompt tokens in pairs sharing a block-aligned prefix, 32
      new tokens each, 4 slots, prefix cache on.  Every kernel launch
      count is zeroed just before and read just after; both paged kernels
      must have launched and no plain path may have run.  Each request's
      first token must be the argmax of the model's ``forward()`` on its
      prompt up to bf16 noise, with finite logits.  One more wave under
      ``torch.profiler`` gives the device-busy share and the device time
      by kernel family;
   b. the same stream through the grouped-prefill
      ``ContinuousServeEngine`` with the tracer on (segments flushed
      mid-run, merged into one ``.prv`` in a temporary directory and
      parsed back): the flash and paged-decode kernels must have launched
      and no plain path may have run; first tokens as in (a); tok/s, the
      device idle share (a profiled wave) and TTFT/TPOT p50/p95 from the
      merged trace;
5. reduced granite (float32, 2 layers, full attention and a sliding
   window) through ``ContinuousServeEngine``, ``UnifiedServeEngine`` and
   ``ServeEngine`` with ``kernel_mode="pallas"`` (the CUDA kernels) and
   ``"xla"`` (the plain path): all six greedy streams must be identical,
   and equal to a greedy full-recompute oracle from ``forward()``;
6. a ``{"kernels": [...]}`` line, the card line again, and last
   ``{"ok": true, "device": {...}}``.

It needs only the repository: weights and inputs are made from seeds.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per dtype
TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # max |kernel - plain| (see PERF.md)
# full width, bf16: logit gap of the engine's first token below forward()'s
# argmax (logits ~N(0, 1); bf16 keeps ~3 digits, two attention paths)
FIRST_TOKEN_TOL = 0.1
CSRC = "src/repro_torch/kernels/attention/csrc/"
SOURCES = {"paged_decode": CSRC + "paged_attention.cu",
           "paged_span": CSRC + "paged_attention.cu",
           "flash_attention": CSRC + "flash_attention.cu"}
REPLACES = {"paged_decode": "src/repro/kernels/attention/paged.py:102",
            "paged_span": "src/repro/kernels/attention/paged.py:225",
            "flash_attention": "src/repro/kernels/attention/flash.py:100"}


def require(cond, msg):
    if not cond:
        raise SystemExit(f"[smoke] FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------
def _tables(rng, torch, b, w, bs, nb, last):
    """Distinct random live blocks for positions <= last[b], NULL tails."""
    bt = torch.zeros((b, w), dtype=torch.int32)
    ids = torch.from_numpy(rng.permutation(nb - 1)[:b * w] + 1).reshape(b, w)
    for i in range(b):
        n = int(last[i]) // bs + 1
        bt[i, :n] = ids[i, :n].to(torch.int32)
    return bt


def _case(torch, rng, dtype, *, b, q_len, hkv, g, d, bs, w, nb, starts, lens):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
    kp = mk(nb, bs, hkv, d)
    vp = mk(nb, bs, hkv, d)
    q = mk(b, q_len, hkv * g, d)
    st = torch.tensor(starts, dtype=torch.int32)
    ln = torch.tensor(lens, dtype=torch.int32)
    last = st + torch.clamp(ln, min=1) - 1
    bt = _tables(rng, torch, b, w, bs, nb, last)
    return q, kp, vp, bt.to(dev), st.to(dev), ln.to(dev)


def _attended(bt, starts, lens, bs, window):
    """Per row: (#blocks the kernel must read, [attended keys per query])."""
    out = []
    for row, s, n in zip(bt.tolist(), starts, lens):
        if n == 0:
            out.append((0, []))
            continue
        last = s + n - 1
        blocks = sum(1 for w, blk in enumerate(row) if blk and w * bs <= last
                     and (window is None or w * bs + bs - 1 > s - window))
        keys = [min(p + 1, p + 1 if window is None else window)
                for p in range(s, s + n)]
        out.append((blocks, keys))
    return out


def bound_ms(dtype_name, q, kp, bt, starts, lens, window, *, g):
    """Least time for the work these inputs need: every attended K/V block
    read once per kv head, q read and out written once, tables read once,
    against 4*D flops per (folded query row, attended key)."""
    bs, hkv, d = kp.shape[1], kp.shape[2], kp.shape[3]
    item = q.element_size()
    att = _attended(bt.cpu(), starts, lens, bs, window)
    kv_bytes = sum(blocks for blocks, _ in att) * 2 * bs * hkv * d * item
    io_bytes = 2 * q.numel() * item + bt.numel() * 4 + 2 * len(starts) * 4
    flops = sum(sum(keys) for _, keys in att) * hkv * g * 4 * d
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, flush, iters=20):
    """Device time of ``fn`` per call: CUDA events around each launch, L2
    flushed before it, and the GPU held busy (``_sleep``) while the host
    enqueues, so host-side checks are not inside the interval."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(2_000_000)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in evs) / iters


def sdpa_yardstick(torch, q, kp, vp, bt, starts, q_len, window):
    """``F.scaled_dot_product_attention`` over the gathered [W*bs] view,
    with the same causal/window mask (gather done outside the timing)."""
    import torch.nn.functional as F

    b, w = bt.shape
    bs, hkv, d = kp.shape[1], kp.shape[2], kp.shape[3]
    hq = q.shape[2]
    kg = kp[bt.long()].reshape(b, w * bs, hkv, d).repeat_interleave(hq // hkv, 2)
    vg = vp[bt.long()].reshape(b, w * bs, hkv, d).repeat_interleave(hq // hkv, 2)
    kv_pos = torch.arange(w * bs, device=q.device)
    qp = torch.tensor(starts, device=q.device)[:, None] + torch.arange(
        q_len, device=q.device)[None]
    mask = kv_pos[None, None] <= qp[:, :, None]
    if window is not None:
        mask &= kv_pos[None, None] > qp[:, :, None] - window
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kg, vg))
    m = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m)


def kernel_phase(torch, np):
    from repro_torch.kernels.attention import paged

    rng = np.random.default_rng(0)
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    shape = dict(hkv=8, g=4, d=128, bs=16, w=34, nb=4096)  # main path
    results = {}
    for dt_name in ("bfloat16", "float32"):
        dt = getattr(torch, dt_name)
        for window in (None, 100):
            # decode: 4 slots at positions 200..543 (NULL table tails)
            dec_starts = [int(x) for x in rng.integers(200, 544, 4)]
            q, kp, vp, bt, st, _ = _case(torch, rng, dt, b=4, q_len=1,
                                         starts=dec_starts, lens=[1] * 4,
                                         **shape)
            out = paged.paged_decode_fwd(q, kp, vp, bt, st, window=window)
            ref = paged.paged_decode_plain(q, kp, vp, bt, st, window=window)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            require(torch.isfinite(out).all().item(), "paged_decode non-finite")
            print(f"[smoke] paged_decode {dt_name} window={window}: "
                  f"max|kernel-plain| {err:.3e} (tol {TOL[dt_name]})")
            require(err <= TOL[dt_name], f"paged_decode {dt_name} err {err}")
            if dt_name == "bfloat16" and window is None:
                results["paged_decode"] = dict(
                    max_abs_err=err,
                    ms=time_ms(torch, lambda: paged.paged_decode_fwd(
                        q, kp, vp, bt, st), flush),
                    plain_ms=time_ms(torch, lambda: paged.paged_decode_plain(
                        q, kp, vp, bt, st), flush),
                    library_ms=time_ms(torch, sdpa_yardstick(
                        torch, q, kp, vp, bt, dec_starts, 1, None), flush))
                results["paged_decode"]["bound_ms"], \
                    results["paged_decode"]["bound_by"] = bound_ms(
                        dt_name, q, kp, bt, dec_starts, [1] * 4, None, g=4)
            # span: two 32-token chunk rows (one short tail chunk) + a
            # row_len == 0 row, as the unified step's chunk sub-batch
            starts, lens = [192, 416, 0], [32, 17, 0]
            q, kp, vp, bt, st, ln = _case(torch, rng, dt, b=3, q_len=32,
                                          starts=starts, lens=lens, **shape)
            out = paged.paged_span_fwd(q, kp, vp, bt, st, ln, window=window)
            ref = paged.paged_span_plain(q, kp, vp, bt, st, ln, window=window)
            torch.cuda.synchronize()
            valid = (torch.arange(32, device="cuda")[None] < ln[:, None])
            err = ((out.float() - ref.float()).abs()
                   * valid[..., None, None]).max().item()
            require(torch.isfinite(out).all().item(), "paged_span non-finite")
            require((out[2] == 0).all().item(), "row_len == 0 row not zeros")
            print(f"[smoke] paged_span {dt_name} window={window}: "
                  f"max|kernel-plain| {err:.3e} (tol {TOL[dt_name]}), "
                  f"row_len=0 row all zeros")
            require(err <= TOL[dt_name], f"paged_span {dt_name} err {err}")
            if dt_name == "bfloat16" and window is None:
                # time the main-path chunk batch: the two live rows
                q2, bt2, st2, ln2 = q[:2].contiguous(), bt[:2].contiguous(), \
                    st[:2].contiguous(), ln[:2].contiguous()
                results["paged_span"] = dict(
                    max_abs_err=err,
                    ms=time_ms(torch, lambda: paged.paged_span_fwd(
                        q2, kp, vp, bt2, st2, ln2), flush),
                    plain_ms=time_ms(torch, lambda: paged.paged_span_plain(
                        q2, kp, vp, bt2, st2, ln2), flush),
                    library_ms=time_ms(torch, sdpa_yardstick(
                        torch, q2, kp, vp, bt2, starts[:2], 32, None), flush))
                results["paged_span"]["bound_ms"], \
                    results["paged_span"]["bound_by"] = bound_ms(
                        dt_name, q2, kp, bt2, starts[:2], lens[:2], None, g=4)
    for name, r in results.items():
        print(f"[smoke] {name} bf16 main shapes: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    del flush_buf
    return results


def flash_bound_ms(dtype_name, q, k, *, causal, window, q_offset):
    """Least time for a dense attention call: q, k, v read and out written
    once, against 4*D flops per (q head, query, attended key)."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    item = q.element_size()
    pairs = 0
    for pos in range(q_offset, q_offset + sq):
        hi = min(skv, pos + 1) if causal else skv
        lo = max(0, pos - window + 1) if window else 0
        pairs += max(hi - lo, 0)
    io_bytes = (2 * q.numel() + 2 * k.numel()) * item
    flops = b * hq * pairs * 4 * d
    t_bytes = io_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_sdpa_yardstick(torch, q, k, v, *, q_offset):
    """``F.scaled_dot_product_attention`` on head-major copies (made outside
    the timing) with the causal mask at ``q_offset``."""
    import torch.nn.functional as F

    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.repeat_interleave(g, 2).transpose(1, 2).contiguous()
              for x in (k, v))
    if q_offset == 0 and q.shape[1] == k.shape[1]:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)
    mask = torch.arange(k.shape[1], device=q.device)[None] <= qpos[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def flash_phase(torch, np):
    """The flash kernel against its plain version (bf16 and f32) at
    granite-8b's head shapes, then its time at the main-path prefill
    shapes: one 512-token prompt, and a 256-token tail at offset 256."""
    from repro_torch.kernels.attention import flash

    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    gen = torch.Generator(device="cuda").manual_seed(3)
    hq, hkv, d = 32, 8, 128
    cases = [  # name, sq, skv, causal, window, q_offset
        ("causal", 512, 512, True, None, 0),
        ("prefix-hit tail", 256, 512, True, None, 256),
        ("window", 512, 512, True, 100, 0),
        ("ragged causal", 333, 333, True, None, 0),
        ("ragged tail", 77, 333, True, None, 256),
        ("ragged bidirectional", 200, 333, False, None, 0),
    ]
    results = {}
    for dt_name in ("bfloat16", "float32"):
        dt = getattr(torch, dt_name)
        for name, sq, skv, causal, window, qoff in cases:
            mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
            q, k, v = mk(1, sq, hq, d), mk(1, skv, hkv, d), mk(1, skv, hkv, d)
            kw = dict(causal=causal, window=window, q_offset=qoff)
            out = flash.flash_attention_fwd(q, k, v, **kw)
            ref = flash.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            require(torch.isfinite(out).all().item(), f"flash {name} non-finite")
            print(f"[smoke] flash_attention {dt_name} {name} (Sq {sq}, Skv "
                  f"{skv}, offset {qoff}): max|kernel-plain| {err:.3e} "
                  f"(tol {TOL[dt_name]})")
            require(err <= TOL[dt_name], f"flash {dt_name} {name} err {err}")
            if dt_name != "bfloat16" or name not in ("causal", "prefix-hit tail"):
                continue
            r = dict(max_abs_err=err,
                     ms=time_ms(torch, lambda: flash.flash_attention_fwd(
                         q, k, v, **kw), flush),
                     plain_ms=time_ms(torch, lambda: flash.flash_attention_plain(
                         q, k, v, **kw), flush),
                     library_ms=time_ms(torch, flash_sdpa_yardstick(
                         torch, q, k, v, q_offset=qoff), flush))
            r["bound_ms"], r["bound_by"] = flash_bound_ms(
                dt_name, q, k, causal=causal, window=window, q_offset=qoff)
            print(f"[smoke] flash_attention bf16 {name} (Sq {sq} at offset "
                  f"{qoff}): kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
            results.setdefault("flash_attention", r)  # the 512-token prompt
    del flush_buf
    return results


# ----------------------------------------------------------------------
# phases 4-5: the serve engines
# ----------------------------------------------------------------------
def shared_prefix_stream(rng, np, vocab, bs):
    """8 prompts of 200-512 tokens: four heads, then four prompts each
    sharing a block-aligned prefix with one head."""
    lens = [int(x) for x in rng.integers(200, 513, 8)]
    heads = [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens[:4]]
    prompts = list(heads)
    for i, n in enumerate(lens[4:]):
        shared = min(len(heads[i]), n) // 2 // bs * bs  # block-aligned prefix
        tail = rng.integers(0, vocab, (n - shared,)).astype(np.int32)
        prompts.append(np.concatenate([heads[i][:shared], tail]))
    return lens, prompts


def check_first_tokens(torch, model, cfg, prompts, firsts, what):
    """Each request's first token must be the argmax of the plain
    full-sequence ``forward()`` on its prompt up to bf16 noise."""
    worst = 0.0
    with torch.inference_mode():
        for p, first in zip(prompts, firsts):
            logits = model(torch.tensor(p, device="cuda")[None])[0, -1, :cfg.vocab_size]
            require(torch.isfinite(logits).all().item(), "non-finite logits")
            worst = max(worst, (logits.max() - logits[int(first)]).item())
    print(f"[smoke] {what} vs forward(): logits finite; first tokens within "
          f"{worst:.4f} of the forward argmax logit (tol {FIRST_TOKEN_TOL})")
    require(worst <= FIRST_TOKEN_TOL, f"{what}: first token {worst} below the argmax")


def served(out, reqs, gen, vocab):
    for r in reqs:
        toks = out.get(r.rid)
        require(toks is not None and len(toks) == gen,
                f"request {r.rid} returned {None if toks is None else len(toks)}")
        require(((toks >= 0) & (toks < vocab)).all(), "token out of vocab")


def full_width_phase(torch, np):
    """Phase 4: one full-width granite-8b, served by the unified engine
    (a) and by the grouped-prefill engine with the tracer on (b)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = get_config("granite-8b")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"[smoke] granite-8b full width: {model.param_count() / 1e9:.3f}B "
          f"params {cfg.dtype}, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, init {time.perf_counter() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    launches = unified_wave(torch, np, cfg, model)
    launches.update(legacy_wave(torch, np, cfg, model))
    del model
    torch.cuda.empty_cache()
    return launches


def unified_wave(torch, np, cfg, model):
    from repro_torch.kernels.attention import flash, ops, paged
    from repro_torch.serve.step import UnifiedServeEngine

    gen, bs = 32, 16
    eng = UnifiedServeEngine(cfg, model, device="cuda", num_slots=4,
                             max_len=512 + gen, block_size=bs)
    warm = eng.submit(np.arange(40, dtype=np.int32), 2)  # cuBLAS/lib warm-up
    eng.run()
    require(len(warm.tokens) == 2, "warm-up request did not finish")
    lens, prompts = shared_prefix_stream(np.random.default_rng(1), np,
                                         cfg.vocab_size, bs)
    stats0 = dict(eng.stats)
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, gen) for p in prompts]
    out = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"paged_decode": ops.paged_attention.launches,
                "paged_span": ops.paged_span_attention.launches}
    plain = (paged.paged_decode_plain.calls + paged.paged_span_plain.calls
             + flash.flash_attention_plain.calls)
    served(out, reqs, gen, cfg.vocab_size)
    st = eng.stats
    tokens = st["tokens_decoded"] - stats0["tokens_decoded"]
    print(f"[smoke] unified: served {len(reqs)} requests (prompts {lens}), "
          f"{tokens} tokens in {seconds:.2f}s = {tokens / seconds:.1f} tok/s; "
          f"peak {st['peak_blocks']} blocks, "
          f"{st['prefix_hit_tokens'] - stats0['prefix_hit_tokens']} "
          f"prefix-hit tokens, {st['preemptions'] - stats0['preemptions']} "
          f"preemptions")
    print(f"[smoke] unified main-path kernel launches: {launches}; plain-path "
          f"calls {plain}; engine dispatch counts {st['kernel_dispatch']}")
    require(all(n > 0 for n in launches.values()), f"kernel idle: {launches}")
    require(plain == 0, f"plain path ran {plain} times on the main path")
    require(st["prefix_hit_tokens"] > stats0["prefix_hit_tokens"],
            "no prefix hits on the shared-prefix pairs")
    check_first_tokens(torch, model, cfg, prompts,
                       [out[r.rid][0] for r in reqs], "unified, full width")
    profile_window(torch, eng, [p[:256] for p in prompts[:4]], gen, "unified")
    del eng
    torch.cuda.empty_cache()
    return launches


def legacy_wave(torch, np, cfg, model):
    """The grouped-prefill engine on the same stream, traced: segments
    flushed mid-run, merged into one ``.prv`` and parsed back."""
    from repro_torch import core as xtrace
    from repro_torch.kernels.attention import flash, ops, paged
    from repro_torch.serve.engine import ContinuousServeEngine

    gen, bs = 32, 16
    lens, prompts = shared_prefix_stream(np.random.default_rng(1), np,
                                         cfg.vocab_size, bs)
    # untraced wave under the profiler first (also the warm-up)
    eng = ContinuousServeEngine(cfg, model, device="cuda", num_slots=4,
                                max_len=512 + gen, block_size=bs)
    idle = profile_window(torch, eng, [p[:256] for p in prompts[:4]], gen,
                          "legacy")
    del eng
    with tempfile.TemporaryDirectory() as tmp:
        base = pathlib.Path(tmp) / "serve"
        tracer = xtrace.Tracer("chip-smoke-legacy").init()
        eng = ContinuousServeEngine(cfg, model, device="cuda", num_slots=4,
                                    max_len=512 + gen, block_size=bs,
                                    tracer=tracer, flush_every=16,
                                    flush_base=base)
        ops.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, gen) for p in prompts]
        out = eng.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"flash_attention": ops.flash_attention.launches,
                    "paged_decode": ops.paged_attention.launches,
                    "paged_span": ops.paged_span_attention.launches}
        plain = (paged.paged_decode_plain.calls + paged.paged_span_plain.calls
                 + flash.flash_attention_plain.calls)
        segments = list(tracer.segments)
        paths = xtrace.write_prv(tracer.finish(), base, segments=segments)
        trace = xtrace.parse_prv(paths["prv"])
        lat = xtrace.serve_latency_summary(trace)
        prv_bytes = paths["prv"].stat().st_size
    served(out, reqs, gen, cfg.vocab_size)
    st = eng.stats
    tokens = st["tokens_decoded"]
    print(f"[smoke] legacy: served {len(reqs)} requests, {tokens} tokens in "
          f"{seconds:.2f}s = {tokens / seconds:.1f} tok/s; {st['prefills']} "
          f"prefills ({st['prefill_tokens']} tokens, "
          f"{st['prefill_seconds']:.2f}s), {st['prefix_hit_tokens']} "
          f"prefix-hit tokens, {st['preemptions']} preemptions, "
          f"{st['decode_dispatches']} decode bursts, {st['host_syncs']} host "
          f"syncs")
    print(f"[smoke] legacy main-path kernel launches: {launches}; plain-path "
          f"calls {plain}; engine dispatch counts {st['kernel_dispatch']}")
    require(launches["flash_attention"] > 0 and launches["paged_decode"] > 0,
            f"kernel idle on the legacy path: {launches}")
    require(plain == 0, f"plain path ran {plain} times on the legacy path")
    require(st["prefix_hit_tokens"] > 0, "no prefix hits on the legacy path")
    t, o = lat["ttft_us"], lat["tpot_us"]
    print(f"[smoke] legacy trace: {len(segments)} flushed segments merged into "
          f"one .prv ({prv_bytes} bytes; {trace.summary()}); TTFT p50 "
          f"{t['p50']:.0f}us / p95 {t['p95']:.0f}us; TPOT p50 {o['p50']:.0f}us "
          f"/ p95 {o['p95']:.0f}us over {t['count']} requests; device idle "
          f"{idle if idle is None else f'{idle:.1%}'} (profiled wave)")
    require(len(segments) > 0, "no trace segment was flushed")
    require(t["count"] == len(reqs) and o["count"] == len(reqs),
            f"trace holds {t['count']}/{o['count']} latencies, not {len(reqs)}")
    check_first_tokens(torch, model, cfg, prompts,
                       [out[r.rid][0] for r in reqs], "legacy, full width")
    del eng
    torch.cuda.empty_cache()
    return {"flash_attention": launches["flash_attention"]}


def profile_window(torch, eng, prompts, gen, label):
    """Where the time goes: one wave (4 requests) under ``torch.profiler``;
    device-busy share of the wall time and the device time by kernel
    family.  Runs outside the counted main-path waves.  Returns the idle
    share (None when the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in prompts:
            eng.submit(p, gen)
        eng.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if not kern or busy_ms <= 0:
        print(f"[smoke] {label} profile: no device time recorded (not measured)")
        return None
    fams = dict.fromkeys(("flash", "paged_decode", "paged_span", "gemm",
                          "other"), 0.0)
    for e in kern:
        n = e.key.lower()
        fam = next((f for f in ("flash", "paged_decode", "paged_span")
                    if f in n), None) or (
            "gemm" if any(s in n for s in ("gemm", "xmma", "cutlass", "nvjet"))
            else "other")
        fams[fam] += e.self_device_time_total / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    idle = 1 - busy_ms / wall_ms
    print(f"[smoke] {label} profile ({len(prompts)} requests x {gen} tokens): "
          f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({busy_ms / wall_ms:.1%}), idle {idle:.1%}")
    print(f"[smoke] {label} profile device time by family: " + ", ".join(
        f"{k} {v:.1f} ms ({v / busy_ms:.1%})" for k, v in fams.items()))
    for e in top:
        print(f"[smoke] {label} profile top: {e.self_device_time_total / 1e3:8.2f}"
              f" ms x{e.count:<6} {e.key[:90]}")
    return idle


def reduced_phase(torch, np):
    """Reduced granite in f32: the legacy, unified and fixed-batch engines
    under kernel modes pallas and xla give one greedy stream, equal to the
    forward() full-recompute oracle."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.attention import flash, ops, paged
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ContinuousServeEngine, ServeEngine
    from repro_torch.serve.step import UnifiedServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(2)
    gen = 12
    for window in (None, 12):
        base = reduced(get_config("granite-8b"), attention_window=window)
        prompts = [rng.integers(0, base.vocab_size, (n,)).astype(np.int32)
                   for n in (7, 16, 21, 30)]
        streams = {}
        for mode in ("pallas", "xla"):
            cfg = base.replace(kernel_mode=mode)
            model = build_model(cfg, device="cuda", seed=0)
            ops.reset_counts()
            for name, make in (
                    ("legacy", lambda: ContinuousServeEngine(
                        cfg, model, device="cuda", num_slots=2, max_len=48,
                        block_size=16)),
                    ("unified", lambda: UnifiedServeEngine(
                        cfg, model, device="cuda", num_slots=2, max_len=48,
                        block_size=16, chunk_size=8))):
                eng = make()
                reqs = [eng.submit(p, gen) for p in prompts]
                out = eng.run()
                streams[name, mode] = [out[r.rid] for r in reqs]
            static = ServeEngine(cfg, model, device="cuda", max_len=48)
            streams["static", mode] = [static.generate(p[None], num_tokens=gen)[0]
                                       for p in prompts]
            n_kernel = (ops.paged_attention.launches
                        + ops.paged_span_attention.launches
                        + ops.flash_attention.launches)
            n_plain = (paged.paged_decode_plain.calls
                       + paged.paged_span_plain.calls
                       + flash.flash_attention_plain.calls)
            require((ops.flash_attention.launches > 0 and n_plain == 0)
                    if mode == "pallas" else (n_kernel == 0 and n_plain > 0),
                    f"{mode}: {n_kernel} kernel launches, {n_plain} plain calls")
        with torch.inference_mode():
            oracle = []
            for p in prompts:  # greedy full recompute through forward()
                ctx = torch.tensor(p, device="cuda")[None]
                for _ in range(gen):
                    nxt = model(ctx)[0, -1, :base.vocab_size].argmax()
                    ctx = torch.cat([ctx, nxt.view(1, 1).to(ctx.dtype)], 1)
                oracle.append(ctx[0, len(p):].cpu().numpy())
        for key, got in streams.items():
            for a, o in zip(got, oracle):
                require(np.array_equal(a, o),
                        f"window={window} {key}: engine {a} != oracle {o}")
        print(f"[smoke] reduced granite f32 window={window}: greedy streams "
              f"identical for the legacy, unified and fixed-batch engines "
              f"under kernel_mode pallas / xla and the forward() oracle "
              f"({len(prompts)} requests x {gen} tokens)")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("[smoke] FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import flash, paged

    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    print(f"[smoke] card: {card}")
    print(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"capability {cap[0]}.{cap[1]}, {torch.cuda.device_count()} device(s)")
    require(cap[0] == 9, f"compute capability {cap} is not Hopper (9.x)")

    t0 = time.perf_counter()
    for built in build.load_all([paged.SOURCE, flash.SOURCE]):
        print(f"[smoke] built {built.path.name} in {built.seconds:.1f}s")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[smoke] ptxas: {line.strip()}")
    print(f"[smoke] build phase {time.perf_counter() - t0:.1f}s (parallel nvcc)")

    timings = kernel_phase(torch, np)
    timings.update(flash_phase(torch, np))
    launches = full_width_phase(torch, np)
    reduced_phase(torch, np)

    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=timings[name]["max_abs_err"],
                    ms=timings[name]["ms"], plain_ms=timings[name]["plain_ms"],
                    bound_ms=timings[name]["bound_ms"],
                    bound_by=timings[name]["bound_by"],
                    library_ms=timings[name]["library_ms"])
               for name in ("paged_decode", "paged_span", "flash_attention")]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
