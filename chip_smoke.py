#!/usr/bin/env python3
"""Chip smoke test of the torch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, torch version, compute
   capability (must be 9.x, Hopper);
2. build the CUDA paged-attention kernels from ``csrc/`` with nvcc;
3. each kernel against its plain torch version on the card at the main
   path's shapes (G = 4, D = 128, block 16, 8 kv heads) in bf16 and f32,
   sliding-window and NULL-tail cases and a ``row_len == 0`` span row
   included; then its time (CUDA events, L2 flushed before each launch)
   beside the plain version's, ``F.scaled_dot_product_attention`` on the
   gathered view (a yardstick only — the port never calls it) and the
   least time the card could take (bytes over 3.35 TB/s vs flops over the
   dtype's peak);
4. full-width granite-8b (36 layers, d_model 4096, bf16, random weights
   from a seed) through ``UnifiedServeEngine(device="cuda")``: 8 requests
   of 200-512 prompt tokens in pairs sharing a block-aligned prefix, 32
   new tokens each, 4 slots, prefix cache on.  Every kernel launch count
   is zeroed just before and read just after; both kernels must have
   launched and the plain path must not have run.  Each request's first
   token must be the argmax of the model's plain ``forward()`` on its
   prompt up to bf16 noise, with finite logits.  Then one more wave under
   ``torch.profiler`` gives the device-busy share and the device time by
   kernel family;
5. reduced granite (float32, 2 layers, full attention and a sliding
   window) through the engine with ``kernel_mode="pallas"`` (the CUDA
   kernels) and ``"xla"`` (the plain path): the greedy streams must be
   identical, and equal to a greedy full-recompute oracle from the
   model's own ``forward``;
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
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per dtype
TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # max |kernel - plain| (see PERF.md)
# full width, bf16: logit gap of the engine's first token below forward()'s
# argmax (logits ~N(0, 1); bf16 keeps ~3 digits, two attention paths)
FIRST_TOKEN_TOL = 0.1
SOURCE = "src/repro_torch/kernels/attention/csrc/paged_attention.cu"
REPLACES = {"paged_decode": "src/repro/kernels/attention/paged.py:102",
            "paged_span": "src/repro/kernels/attention/paged.py:225"}


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


# ----------------------------------------------------------------------
# phases 4-5: the serve engine
# ----------------------------------------------------------------------
def full_width_phase(torch, np):
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import ops, paged
    from repro_torch.models.model import build_model
    from repro_torch.serve.step import UnifiedServeEngine

    cfg = get_config("granite-8b")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"[smoke] granite-8b full width: {model.param_count() / 1e9:.3f}B "
          f"params {cfg.dtype}, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, init {time.perf_counter() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    gen, bs = 32, 16
    eng = UnifiedServeEngine(cfg, model, device="cuda", num_slots=4,
                             max_len=512 + gen, block_size=bs)
    warm = eng.submit(np.arange(40, dtype=np.int32), 2)  # cuBLAS/lib warm-up
    eng.run()
    require(len(warm.tokens) == 2, "warm-up request did not finish")
    rng = np.random.default_rng(1)
    lens = [int(x) for x in rng.integers(200, 513, 8)]
    heads = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
             for n in lens[:4]]
    prompts = list(heads)
    for i, n in enumerate(lens[4:]):
        shared = min(len(heads[i]), n) // 2 // bs * bs  # block-aligned prefix
        tail = rng.integers(0, cfg.vocab_size, (n - shared,)).astype(np.int32)
        prompts.append(np.concatenate([heads[i][:shared], tail]))
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
    plain = paged.paged_decode_plain.calls + paged.paged_span_plain.calls
    for r in reqs:
        toks = out.get(r.rid)
        require(toks is not None and len(toks) == gen,
                f"request {r.rid} returned {None if toks is None else len(toks)}")
        require(((toks >= 0) & (toks < cfg.vocab_size)).all(), "token out of vocab")
    st = eng.stats
    tokens = st["tokens_decoded"] - stats0["tokens_decoded"]
    print(f"[smoke] served {len(reqs)} requests (prompts {lens}), {tokens} "
          f"tokens in {seconds:.2f}s = {tokens / seconds:.1f} tok/s; peak "
          f"{st['peak_blocks']} blocks, "
          f"{st['prefix_hit_tokens'] - stats0['prefix_hit_tokens']} "
          f"prefix-hit tokens, {st['preemptions'] - stats0['preemptions']} "
          f"preemptions")
    print(f"[smoke] main-path kernel launches: {launches}; plain-path calls "
          f"{plain}; engine dispatch counts {st['kernel_dispatch']}")
    require(all(n > 0 for n in launches.values()), f"kernel idle: {launches}")
    require(plain == 0, f"plain path ran {plain} times on the main path")
    require(st["prefix_hit_tokens"] > stats0["prefix_hit_tokens"],
            "no prefix hits on the shared-prefix pairs")
    # reference: the plain full-sequence forward() on each prompt; the
    # engine's first token (chunked span path + CUDA kernels, bf16) must be
    # that forward's argmax up to bf16 noise in the logits
    worst = 0.0
    with torch.inference_mode():
        for p, r in zip(prompts, reqs):
            logits = model(torch.tensor(p, device="cuda")[None])[0, -1, :cfg.vocab_size]
            require(torch.isfinite(logits).all().item(), "non-finite logits")
            worst = max(worst, (logits.max() - logits[int(out[r.rid][0])]).item())
    print(f"[smoke] full width vs forward(): logits finite; first tokens "
          f"within {worst:.4f} of the forward argmax logit (tol {FIRST_TOKEN_TOL})")
    require(worst <= FIRST_TOKEN_TOL, f"first token {worst} below the argmax")
    profile_window(torch, eng, [p[:256] for p in prompts[:4]], gen)
    del eng, model
    torch.cuda.empty_cache()
    return launches


def profile_window(torch, eng, prompts, gen):
    """Where the time goes: one more wave (4 requests) under
    ``torch.profiler``; device-busy share of the wall time and the device
    time by kernel family.  Runs after the main path's counts are read."""
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
        print("[smoke] profile: no device time recorded (not measured)")
        return
    fams = {"paged_decode": 0.0, "paged_span": 0.0, "gemm": 0.0, "other": 0.0}
    for e in kern:
        n = e.key.lower()
        fam = ("paged_decode" if "paged_decode" in n else "paged_span"
               if "paged_span" in n else "gemm"
               if any(s in n for s in ("gemm", "xmma", "cutlass", "nvjet"))
               else "other")
        fams[fam] += e.self_device_time_total / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    print(f"[smoke] profile ({len(prompts)} requests x {gen} tokens): wall "
          f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({busy_ms / wall_ms:.1%}), idle {1 - busy_ms / wall_ms:.1%}")
    print("[smoke] profile device time by family: " + ", ".join(
        f"{k} {v:.1f} ms ({v / busy_ms:.1%})" for k, v in fams.items()))
    for e in top:
        print(f"[smoke] profile top: {e.self_device_time_total / 1e3:8.2f} ms "
              f"x{e.count:<6} {e.key[:90]}")


def reduced_phase(torch, np):
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.attention import ops, paged
    from repro_torch.models.model import build_model
    from repro_torch.serve.step import UnifiedServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(2)
    for window in (None, 12):
        base = reduced(get_config("granite-8b"), attention_window=window)
        prompts = [rng.integers(0, base.vocab_size, (n,)).astype(np.int32)
                   for n in (7, 16, 21, 30)]
        streams = {}
        for mode in ("pallas", "xla"):
            cfg = base.replace(kernel_mode=mode)
            model = build_model(cfg, device="cuda", seed=0)
            eng = UnifiedServeEngine(cfg, model, device="cuda", num_slots=2,
                                     max_len=48, block_size=16, chunk_size=8)
            ops.reset_counts()
            reqs = [eng.submit(p, 12) for p in prompts]
            out = eng.run()
            streams[mode] = [out[r.rid] for r in reqs]
            n_kernel = ops.paged_attention.launches + ops.paged_span_attention.launches
            n_plain = paged.paged_decode_plain.calls + paged.paged_span_plain.calls
            require((n_kernel > 0 and n_plain == 0) if mode == "pallas"
                    else (n_kernel == 0 and n_plain > 0),
                    f"{mode}: {n_kernel} kernel launches, {n_plain} plain calls")
        with torch.inference_mode():
            oracle = []
            for p in prompts:  # greedy full recompute through forward()
                ctx = torch.tensor(p, device="cuda")[None]
                for _ in range(12):
                    nxt = model(ctx)[0, -1, :base.vocab_size].argmax()
                    ctx = torch.cat([ctx, nxt.view(1, 1).to(ctx.dtype)], 1)
                oracle.append(ctx[0, len(p):].cpu().numpy())
        for a, b, o in zip(streams["pallas"], streams["xla"], oracle):
            require(np.array_equal(a, b), f"window={window}: pallas {a} != xla {b}")
            require(np.array_equal(a, o), f"window={window}: engine {a} != oracle {o}")
        print(f"[smoke] reduced granite f32 window={window}: greedy streams "
              f"identical for kernel_mode pallas / xla and the forward() "
              f"oracle ({len(prompts)} requests x 12 tokens)")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("[smoke] FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from repro_torch.kernels.attention import paged

    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    print(f"[smoke] card: {card}")
    print(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"capability {cap[0]}.{cap[1]}, {torch.cuda.device_count()} device(s)")
    require(cap[0] == 9, f"compute capability {cap} is not Hopper (9.x)")

    t0 = time.perf_counter()
    built = paged.build_kernels()
    print(f"[smoke] built {built.path.name} in {built.seconds:.1f}s "
          f"(phase {time.perf_counter() - t0:.1f}s)")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[smoke] ptxas: {line.strip()}")

    timings = kernel_phase(torch, np)
    launches = full_width_phase(torch, np)
    reduced_phase(torch, np)

    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=timings[name]["max_abs_err"],
                    ms=timings[name]["ms"], plain_ms=timings[name]["plain_ms"],
                    bound_ms=timings[name]["bound_ms"],
                    bound_by=timings[name]["bound_by"],
                    library_ms=timings[name]["library_ms"])
               for name in ("paged_decode", "paged_span")]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
