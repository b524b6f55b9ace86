#!/usr/bin/env python3
"""Chip smoke test of the torch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, torch version, compute
   capability (must be 9.x, Hopper);
2. build the CUDA kernels from ``csrc/`` (paged attention, flash
   attention, the SSD scan), one nvcc per source, started together;
3. each kernel against its plain torch version on the card at the main
   paths' shapes (granite-8b: 32 q / 8 kv heads, D = 128; block 16 for
   the paged kernels) in bf16 and f32 — sliding-window, NULL-tail and
   ``row_len == 0`` cases for the paged kernels; causal, a prefix-hit
   tail at ``q_offset`` 256, a sliding window and ragged lengths (causal
   and bidirectional) for the flash kernel (bf16 q on the tensor cores,
   f32 q on the CUDA cores), each also held to the float64 attention
   oracle (``kernels/attention/ref.py`` ``flash_ref``, ``check_ratio``
   <= 1), as are the GQA groups 1, 8 and 12 of codeqwen / yi /
   mistral-large, head dims 32, 64 and 256, a 2048-token prompt and
   strided views; then its time (CUDA events,
   L2 flushed before each launch) beside the plain version's, one
   PyTorch library call computing the same function
   (``F.scaled_dot_product_attention`` — a yardstick only, the port never
   calls it) and the least time the card could take (bytes over
   3.35 TB/s vs flops over the dtype's peak).  The quantized bodies of
   the paged kernels (int8 and fp8 pools with f32 scales) likewise
   against their plain dequant-gather versions on the same pool (bf16
   and f32 q, window off and on), timed at the same shapes (int8; the
   SDPA yardstick runs over the pre-dequantized bf16 view, dequant
   excluded).  The SSD scan kernel (kernel 4: bf16 on the tensor cores
   in three kernels, chunks in parallel; f32 on the CUDA cores) and its
   plain chunked version each against the float64 sequential recurrence
   at mamba2-370m's widths (H 32, P 64, N 128, G 1; S 200 / 300 / 512,
   B 1 / 4, a 2560-token prompt, S 1 and 17, bf16 and f32), at an
   overflow-prone dt * a (B 1 and 4 at S 300) and at the JAX test's
   grouped shapes (G 2, 4), held to ``ssd_scan.ref.check_ratio`` <= 1
   (the check PERF.md states); then timed at the wave's longest prompt
   (no single PyTorch call computes the scan: no library time); the
   build prints ptxas's registers and spill stores of every SSD kernel.
   The span bodies (kernels 2/2q: bf16 q on the tensor cores with key
   splits, f32 q on the CUDA cores) against the float64 attention oracle
   (``kernels/attention/ref.py``) in 30 cases — native, int8 and fp8
   pools, window off and 100, the main-path rows, a block-unaligned
   start with a 5-token row, a 2560-token table, head dim 64 — and in 24
   more at the GQA groups 1, 8 and 12 of codeqwen / yi / mistral-large
   (native and int8 pools, window off and 100, the main rows and the
   5-token row: one part-empty, two and three 128-row tiles), and in 4
   at beam search's prefill row (one row of Q 512 at start 0: 2048
   folded rows at granite's G 4, 512 at deepseek-moe's G 1; native and
   int8), held to ``ref.check_ratio`` <= 1, a forced single split to the
   oracle and to the split output within one bf16 ulp.  The decode bodies (kernels
   1/1q: 4 warps that divide each block's keys, key splits on the span
   body's merge) against the same oracle in 16 cases at the main path's
   4 slots at 0, 17, 300 and 543 (D 128 and 64, window off and 100, bf16
   q over native, int8 and fp8 pools and f32 q over a native pool) and in
   28 more (bf16 q, native and int8 pools, window off and 100): G 1, 8, 12
   and 16 (D 256) at the head counts of codeqwen / yi / mistral-large /
   recurrentgemma, a 2560-token slot, 64 slots and a slot at position 0,
   each with the plan's splits and one forced split; the timed decode
   cases also print the forced single split's time, and the build prints
   ptxas's registers and spill stores of every decode instantiation.
   The span bodies at the spec lane's verify rows (four slots of K + 1
   = 5 queries, alone at Q 5 and beside two chunk rows at Q 32; native
   and int8 pools) against their plain versions and the oracle, timed
   beside SDPA and the bound.  Flash and decode at the hybrid's and the
   vlm's shapes (``family_kernel_phase``): (a) flash Hq 16 / Hkv 1 / D
   256 under the 2048 window at S 2304 and 2560, (b) flash Hq 16 / Hkv 8
   / D 128 causal at S 1536, (c) decode G 16 / D 256 under the window at
   slots 2047 / 2048 / 2300 / 4000 and (d) G 2 / D 128 at 0 / 17 / 1300 /
   1543 (native and int8 pools, the plan's splits and one), each against
   its plain version and the oracle, timed beside SDPA and the bound;
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
   c-e. four requests of the same stream (two heads and the two prompts
      sharing their prefixes) over quantized pools, same model object: (c) the
      unified engine on an int8 pool, (d) on an fp8 pool, (e) the legacy
      engine on an int8 pool.  Each wave must launch the quantized paged
      bodies on its path (and the flash kernel on (e)), no native paged
      body and no plain path; the pool must hold 76,032 B/token (bf16:
      147,456); first tokens as in (a) at the per-dtype tolerance
      ``FIRST_TOKEN_TOL``; tok/s and the greedy token match against the
      bf16 wave of the same engine; then one profiled wave each;
   f. full-width mamba2-370m (48 layers, d_model 1024, bf16, random
      weights from a seed) on the same stream through
      ``UnifiedServeEngine``, traced (segments flushed, merged into one
      ``.prv`` and parsed back): whole-prompt admission, no pool; the SSD
      kernel must have launched and the plain scan never run; every
      ``EV_STEP_BUDGET`` sample equals ``EV_CHUNK_TOKENS +
      EV_DECODE_TOKENS`` and the chunk tokens sum to the prompts; first
      tokens within ``MAMBA2_FIRST_TOKEN_TOL`` of ``forward()``'s argmax
      under ``kernel_mode="xla"``; tok/s, TTFT/TPOT, one profiled wave;
   g. granite-8b through the unified engine's speculative lane, n-gram
      drafts, K = 4, bf16 pool, greedy, traced: 8 requests of 200-512
      tokens, half tiled from a motif, half random, 32 new tokens each;
      then the same stream with drafts replayed from the non-spec
      engine's own streams (random weights do not continue a motif, so
      n-gram drafts are all rejected: the replay makes the lane commit
      up to K + 1 tokens a dispatch, and must accept a quarter of them).  The native span kernel must have
      launched and no decode kernel, other span body or plain path;
      ``EV_SPEC_DRAFTED`` / ``EV_SPEC_ACCEPTED`` / ``EV_SPEC_K`` in the
      merged ``.prv`` equal the engine's stats; every committed token
      lies within ``SPEC_ORACLE_MARGIN`` of the argmax logit of
      ``forward()`` over the committed context, and is that argmax
      wherever the top-2 margin there is above it.  Prints the acceptance
      rate, tok/s, rolled-back blocks and the first position where the
      stream parts from the non-spec engine's on the same stream;
   h. the same lane with a one-layer ``draft:granite-8b`` model (random
      weights, on the card) over an int8 pool, 4 requests, then those 4
      with drafts replayed from the int8 non-spec streams: the same
      checks on the quantized span body (2q);
   i. mamba2-370m (the model of (f)) through ``ContinuousServeEngine`` on
      two prompts of equal length (one grouped B 2 prefill, each state
      scattered to its slot) and then (f)'s stream: the SSD kernel
      launched, no plain path, a prefill group of more than one prompt,
      tokens held to ``forward()`` over the committed context as in (g)
      at ``MAMBA2_FIRST_TOKEN_TOL``; token agreement with (f);
   j. the same model through ``ServeEngine``: 4 prompts of 300 tokens
      (one B 4 scan a layer), 32 tokens, the checks of (i);
   k. granite-8b (the model of a-h) with n-way forks on the unified
      engine, bf16 pool and then int8: four phase-4 prompts with
      ``n_samples=3``, greedy, 12 slots: every sibling equals its fork 0
      token for token, every fork 0 holds to ``forward()`` under
      ``SPEC_ORACLE_MARGIN``; then a temperature 0.8 fan of two prompts
      twice at one seed (identical runs, fork 0 equal to the unforked
      request); the pool's forks, CoW copies and peak shared blocks;
   l. beam search (width 4, 32 tokens, one 512-token prompt: best-first,
      at least one CoW copy, active blocks back where they started,
      ``EV_FORK`` in the merged ``.prv`` equal to the pool's forks; width
      1 under the margin rule) and a two-turn session (turn 2's prefix
      hits cover turn 1's whole blocks, ``close_session`` releases the
      pin), traced; the granite model is freed after (l);
   m. full-width deepseek-moe-16b (28 layers, d_model 2048, 64 routed
      experts top-6 + 2 shared, bf16, ~33.8 GB of random weights from a
      seed) at the published capacity factor 1.25: the kernel path held
      to the plain path on one batch (four 128-token span rows and 32
      decode steps fed the kernel path's tokens: the plain logits within
      ``MOE_MARGIN`` of their argmax, the argmax wherever the top-2
      margin exceeds it); the phase-4 stream through the unified engine
      under pallas (both paged kernels, no plain path) and xla (stream
      agreement printed) and through the grouped-prefill engine (flash
      and decode kernels); tok/s, TTFT/TPOT, 229,376 pool bytes a token,
      one profiled window with the moe dispatch ops named;
   n. the same model drop-free (cf 11 >= E / k): each first token of the
      stream within ``MOE_MARGIN`` of ``forward()``'s argmax;
   o. full-width recurrentgemma-9b (38 layers: 12 x (rec, rec, attn) + 2
      rec, d_model 4096, MQA 16 / 1 heads of 256, window 2048, bf16,
      8.579B random weights from a seed; the RG-LRU's scan and step timed
      first) through the unified engine, bf16 pool, traced: 8 requests,
      four of 2100-2400 tokens (prefill and decode past the window) and
      four of 200-512, 32 new tokens, 4 slots, the prefix cache requested
      and kept off by the family gate: flash and decode launched, no
      span and no plain call, 12,288 pool bytes a token, budget triples
      as in (f); a profiled window with the RG-LRU's ops named serves the
      model as configured, and every checked wave its pre-cap view (the
      softcap lifted: random weights saturate it), first and committed
      tokens within ``HYBRID_REL_MARGIN`` logit RMS of that view's
      ``forward()`` (every greedy token repeats the fed one: its own logit
      leads with random tied embeddings), the kernel path held to the
      plain one on one batch with that column out (4 x 2112 tokens, 32
      decode steps; the runner-up, max |d logit| within
      ``HYBRID_REL_DIFF`` RMS);
   p. the same view through the unified engine on an int8 pool (6,240
      B/token), the grouped-prefill engine (a B 2 group's RG-LRU state at
      each slot against the solo prefill; two B 2 groups of 2304-token
      prompts, then (o)'s stream) and the fixed-batch engine (the same
      four 2304-token prompts over window rings; its decode is the naive
      one-query path, as in the JAX package), each with (o)'s checks; the
      paged engines' token agreement with (o) and the fixed batch's with
      the grouped-prefill engine;
   q. full-width internvl2-2b (24 layers, d_model 2048, 16 / 8 heads of
      128, 1.892B random weights; 1,024 seeded patch embeddings of width
      1,024 a request) on (a)'s stream shape through the unified and
      grouped-prefill engines: flash and decode launched, no plain call,
      0 prefix hits although the pairs share their text, 98,304 B/token,
      first and committed tokens against ``forward(tokens, patches)``;
   r. the same model through the fixed-batch engine (4 x (1,024 patches
      + 512 tokens));
   (the profiled windows read the profiler's raw device events: busy
   time as the sum of kernel times and as the union of their intervals)
5. reduced granite (float32, 2 layers, full attention and a sliding
   window) through ``ContinuousServeEngine``, ``UnifiedServeEngine`` and
   ``ServeEngine`` with ``kernel_mode="pallas"`` (the CUDA kernels) and
   ``"xla"`` (the plain path): all six greedy streams must be identical,
   and equal to a greedy full-recompute oracle from ``forward()``; then
   the legacy and unified engines over int8 and fp8 pools: pallas and
   xla streams identical per engine and dtype; and reduced mamba2 (f32,
   2 layers) through ``UnifiedServeEngine``: pallas (the SSD kernel) and
   xla streams identical and equal to the ``forward()`` oracle;
6. a ``{"kernels": [...]}`` line (six kernels), the card line again, and last
   ``{"ok": true, "device": {...}}``.

It needs only the repository: weights and inputs are made from seeds.
"""
from __future__ import annotations

import copy
import gc
import json
import math
import pathlib
import re
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per dtype
TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # max |kernel - plain| (see PERF.md)
# full width: logit gap of the engine's first token below forward()'s
# argmax, per pool dtype (logits ~N(0, 1)).  bf16: ~3 digits, two
# attention paths.  int8/fp8: twice the JAX package's 2-layer bound on
# max|dlogit| (0.05 / 0.30) scaled by sqrt(36 / 2) for 36 layers (PERF.md)
FIRST_TOKEN_TOL = {"fp16": 0.1, "int8": 0.5, "fp8": 2.6}
# mamba2's tied-embedding logits are N(0, 32^2): a bf16 ulp at the argmax
# (~137) is 1.0; two roundings and the drift through 48 layers ~1.3
# (PERF.md, PR 16 prediction)
MAMBA2_FIRST_TOKEN_TOL = 8.0
# the spec lane's waves: K, and the top-2 logit margin of forward() over
# the committed context above which a committed token must be forward()'s
# argmax (fixed before the first card run: FIRST_TOKEN_TOL's gaps, 2.5x
# for the bf16 pool's decode drift over 32 steps and 2x for int8's;
# mamba2 keeps MAMBA2_FIRST_TOKEN_TOL).  The same numbers bound every
# committed token's gap below forward()'s argmax logit: a drift that
# cannot flip a margin above m leaves a gap of at most m
SPEC_K = 4
SPEC_ORACLE_MARGIN = {"fp16": 0.25, "int8": 1.0}
# deepseek-moe-16b at full width (waves m, n; fixed before the first card
# run): a flipped expert choice moves the logits further than attention
# rounding alone, so twice the bf16 pool's margin bounds (m) the plain
# path's logits at the kernel path's tokens on the same batch, and (n)
# the drop-free engine's first tokens below forward()'s argmax
MOE_MARGIN = 0.5
MOE_DROP_FREE_CF = 11.0  # >= E / k = 64 / 6: no slot is ever dropped
# recurrentgemma-9b on random weights: its pre-cap logits have an RMS of
# ~64 (a final hidden state of norm ~64 against unit-normal tied
# embedding rows), so its 30 tanh(x / 30) softcap rounds every logit
# above ~270 to exactly 30.0 in f32, and a greedy choice among those
# ties checks nothing.  Waves (o) and (p) serve and check the logits
# before the cap (``precap_view``), in units of each row's logit RMS.
# Each limit is 2.5x the worst reading of a chip run (PERF.md), on one
# batch with the fed token's column out (its own logit, tens of RMS, is
# every argmax): the gap of the kernel path's runner-up below the plain
# path's, and max |d logit|.  The margin also bounds every served
# token's gap below forward()'s argmax; those gaps read 0 (the fed token
# leads), and int8's, read only there, keeps its first value
HYBRID_REL_MARGIN = {"fp16": 0.078, "int8": 0.2}
HYBRID_REL_DIFF = 0.098
# the RG-LRU state a B 2 prefill group leaves at each slot against the
# prompt's solo prefill, |a - b| / |b| per leaf: two rows' states swapped
# or mixed read ~1.4, batch rounding ~1e-2 (fixed before the first run)
HYBRID_STATE_REL = 0.1
CSRC = "src/repro_torch/kernels/attention/csrc/"
KERNELS = ("paged_decode", "paged_span", "paged_decode_quant",
           "paged_span_quant", "flash_attention", "ssd_scan")
SOURCES = {"paged_decode": CSRC + "paged_attention.cu",
           "paged_span": CSRC + "paged_attention.cu",
           "paged_decode_quant": CSRC + "paged_attention.cu",
           "paged_span_quant": CSRC + "paged_attention.cu",
           "flash_attention": CSRC + "flash_attention.cu",
           "ssd_scan": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"}
REPLACES = {"paged_decode": "src/repro/kernels/attention/paged.py:102",
            "paged_span": "src/repro/kernels/attention/paged.py:225",
            "paged_decode_quant": "src/repro/kernels/attention/paged.py:43",
            "paged_span_quant": "src/repro/kernels/attention/paged.py:158",
            "flash_attention": "src/repro/kernels/attention/flash.py:100",
            "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:76"}
# the SSD source's kernels: the f32 body, then the bf16 body's three phases
SSD_KERNELS = ("ssd_scan_kernel", "ssd_chunk_state_kernel",
               "ssd_state_pass_kernel", "ssd_chunk_out_kernel")
# configs whose GQA group (1, 8, 12) the span and flash oracle cases fold
SPAN_GROUP_ARCHS = ("codeqwen1.5-7b", "yi-9b", "mistral-large-123b")
# full-width granite-8b pool bytes per token: 36 layers x 8 kv heads x K,V
# x (128 x 2 B) in bf16; x (128 x 1 B codes + one 4 B scale) quantized
POOL_BYTES_PER_TOKEN = {"fp16": 147_456, "int8": 76_032, "fp8": 76_032}


def require(cond, msg):
    if not cond:
        raise SystemExit(f"[smoke] FAIL: {msg}")


def _heads(arch):
    """(q heads, kv heads) of a config."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg.num_heads, cfg.num_kv_heads


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def ptxas_rows(log: str, kernel: str):
    """[(template arguments, registers, spill store bytes)] of every
    instantiation of ``kernel`` in an ``nvcc -Xptxas=-v`` log ("" for a
    kernel that is not a template)."""
    rows, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            if kernel in name:
                rows.append([name, int(m.group(1)), spill])
            name = None
    try:  # demangle to the template arguments, e.g. <__nv_bfloat16, signed char, 128>
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True,
                               timeout=30).stdout.splitlines()
        for r, full in zip(rows, names):
            m = re.search(kernel + r"(<[^>]*>)", full)
            r[0] = m.group(1) if m else ""  # not a template
    except (OSError, subprocess.SubprocessError):
        pass
    return [tuple(r) for r in rows]


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


def bound_ms(dtype_name, q, kp, bt, starts, lens, window, *, g,
             quantized=False):
    """Least time for the work these inputs need: every attended K/V block
    read once per kv head (a quantized pool: its 1-byte codes and one f32
    K and V scale per position), q read once at the valid query positions,
    out written once there and over every ``row_len == 0`` row (zeros by
    contract; a row's padding past ``row_len`` is neither read nor
    written), tables read once, against 4*D flops per (folded query row,
    attended key)."""
    bs, hkv, d = kp.shape[1], kp.shape[2], kp.shape[3]
    pos_bytes = q.shape[-2] * q.shape[-1] * q.element_size()  # one position
    q_len = q.shape[1] if q.dim() == 4 else 1
    att = _attended(bt.cpu(), starts, lens, bs, window)
    per_key = 2 * (d * kp.element_size() + (4 if quantized else 0))
    kv_bytes = sum(blocks for blocks, _ in att) * bs * hkv * per_key
    valid = sum(int(n) for n in lens)
    zeroed = q_len * sum(1 for n in lens if int(n) == 0)
    io_bytes = ((2 * valid + zeroed) * pos_bytes + bt.numel() * 4
                + 2 * len(starts) * 4)
    flops = sum(sum(keys) for _, keys in att) * hkv * g * 4 * d
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _sms(torch):
    return torch.cuda.get_device_properties(0).multi_processor_count


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
                one = time_ms(torch, lambda: paged.paged_decode_fwd(
                    q, kp, vp, bt, st, splits=1), flush)
                print(f"[smoke] paged_decode bf16 main shapes with one key "
                      f"split (no merge): kernel {one:.4f} ms; the plan's "
                      f"{paged.decode_split_plan(4, 8, 34, _sms(torch))} "
                      f"splits {results['paged_decode']['ms']:.4f} ms")
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
                one = time_ms(torch, lambda: paged.paged_span_fwd(
                    q2, kp, vp, bt2, st2, ln2, splits=1), flush)
                print(f"[smoke] paged_span bf16 main shapes with one key "
                      f"split (no merge): kernel {one:.4f} ms")
    for name, r in results.items():
        print(f"[smoke] {name} bf16 main shapes: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    del flush_buf
    return results


def quant_kernel_phase(torch, np):
    """Kernels 1q/2q: the quantized bodies of the paged kernels against
    their plain dequant-gather versions on the same int8/fp8 pool (codes
    and scales from ``kv_quantize`` of a random pool), bf16 and f32 q,
    window off and on; then their time at rows 1-2's main shapes (int8
    timed for the kernels line, fp8 printed beside it)."""
    from repro_torch.core import quant
    from repro_torch.kernels.attention import ops, paged

    rng = np.random.default_rng(4)
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    shape = dict(hkv=8, g=4, d=128, bs=16, w=34, nb=4096)  # main path
    results = {}

    def quantized(kp, vp, kv_dtype):
        kc, ks = quant.kv_quantize(kp, kv_dtype)
        vc, vs = quant.kv_quantize(vp, kv_dtype)
        return kc, vc, {"k_scales": ks, "v_scales": vs}

    def time_row(name, kv_dtype, err, fwd, plain, sdpa, bound):
        r = dict(max_abs_err=err, ms=time_ms(torch, fwd, flush),
                 plain_ms=time_ms(torch, plain, flush),
                 library_ms=time_ms(torch, sdpa, flush))
        r["bound_ms"], r["bound_by"] = bound
        print(f"[smoke] {name} {kv_dtype} pool, bf16 q, main shapes: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa over the "
              f"dequantized bf16 view {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
        if kv_dtype == "int8":
            results[name] = r

    ops.reset_counts()
    for kv_dtype in ("int8", "fp8"):
        for dt_name in ("bfloat16", "float32"):
            dt = getattr(torch, dt_name)
            for window in (None, 100):
                dec_starts = [int(x) for x in rng.integers(200, 544, 4)]
                q, kp, vp, bt, st, _ = _case(torch, rng, dt, b=4, q_len=1,
                                             starts=dec_starts, lens=[1] * 4,
                                             **shape)
                kc, vc, sc = quantized(kp, vp, kv_dtype)
                out = paged.paged_decode_fwd(q, kc, vc, bt, st, window=window,
                                             **sc)
                ref = paged.paged_decode_plain(q, kc, vc, bt, st,
                                               window=window, **sc)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                require(torch.isfinite(out).all().item(),
                        "paged_decode_quant non-finite")
                print(f"[smoke] paged_decode_quant {kv_dtype} {dt_name} "
                      f"window={window}: max|kernel-plain| {err:.3e} "
                      f"(tol {TOL[dt_name]})")
                require(err <= TOL[dt_name],
                        f"paged_decode_quant {kv_dtype} {dt_name} err {err}")
                if dt_name == "bfloat16" and window is None:
                    kd = quant.kv_dequantize(kc, sc["k_scales"], dt)
                    vd = quant.kv_dequantize(vc, sc["v_scales"], dt)
                    time_row(
                        "paged_decode_quant", kv_dtype, err,
                        lambda: paged.paged_decode_fwd(q, kc, vc, bt, st, **sc),
                        lambda: paged.paged_decode_plain(q, kc, vc, bt, st,
                                                         **sc),
                        sdpa_yardstick(torch, q, kd, vd, bt, dec_starts, 1,
                                       None),
                        bound_ms(dt_name, q, kc, bt, dec_starts, [1] * 4,
                                 None, g=4, quantized=True))
                    one = time_ms(torch, lambda: paged.paged_decode_fwd(
                        q, kc, vc, bt, st, splits=1, **sc), flush)
                    print(f"[smoke] paged_decode_quant {kv_dtype} pool, bf16 "
                          f"q, main shapes with one key split (no merge): "
                          f"kernel {one:.4f} ms")
                starts, lens = [192, 416, 0], [32, 17, 0]
                q, kp, vp, bt, st, ln = _case(torch, rng, dt, b=3, q_len=32,
                                              starts=starts, lens=lens,
                                              **shape)
                kc, vc, sc = quantized(kp, vp, kv_dtype)
                out = paged.paged_span_fwd(q, kc, vc, bt, st, ln,
                                           window=window, **sc)
                ref = paged.paged_span_plain(q, kc, vc, bt, st, ln,
                                             window=window, **sc)
                torch.cuda.synchronize()
                valid = (torch.arange(32, device="cuda")[None] < ln[:, None])
                err = ((out.float() - ref.float()).abs()
                       * valid[..., None, None]).max().item()
                require(torch.isfinite(out).all().item(),
                        "paged_span_quant non-finite")
                require((out[2] == 0).all().item(),
                        "quantized row_len == 0 row not zeros")
                print(f"[smoke] paged_span_quant {kv_dtype} {dt_name} "
                      f"window={window}: max|kernel-plain| {err:.3e} "
                      f"(tol {TOL[dt_name]}), row_len=0 row all zeros")
                require(err <= TOL[dt_name],
                        f"paged_span_quant {kv_dtype} {dt_name} err {err}")
                if dt_name == "bfloat16" and window is None:
                    q2, bt2, st2, ln2 = q[:2].contiguous(), bt[:2].contiguous(), \
                        st[:2].contiguous(), ln[:2].contiguous()
                    kd = quant.kv_dequantize(kc, sc["k_scales"], dt)
                    vd = quant.kv_dequantize(vc, sc["v_scales"], dt)
                    time_row(
                        "paged_span_quant", kv_dtype, err,
                        lambda: paged.paged_span_fwd(q2, kc, vc, bt2, st2, ln2,
                                                     **sc),
                        lambda: paged.paged_span_plain(q2, kc, vc, bt2, st2,
                                                       ln2, **sc),
                        sdpa_yardstick(torch, q2, kd, vd, bt2, starts[:2], 32,
                                       None),
                        bound_ms(dt_name, q2, kc, bt2, starts[:2], lens[:2],
                                 None, g=4, quantized=True))
    # a quantized pool without its scales is refused, never attended raw
    try:
        paged.paged_decode_fwd(q[:, :1].contiguous(), kc, vc, bt, st)
    except ValueError:
        pass
    else:
        require(False, "quantized codes without scales were attended")
    del flush_buf
    return results


def verify_rows_phase(torch, np):
    """Kernels 2/2q at the spec lane's verify rows (waves (g), (h)):
    four slots of K + 1 = 5 queries at decode positions 200-543 (Q 5, a
    dispatch without chunk rows), and the same four beside two chunk rows
    of 32 and 17 queries (Q 32: the verify rows hold 5 of 32).  bf16 q
    over a native and an int8 pool, each against its plain version and
    the float64 oracle, then timed beside SDPA and the byte bound.
    Returns the extra keys of the kernels line."""
    from repro_torch.core import quant
    from repro_torch.kernels.attention import paged
    from repro_torch.kernels.attention import ref as attn_ref

    rng = np.random.default_rng(7)
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    shape = dict(hkv=8, g=4, d=128, bs=16, w=34, nb=4096)
    slots = [int(x) for x in rng.integers(200, 539, 4)]
    extra = {}
    for label, q_len, starts, lens in (
            ("verify Q5", SPEC_K + 1, slots, [SPEC_K + 1] * 4),
            ("verify+chunks Q32", 32, slots + [192, 416],
             [SPEC_K + 1] * 4 + [32, 17])):
        for kv_dtype in ("fp16", "int8"):
            name = "paged_span" if kv_dtype == "fp16" else "paged_span_quant"
            q, kp, vp, bt, st, ln = _case(torch, rng, torch.bfloat16,
                                          b=len(starts), q_len=q_len,
                                          starts=starts, lens=lens, **shape)
            sc = {}
            kd, vd = kp, vp
            if kv_dtype == "int8":
                kp, ks = quant.kv_quantize(kp, "int8")
                vp, vs = quant.kv_quantize(vp, "int8")
                sc = {"k_scales": ks, "v_scales": vs}
                kd = quant.kv_dequantize(kp, ks, torch.bfloat16)
                vd = quant.kv_dequantize(vp, vs, torch.bfloat16)
            out = paged.paged_span_fwd(q, kp, vp, bt, st, ln, **sc)
            ref = paged.paged_span_plain(q, kp, vp, bt, st, ln, **sc)
            want = attn_ref.paged_span_ref(q, kp, vp, bt, st, ln, **sc)
            valid = attn_ref.span_valid(ln, q_len, "cuda")
            torch.cuda.synchronize()
            err = ((out.float() - ref.float()).abs()
                   * valid[..., None, None]).max().item()
            ratio = attn_ref.check_ratio(out, want, valid=valid)
            require(torch.isfinite(out).all().item(), f"{name} {label} non-finite")
            require(err <= TOL["bfloat16"], f"{name} {label} err {err}")
            require(ratio <= 1.0, f"{name} {label} oracle ratio {ratio}")
            ms = time_ms(torch, lambda: paged.paged_span_fwd(
                q, kp, vp, bt, st, ln, **sc), flush)
            sdpa = time_ms(torch, sdpa_yardstick(torch, q, kd, vd, bt, starts,
                                                 q_len, None), flush)
            bound, by = bound_ms("bfloat16", q, kp, bt, starts, lens, None,
                                 g=4, quantized=kv_dtype == "int8")
            splits = paged.span_split_plan(len(starts), 8, q_len * 4, 34,
                                           _sms(torch))
            print(f"[smoke] {name} {kv_dtype} pool, bf16 q, {label} (rows "
                  f"{lens}): max|kernel-plain| {err:.3e}, oracle ratio "
                  f"{ratio:.3f}; kernel {ms:.4f} ms (plan: {splits[0]} tile, "
                  f"{splits[1]} splits), sdpa {sdpa:.4f} ms, bound "
                  f"{bound:.5f} ms ({by})")
            key = "verify" if q_len == SPEC_K + 1 else "verify_chunks"
            extra.setdefault(name, {}).update({
                f"{key}_ms": ms, f"{key}_bound_ms": bound,
                f"{key}_library_ms": sdpa})
    del flush_buf
    return extra


def span_oracle_phase(torch, np):
    """Kernels 2/2q against the float64 oracle (``kernels/attention/
    ref.py``): bf16 q over native, int8 and fp8 pools, window off and 100,
    at the main-path rows, a block-unaligned start with a 5-token row
    (Q*G = 20), a 2560-token table (the key split at work) and head dim
    64; f32 q (the CUDA-core body) at the main-path rows.  Each case holds
    the kernel, and a forced single split, to ``ref.check_ratio`` <= 1 on
    the valid queries and the two to each other within one bf16 ulp
    (``ref.SPLIT_CHECK``), and prints the plain version's ratio beside
    them (its bf16 softmax weights, and a quantized view dequantized to
    bf16, are not held to the bound).  Returns the kernel's ratio at the
    timed shapes per pool."""
    from repro_torch.core import quant
    from repro_torch.kernels.attention import paged
    from repro_torch.kernels.attention import ref as aref

    rng = np.random.default_rng(7)
    sms = _sms(torch)
    cases = [  # name, q_len, d, w, nb, starts, lens
        ("main rows", 32, 128, 34, 4096, [192, 416, 0], [32, 17, 0]),
        ("unaligned + 5-token row", 5, 128, 34, 4096, [203, 37, 0], [5, 3, 0]),
        ("2560-token table", 32, 128, 160, 1024, [2500, 1203], [32, 9]),
        ("head dim 64", 32, 64, 34, 4096, [192, 416, 0], [32, 17, 0]),
    ]
    worst, ratios, n = 0.0, {}, 0

    def one_case(dt_name, kv_dtype, window, name, q_len, d, w, nb, starts,
                 lens, *, hkv=8, g=4, rng=rng):
        dt = getattr(torch, dt_name)
        q, kp, vp, bt, st, ln = _case(
            torch, rng, dt, b=len(starts), q_len=q_len, hkv=hkv, g=g, d=d,
            bs=16, w=w, nb=nb, starts=starts, lens=lens)
        sc = {}
        if kv_dtype != "fp16":
            kp, ks = quant.kv_quantize(kp, kv_dtype)
            vp, vs = quant.kv_quantize(vp, kv_dtype)
            sc = {"k_scales": ks, "v_scales": vs}
        out = paged.paged_span_fwd(q, kp, vp, bt, st, ln, window=window, **sc)
        plain = paged.paged_span_plain(q, kp, vp, bt, st, ln, window=window,
                                       **sc)
        want = aref.paged_span_ref(q, kp, vp, bt, st, ln, window=window, **sc)
        valid = aref.span_valid(ln, q_len)
        r_k = aref.check_ratio(out, want, valid=valid)
        r_p = aref.check_ratio(plain, want, valid=valid)
        tiles, splits = paged.span_split_plan(len(starts), hkv, q_len * g, w,
                                              sms)
        if dt_name != "bfloat16":
            splits = 1
        r_1 = r_1k = 0.0
        if splits > 1:
            one = paged.paged_span_fwd(q, kp, vp, bt, st, ln, window=window,
                                       splits=1, **sc)
            r_1k = aref.check_ratio(one, want, valid=valid)
            r_1 = aref.check_ratio(out, one, *aref.SPLIT_CHECK, valid=valid)
            require((one[ln == 0] == 0).all().item(),
                    "single split: row_len == 0 row not zeros")
        torch.cuda.synchronize()
        what = (f"paged_span {dt_name} q, {kv_dtype} pool, window={window}, "
                f"{name}")
        print(f"[smoke] {what}: oracle ratio kernel {r_k:.3f} (one split "
              f"{r_1k:.3f}; plain {r_p:.3f}); {tiles} row tiles, {splits} key "
              f"splits vs one: ratio {r_1:.3f} (one bf16 ulp)")
        require(torch.isfinite(out).all().item(), f"{what}: non-finite")
        require((out[ln == 0] == 0).all().item(),
                f"{what}: row_len == 0 row not zeros")
        require(max(r_k, r_1k) <= 1.0,
                f"{what}: oracle ratio {r_k} / one split {r_1k}")
        require(r_1 <= 1.0, f"{what}: split vs one split {r_1}")
        return max(r_k, r_1k)

    for dt_name in ("bfloat16", "float32"):
        for kv_dtype in ("fp16", "int8", "fp8"):
            for window in (None, 100):
                for name, q_len, d, w, nb, starts, lens in cases:
                    if dt_name == "float32" and name != "main rows":
                        continue
                    r = one_case(dt_name, kv_dtype, window, name, q_len, d, w,
                                 nb, starts, lens)
                    worst, n = max(worst, r), n + 1
                    if dt_name == "bfloat16" and window is None \
                            and name == "main rows":
                        ratios[kv_dtype] = r
    print(f"[smoke] paged_span oracle: {n} cases, every kernel ratio <= 1 "
          f"(worst {worst:.3f})")
    # G 1, 8 and 12 at the configs' own head counts: a 32-token chunk folds
    # into 32, 256 and 384 rows (one part-empty tile, two and three tiles)
    grng = np.random.default_rng(11)
    rows = [("main rows", 32, [192, 416, 0], [32, 17, 0]),
            ("5-token row", 5, [203, 37, 0], [5, 3, 0])]
    by_g = {}
    for arch in SPAN_GROUP_ARCHS:
        hq, hkv = _heads(arch)
        for kv_dtype in ("fp16", "int8"):
            for window in (None, 100):
                for name, q_len, starts, lens in rows:
                    r = one_case("bfloat16", kv_dtype, window,
                                 f"{name}, {arch} G {hq // hkv}", q_len, 128,
                                 34, 4096, starts, lens, hkv=hkv,
                                 g=hq // hkv, rng=grng)
                    by_g[hq // hkv] = max(by_g.get(hq // hkv, 0.0), r)
    print(f"[smoke] paged_span oracle at G 1 / 8 / 12: "
          f"{2 * 2 * len(rows) * len(SPAN_GROUP_ARCHS)} cases, worst ratio "
          f"by G {by_g}")
    # beam search prefills its prompt as ONE span row: Q 512 at start 0,
    # 2048 folded rows at granite's G 4 and 512 at deepseek-moe's G 1
    brng = np.random.default_rng(13)
    beam = {}
    for arch in ("granite-8b", "deepseek-moe-16b"):
        hq, hkv = _heads(arch)
        for kv_dtype in ("fp16", "int8"):
            beam[arch, kv_dtype] = one_case(
                "bfloat16", kv_dtype, None,
                f"beam prefill row Q 512, {arch} G {hq // hkv}", 512, 128, 34,
                4096, [0], [512], hkv=hkv, g=hq // hkv, rng=brng)
    print(f"[smoke] paged_span oracle, beam-prefill rows: {len(beam)} cases, "
          f"ratios " + ", ".join(f"{a} {k} {r:.3f}" for (a, k), r
                                 in beam.items()))
    return ratios


def decode_oracle_phase(torch, np):
    """Kernels 1/1q against the float64 oracle (``ref.paged_attention_ref``):
    at the main path's decode shapes (4 slots at positions 0, 17, 300 and
    543, Hq 32 / Hkv 8, block 16; D 128 and 64; window off and 100; bf16 q
    over native, int8 and fp8 pools and f32 q over a native pool), and, bf16
    q over native and int8 pools with window off and 100, at the GQA groups
    of codeqwen / yi / mistral-large / recurrentgemma (G 1, 8, 12; G 16 at
    D 256, the largest the launcher takes) at their own head counts, a
    2560-token slot (the plan's 16 splits; window 100 leaves most without
    a key), 64 slots (one split, no merge) and a slot at position 0.  Each
    case holds the kernel with the plan's key splits, and a forced single
    split, to ``ref.check_ratio`` <= 1 and the two to each other within one
    bf16 ulp (``ref.SPLIT_CHECK``), and prints the plain version's ratio
    beside them (its bf16 softmax weights, and a quantized view dequantized
    to bf16, are not held to the bound).  Returns the kernel's ratio per
    pool at the timed shapes (bf16 q, D 128, window off)."""
    from repro_torch.configs import get_config
    from repro_torch.core import quant
    from repro_torch.kernels.attention import paged
    from repro_torch.kernels.attention import ref as aref

    rng = np.random.default_rng(12)
    sms = _sms(torch)
    ratios, worst, n = {}, 0.0, 0

    def one_case(dt_name, kv_dtype, window, what, *, starts, hkv=8, g=4,
                 d=128, w=34, nb=4096):
        q, kp, vp, bt, st, _ = _case(
            torch, rng, getattr(torch, dt_name), b=len(starts), q_len=1,
            hkv=hkv, g=g, d=d, bs=16, w=w, nb=nb, starts=starts,
            lens=[1] * len(starts))
        sc = {}
        if kv_dtype != "fp16":
            kp, ks = quant.kv_quantize(kp, kv_dtype)
            vp, vs = quant.kv_quantize(vp, kv_dtype)
            sc = {"k_scales": ks, "v_scales": vs}
        out = paged.paged_decode_fwd(q, kp, vp, bt, st, window=window, **sc)
        one = paged.paged_decode_fwd(q, kp, vp, bt, st, window=window,
                                     splits=1, **sc)
        plain = paged.paged_decode_plain(q, kp, vp, bt, st, window=window,
                                         **sc)
        want = aref.paged_attention_ref(q, kp, vp, bt, st, window=window, **sc)
        torch.cuda.synchronize()
        r_k, r_1k, r_p = (aref.check_ratio(x, want) for x in (out, one, plain))
        r_1 = aref.check_ratio(out, one, *aref.SPLIT_CHECK)
        splits = paged.decode_split_plan(len(starts), hkv, w, sms)
        what = (f"paged_decode {dt_name} q, {kv_dtype} pool, {what}, "
                f"window={window}")
        print(f"[smoke] {what}: oracle ratio kernel {r_k:.3f} (one split "
              f"{r_1k:.3f}; plain {r_p:.3f}); {splits} key splits vs one: "
              f"ratio {r_1:.3f} (one bf16 ulp)")
        require(torch.isfinite(out).all().item(), f"{what}: non-finite")
        require(max(r_k, r_1k) <= 1.0,
                f"{what}: oracle ratio {r_k} / one split {r_1k}")
        require(r_1 <= 1.0, f"{what}: split vs one split {r_1}")
        return max(r_k, r_1k)

    for d in (128, 64):
        for window in (None, 100):
            for dt_name, kv_dtype in (("bfloat16", "fp16"), ("bfloat16", "int8"),
                                      ("bfloat16", "fp8"), ("float32", "fp16")):
                r = one_case(dt_name, kv_dtype, window, f"main slots, D {d}",
                             starts=[0, 17, 300, 543], d=d)
                worst, n = max(worst, r), n + 1
                if dt_name == "bfloat16" and d == 128 and window is None:
                    ratios[kv_dtype] = r
    print(f"[smoke] paged_decode oracle at the main slots: {n} cases, every "
          f"kernel ratio <= 1 (worst {worst:.3f})")
    cases = [(f"{arch} G {c.num_heads // c.num_kv_heads}",
              dict(starts=[0, 17, 300, 543], hkv=c.num_kv_heads,
                   g=c.num_heads // c.num_kv_heads, d=c.head_dim))
             for arch in (*SPAN_GROUP_ARCHS, "recurrentgemma-9b")
             for c in [get_config(arch)]]
    cases += [("a 2560-token slot", dict(starts=[2559], w=160, nb=1024)),
              ("64 slots", dict(starts=[(37 * i) % 544 for i in range(64)])),
              ("a slot at position 0", dict(starts=[0]))]
    worst, m = 0.0, 0
    for kv_dtype in ("fp16", "int8"):
        for window in (None, 100):
            for what, kw in cases:
                worst, m = max(worst, one_case("bfloat16", kv_dtype, window,
                                               what, **kw)), m + 1
    print(f"[smoke] paged_decode oracle at G 1 / 8 / 12 / 16, a long slot, 64 "
          f"slots, position 0: {m} cases, every kernel ratio <= 1 (worst "
          f"{worst:.3f})")
    return ratios


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
    granite-8b's head shapes and, on the same inputs, against the float64
    oracle (``ref.flash_ref``, held to ``ref.check_ratio`` <= 1, the plain
    version's ratio printed beside it); then the oracle alone at G 1, 8
    and 12 (the configs' own head counts), head dims 32, 64 and 256, a
    2048-token prompt and strided views; then its time at the main-path
    prefill shapes: one 512-token prompt, and a 256-token tail at offset
    256."""
    from repro_torch.kernels.attention import flash
    from repro_torch.kernels.attention import ref as aref

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
    results, worst = {}, {}

    def oracle(what, dt_name, out, plain, q, k, v, kw):
        want = aref.flash_ref(q, k, v, **kw)
        r_k = aref.check_ratio(out, want)
        r_p = aref.check_ratio(plain, want)
        print(f"[smoke] flash_attention {dt_name} {what}: oracle ratio kernel "
              f"{r_k:.3f} (plain {r_p:.3f})")
        require(torch.isfinite(out).all().item(), f"flash {what} non-finite")
        require(r_k <= 1.0, f"flash {dt_name} {what}: oracle ratio {r_k}")
        worst[dt_name] = max(worst.get(dt_name, 0.0), r_k)
        return r_k

    for dt_name in ("bfloat16", "float32"):
        dt = getattr(torch, dt_name)
        for name, sq, skv, causal, window, qoff in cases:
            mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
            q, k, v = mk(1, sq, hq, d), mk(1, skv, hkv, d), mk(1, skv, hkv, d)
            kw = dict(causal=causal, window=window, q_offset=qoff)
            out = flash.flash_attention_fwd(q, k, v, **kw)
            ref = flash.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            what = f"{name} (Sq {sq}, Skv {skv}, offset {qoff})"
            r_k = oracle(what, dt_name, out, ref, q, k, v, kw)
            err = (out.float() - ref.float()).abs().max().item()
            print(f"[smoke] flash_attention {dt_name} {what}: "
                  f"max|kernel-plain| {err:.3e} (tol {TOL[dt_name]})")
            require(err <= TOL[dt_name], f"flash {dt_name} {name} err {err}")
            if dt_name != "bfloat16" or name not in ("causal", "prefix-hit tail"):
                continue
            r = dict(max_abs_err=err, oracle_ratio=r_k,
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
    # the oracle alone: every GQA group the configs fold, the other head
    # dims, a long prompt, and q/k/v as head slices of one fused buffer
    extra = [(f"{arch} G {h // kv}", 512, h, kv, 128)
             for arch, (h, kv) in zip(SPAN_GROUP_ARCHS,
                                      map(_heads, SPAN_GROUP_ARCHS))]
    extra += [("head dim 64", 512, 32, 8, 64), ("head dim 256", 512, 32, 8, 256),
              ("2048-token prompt", 2048, 32, 8, 128),
              ("head dim 32", 512, 32, 8, 32)]
    for dt_name in ("bfloat16", "float32"):
        dt = getattr(torch, dt_name)
        mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
        for name, s, h, kv, dh in extra:
            q, k, v = mk(1, s, h, dh), mk(1, s, kv, dh), mk(1, s, kv, dh)
            kw = dict(causal=True, window=None, q_offset=0)
            out = flash.flash_attention_fwd(q, k, v)
            plain = flash.flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            oracle(f"{name} (Sq {s}, Hq {h} / Hkv {kv}, D {dh})", dt_name,
                   out, plain, q, k, v, kw)
        fused = mk(2, 300, 48, 128)  # [B, S, q | k | v heads, D]
        q, k, v = fused[:, :, :32], fused[:, :, 32:40], fused[:, :, 40:]
        kw = dict(causal=True, window=100, q_offset=0)
        out = flash.flash_attention_fwd(q, k, v, **kw)
        plain = flash.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        oracle("strided views (B 2, Sq 300, window 100)", dt_name, out, plain,
               q, k, v, kw)
    print(f"[smoke] flash_attention oracle: {2 * (len(cases) + len(extra) + 1)} "
          f"cases, every kernel ratio <= 1 (worst by dtype {worst})")
    del flush_buf
    return results


def ssd_bound_ms(dtype_name, x, dt, a_log, bm, cm, y, state, chunk):
    """Least time for one SSD scan: x, dt, a_log, B, C read once, y and
    the state written once, against the SSD algorithm's flops at the
    config's chunk over the chunks these inputs have (C B^T once per
    group, the decay-masked product and the two state products per
    head)."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    io = sum(t.numel() * t.element_size()
             for t in (x, dt, a_log, bm, cm, y, state))
    flops = 0
    for s0 in range(0, s, chunk):
        ln = min(chunk, s - s0)
        flops += b * (g * 2 * ln * ln * n
                      + h * (2 * ln * ln * p + 2 * 2 * ln * n * p))
    t_bytes = io / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ssd_inputs(torch, dtype, b, s, h=32, p=64, n=128, g=1, *, seed=0,
               dt_max=None):
    """x/B/C normal in ``dtype``; dt and a_log as the model's inits draw
    them (dt log-uniform in [1e-3, 0.1], A ~ U[1, 16]) or, with
    ``dt_max``, dt ~ U[0, dt_max] (exp overflows above the diagonal)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *sh: torch.randn(sh, generator=gen, device="cuda").to(dtype)
    u = torch.rand((b, s, h), generator=gen, device="cuda")
    if dt_max is None:
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    else:
        dt = u * dt_max
    a_log = torch.log(1 + 15 * torch.rand((h,), generator=gen, device="cuda"))
    return mk(b, s, h, p), dt, a_log, mk(b, s, g, n), mk(b, s, g, n)


def ssd_phase(torch, np):
    """Kernel 4: the SSD scan kernel and its plain chunked version each
    held to the float64 recurrence, then timed at wave (f)'s longest
    prompt (mamba2-370m, one 512-token prompt, bf16)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ref, scan

    chunk = get_config("mamba2-370m").ssm_chunk
    cases = [(b, s, 32, 64, 128, 1, None) for s in (200, 300, 512)
             for b in (1, 4)]
    cases += [(1, 300, 32, 64, 128, 1, 3.0),  # dt * a down to -48 a token
              (1, 100, 2, 32, 16, 2, None), (2, 64, 8, 16, 8, 4, None)]
    # 40 chunks, one token, one part chunk, 4 ragged tails at a large dt
    cases += [(1, 2560, 32, 64, 128, 1, None), (1, 1, 32, 64, 128, 1, None),
              (1, 17, 32, 64, 128, 1, None), (4, 300, 32, 64, 128, 1, 3.0)]
    worst = {}
    for dt_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dt_name)
        for i, (b, s, h, p, n, g, dt_max) in enumerate(cases):
            x, dt, a_log, bm, cm = ssd_inputs(torch, dtype, b, s, h, p, n, g,
                                              seed=i, dt_max=dt_max)
            y, state = scan.ssd_scan_fwd(x, dt, a_log, bm, cm)
            py, pstate = scan.ssd_chunked_plain(x, dt, a_log, bm, cm, chunk)
            ry, rstate = ref.ssd_sequential_ref(x, dt, a_log, bm, cm)
            torch.cuda.synchronize()
            rk = max(ref.check_ratio(y, ry), ref.check_ratio(state, rstate))
            rp = max(ref.check_ratio(py, ry), ref.check_ratio(pstate, rstate))
            diff = (y.float() - py.float()).abs().max().item()
            worst[dt_name] = max(worst.get(dt_name, 0.0), rk)
            what = (f"ssd_scan {dt_name} B={b} S={s} H={h} P={p} N={n} G={g}"
                    + (f" dt<= {dt_max}" if dt_max else ""))
            print(f"[smoke] {what}: check ratio kernel {rk:.3f}, plain "
                  f"{rp:.3f} (<= 1 passes), max|kernel-plain| {diff:.3e}, "
                  f"max|y| {ry.abs().max().item():.2f}")
            require(torch.isfinite(y).all().item()
                    and torch.isfinite(state).all().item(), f"{what}: non-finite")
            require(rk <= 1.0, f"{what}: kernel outside the check ({rk})")
            require(rp <= 1.0, f"{what}: plain outside the check ({rp})")
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    x, dt, a_log, bm, cm = ssd_inputs(torch, torch.bfloat16, 1, 512, seed=99)
    y, state = scan.ssd_scan_fwd(x, dt, a_log, bm, cm)
    py, _ = scan.ssd_chunked_plain(x, dt, a_log, bm, cm, chunk)
    r = dict(max_abs_err=(y.float() - py.float()).abs().max().item(),
             ms=time_ms(torch, lambda: scan.ssd_scan_fwd(x, dt, a_log, bm, cm),
                        flush),
             plain_ms=time_ms(torch, lambda: scan.ssd_chunked_plain(
                 x, dt, a_log, bm, cm, chunk), flush),
             library_ms=None)
    r["bound_ms"], r["bound_by"] = ssd_bound_ms("bfloat16", x, dt, a_log, bm,
                                                cm, y, state, chunk)
    r["oracle_ratio"] = worst["bfloat16"]
    print(f"[smoke] ssd_scan bf16 wave shapes (B 1, S 512): kernel "
          f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, no library call, "
          f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}); worst check ratio "
          f"{worst}")
    del flush_buf
    return {"ssd_scan": r}


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


def _patches_of(torch, patches, i):
    """``forward()``'s patch argument for request i (None without)."""
    if patches is None:
        return None
    return torch.as_tensor(patches[i], device="cuda")[None]


def _logit_scale(lg, rel):
    """Per-row unit of a logit gap: the row's logit RMS when ``rel``,
    else 1."""
    return lg.float().pow(2).mean(-1).sqrt() if rel else lg.new_ones(
        lg.shape[:-1])


def check_first_tokens(torch, model, cfg, prompts, firsts, what,
                       tol=FIRST_TOKEN_TOL["fp16"], patches=None, rel=False):
    """Each request's first token must be the argmax of the plain
    full-sequence ``forward()`` on its prompt (after its ``patches`` for a
    vlm) up to ``tol`` (bf16 noise, plus the pool's quantization error for
    an int8/fp8 pool); with ``rel``, ``tol`` is in units of the row's
    logit RMS."""
    worst = 0.0
    with torch.inference_mode():
        for i, (p, first) in enumerate(zip(prompts, firsts)):
            logits = model(torch.tensor(p, device="cuda")[None],
                           _patches_of(torch, patches, i))[0, -1, :cfg.vocab_size]
            require(torch.isfinite(logits).all().item(), "non-finite logits")
            worst = max(worst, ((logits.max() - logits[int(first)])
                                / _logit_scale(logits, rel)).item())
    print(f"[smoke] {what} vs forward(): logits finite; first tokens within "
          f"{worst:.4f}{' logit RMS' if rel else ''} of the forward argmax "
          f"logit (tol {tol})")
    require(worst <= tol, f"{what}: first token {worst} below the argmax")


def served(out, reqs, gen, vocab):
    for r in reqs:
        toks = out.get(r.rid)
        require(toks is not None and len(toks) == gen,
                f"request {r.rid} returned {None if toks is None else len(toks)}")
        require(((toks >= 0) & (toks < vocab)).all(), "token out of vocab")


def _attention_counts():
    """The attention wrappers' launch counters and the plain versions'
    calls (their sum under "plain"), read now."""
    from repro_torch.kernels.attention import flash, ops, paged

    return {"flash_attention": ops.flash_attention.launches,
            "paged_decode": ops.paged_attention.launches,
            "paged_decode_quant": ops.paged_attention.quant_launches,
            "paged_span": (ops.paged_span_attention.launches
                           + ops.paged_span_attention.quant_launches),
            "plain": (paged.paged_decode_plain.calls
                      + paged.paged_span_plain.calls
                      + flash.flash_attention_plain.calls)}


def _merged_trace(tracer, base):
    """Finish ``tracer``, merge its flushed segments into one ``.prv`` at
    ``base`` and parse it back: (trace, TTFT/TPOT summary, segments,
    .prv bytes)."""
    from repro_torch import core as xtrace

    segments = list(tracer.segments)
    paths = xtrace.write_prv(tracer.finish(), base, segments=segments)
    trace = xtrace.parse_prv(paths["prv"])
    return (trace, xtrace.serve_latency_summary(trace), len(segments),
            paths["prv"].stat().st_size)


def check_budget_triples(np, trace, prompt_tokens, what):
    """Every EV_STEP_BUDGET sample equals EV_CHUNK_TOKENS +
    EV_DECODE_TOKENS and the chunk tokens sum to the prompts' (whole
    prompts, patches included, folded into the next triple)."""
    from repro_torch.core import events as ev

    evs = trace.events
    by = {c: evs[evs["type"] == c]["value"].astype(np.int64) for c in (
        ev.EV_STEP_BUDGET, ev.EV_CHUNK_TOKENS, ev.EV_DECODE_TOKENS)}
    n = len(by[ev.EV_STEP_BUDGET])
    require(n > 0 and all(len(v) == n for v in by.values()),
            f"{what}: counter triples incomplete {[len(v) for v in by.values()]}")
    require((by[ev.EV_STEP_BUDGET] == by[ev.EV_CHUNK_TOKENS]
             + by[ev.EV_DECODE_TOKENS]).all(),
            f"{what}: EV_STEP_BUDGET != EV_CHUNK_TOKENS + EV_DECODE_TOKENS")
    chunk = int(by[ev.EV_CHUNK_TOKENS].sum())
    require(chunk == prompt_tokens,
            f"{what}: chunk tokens {chunk} != prompt tokens {prompt_tokens}")
    return n


def full_width_phase(torch, np):
    """Phase 4: one full-width granite-8b, served by the unified engine
    (a) and by the grouped-prefill engine with the tracer on (b), then over
    quantized pools: unified int8 (c) and fp8 (d), legacy int8 (e); then
    the unified engine's speculative lane, n-gram drafts on a bf16 pool
    (g) and draft-model drafts on an int8 pool (h), each followed by the
    same stream with the non-spec streams replayed as drafts; then n-way
    forks on a bf16 and an int8 pool (k), and beam search and a two-turn
    session (l).  The model is freed before it returns."""
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
    launches, unified_ref = unified_wave(torch, np, cfg, model)
    legacy_launches, legacy_ref = legacy_wave(torch, np, cfg, model)
    launches.update(legacy_launches)
    launches.update(quant_wave(torch, np, cfg, model, "unified", "int8",
                               unified_ref))
    quant_wave(torch, np, cfg, model, "unified", "fp8", unified_ref)
    quant_wave(torch, np, cfg, model, "legacy", "int8", legacy_ref)
    ref = spec_wave(torch, np, cfg, model, "g", "ngram", "fp16", 8)
    spec_wave(torch, np, cfg, model, "g", "replay", "fp16", 8, ref)
    ref = spec_wave(torch, np, cfg, model, "h", "draft:granite-8b", "int8", 4)
    spec_wave(torch, np, cfg, model, "h", "replay", "int8", 4, ref)
    for kv_dtype in ("fp16", "int8"):
        fork_wave(torch, np, cfg, model, kv_dtype, unified_ref)
    beam_session_wave(torch, np, cfg, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def unified_wave(torch, np, cfg, model):
    from repro_torch.kernels.attention import ops
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
    plain = _attention_counts()["plain"]
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
    return launches, [out[r.rid] for r in reqs]


def legacy_wave(torch, np, cfg, model):
    """The grouped-prefill engine on the same stream, traced: segments
    flushed mid-run, merged into one ``.prv`` and parsed back."""
    from repro_torch import core as xtrace
    from repro_torch.kernels.attention import ops
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
        plain = _attention_counts()["plain"]
        trace, lat, n_seg, prv_bytes = _merged_trace(tracer, base)
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
    print(f"[smoke] legacy trace: {n_seg} flushed segments merged into "
          f"one .prv ({prv_bytes} bytes; {trace.summary()}); TTFT p50 "
          f"{t['p50']:.0f}us / p95 {t['p95']:.0f}us; TPOT p50 {o['p50']:.0f}us "
          f"/ p95 {o['p95']:.0f}us over {t['count']} requests; device idle "
          f"{idle if idle is None else f'{idle:.1%}'} (profiled wave)")
    require(n_seg > 0, "no trace segment was flushed")
    require(t["count"] == len(reqs) and o["count"] == len(reqs),
            f"trace holds {t['count']}/{o['count']} latencies, not {len(reqs)}")
    check_first_tokens(torch, model, cfg, prompts,
                       [out[r.rid][0] for r in reqs], "legacy, full width")
    del eng
    torch.cuda.empty_cache()
    return ({"flash_attention": launches["flash_attention"]},
            [out[r.rid] for r in reqs])


def quant_wave(torch, np, cfg, model, kind, kv_dtype, ref):
    """Waves (c)-(e): four requests of the phase-4 stream (two heads and
    the two prompts sharing their prefixes; cut from eight to keep the
    run near 8 minutes) through the ``kind`` engine over a ``kv_dtype``
    pool, same model object.  Counts zeroed just before the counted run
    and read just after; ``ref`` is the bf16 wave's greedy streams of the
    same engine.  Each wave then runs one profiled window.  Returns the
    quantized launch counts."""
    from repro_torch.kernels.attention import ops
    from repro_torch.serve.engine import ContinuousServeEngine
    from repro_torch.serve.step import UnifiedServeEngine

    gen, bs = 32, 16
    cls = UnifiedServeEngine if kind == "unified" else ContinuousServeEngine
    eng = cls(cfg.replace(kv_dtype=kv_dtype), model, device="cuda",
              num_slots=4, max_len=512 + gen, block_size=bs)
    warm = eng.submit(np.arange(40, dtype=np.int32), 2)  # first launches
    eng.run()
    require(len(warm.tokens) == 2, "quantized warm-up request did not finish")
    storage = str(eng.kv_storage).removeprefix("torch.")
    _, prompts = shared_prefix_stream(np.random.default_rng(1), np,
                                      cfg.vocab_size, bs)
    pick = (0, 1, 4, 5)  # requests 4 and 5 share the heads 0 and 1's prefixes
    prompts, ref = [prompts[i] for i in pick], [ref[i] for i in pick]
    stats0 = dict(eng.stats)
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, gen) for p in prompts]
    out = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"paged_decode_quant": ops.paged_attention.quant_launches,
                "paged_span_quant": ops.paged_span_attention.quant_launches,
                "flash_attention": ops.flash_attention.launches}
    native = ops.paged_attention.launches + ops.paged_span_attention.launches
    plain = _attention_counts()["plain"]
    served(out, reqs, gen, cfg.vocab_size)
    st = eng.stats
    tokens = st["tokens_decoded"] - stats0["tokens_decoded"]
    match = float(np.mean([(out[r.rid] == b).mean() for r, b in zip(reqs, ref)]))
    hits = st["prefix_hit_tokens"] - stats0["prefix_hit_tokens"]
    what = f"{kind} {kv_dtype}"
    print(f"[smoke] {what}: served {len(reqs)} requests, {tokens} tokens in "
          f"{seconds:.2f}s = {tokens / seconds:.1f} tok/s; pool {kv_dtype} "
          f"({storage} K/V + f32 scales) {eng.kv_bytes_per_token} B/token "
          f"(bf16 {POOL_BYTES_PER_TOKEN['fp16']}); {hits} prefix-hit tokens, "
          f"{st['preemptions'] - stats0['preemptions']} preemptions; greedy "
          f"token match vs the bf16 {kind} wave {match:.3f}")
    print(f"[smoke] {what} main-path kernel launches: {launches}; native paged "
          f"launches {native}; plain-path calls {plain}; engine dispatch "
          f"counts {st['kernel_dispatch']}")
    need = (("paged_decode_quant", "paged_span_quant") if kind == "unified"
            else ("paged_decode_quant", "flash_attention"))
    require(all(launches[k] > 0 for k in need), f"{what}: kernel idle {launches}")
    require(native == 0, f"{what}: {native} native paged launches")
    require(plain == 0, f"{what}: plain path ran {plain} times")
    require(eng.kv_bytes_per_token == POOL_BYTES_PER_TOKEN[kv_dtype],
            f"{what}: {eng.kv_bytes_per_token} B/token")
    require(hits > 0, f"{what}: no prefix hits on the shared-prefix pairs")
    check_first_tokens(torch, model, cfg, prompts,
                       [out[r.rid][0] for r in reqs], f"{what}, full width",
                       tol=FIRST_TOKEN_TOL[kv_dtype])
    profile_window(torch, eng, [p[:256] for p in prompts], gen, what)
    del eng
    torch.cuda.empty_cache()
    return {k: launches[k] for k in ("paged_decode_quant", "paged_span_quant")}


def fork_wave(torch, np, cfg, model, kv_dtype, ref):
    """Wave (k): n-way forks on the unified engine over a ``kv_dtype``
    pool.  Four phase-4 prompts with ``n_samples=3``, greedy, on 12 slots
    (every sibling is seated at its parent's fan): each sibling equals
    its fork 0 token for token, and every fork 0 holds to ``forward()``
    over its committed context under ``SPEC_ORACLE_MARGIN`` (``ref`` is
    wave (a)'s streams: the first part is printed).  Then a temperature
    0.8 fan of the first two prompts twice at one seed: both runs
    identical, and each fork 0 equal to the unforked request at that seed.
    A draw depends on the slot row it is sampled in, and those two
    parents take slots 0 and 1 at the first dispatch in both runs (a later
    parent's slot depends on where the siblings sit).  Prints the pool's
    forks, CoW copies and peak shared blocks."""
    from repro_torch.kernels.attention import ops
    from repro_torch.serve.step import UnifiedServeEngine

    gen, bs, n = 32, 16, 3
    _, prompts = shared_prefix_stream(np.random.default_rng(1), np,
                                      cfg.vocab_size, bs)
    prompts = prompts[:4]
    c = cfg.replace(kv_dtype=kv_dtype)

    def engine(**kw):
        return UnifiedServeEngine(c, model, device="cuda", num_slots=4 * n,
                                  max_len=512 + gen, block_size=bs, **kw)

    def fan(eng, g, n_samples, prompts=prompts):
        reqs = [eng.submit(p, g, n_samples=n_samples) for p in prompts]
        out = eng.run()
        return [[out[r.rid] for r in [q] + q.forks] for q in reqs]

    eng = engine()
    fan(eng, 2, 1)  # warm-up
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats0 = dict(eng.throughput_stats())
    streams = fan(eng, gen, n)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    count = "launches" if kv_dtype == "fp16" else "quant_launches"
    launches = {w: getattr(getattr(ops, w), count)
                for w in ("paged_attention", "paged_span_attention")}
    plain = _attention_counts()["plain"]
    st = eng.throughput_stats()
    forks = st["forks"] - stats0["forks"]
    cows = st["cow_copies"] - stats0["cow_copies"]
    tokens = st["tokens_decoded"] - stats0["tokens_decoded"]
    what = f"fork wave (k), {kv_dtype} pool"
    print(f"[smoke] {what}: {len(prompts)} prompts x n={n}, {tokens} tokens "
          f"in {seconds:.2f}s = {tokens / seconds:.1f} tok/s; pool forks "
          f"{forks}, CoW copies {cows}, peak shared blocks "
          f"{st['peak_shared']}, peak blocks {st['peak_blocks']}; kernel "
          f"launches {launches}, plain-path calls {plain}")
    require(all(v > 0 for v in launches.values()), f"{what}: kernel idle")
    require(plain == 0, f"{what}: plain path ran {plain} times")
    require(forks == len(prompts) * (n - 1) and cows > 0
            and st["peak_shared"] > 0, f"{what}: {forks} forks, {cows} CoW")
    for i, fam in enumerate(streams):
        require(len(fam) == n and all(len(t) == gen for t in fam),
                f"{what}: prompt {i} served {[len(t) for t in fam]}")
        for j, t in enumerate(fam[1:], 1):
            require(np.array_equal(t, fam[0]),
                    f"{what}: prompt {i} fork {j} {t} != fork 0 {fam[0]}")
    oracle_check(torch, np, model, cfg, prompts, [f[0] for f in streams],
                 what, SPEC_ORACLE_MARGIN[kv_dtype])
    print(f"[smoke] {what}: greedy siblings equal fork 0 token for token; "
          f"first part of fork 0 from wave (a)'s stream (request, position): "
          f"{first_part(np, [f[0] for f in streams], ref[:4])}")
    tkw = dict(temperature=0.8, seed=11)
    runs = [fan(engine(**tkw), gen // 2, n, prompts[:2]) for _ in range(2)]
    solo = fan(engine(**tkw), gen // 2, 1, prompts[:2])
    for i, (a, b, u) in enumerate(zip(*runs, solo)):
        for j, (x, y) in enumerate(zip(a, b)):
            require(np.array_equal(x, y), f"{what}: temperature 0.8 prompt "
                    f"{i} fork {j} not reproduced at one seed")
        require(np.array_equal(a[0], u[0]), f"{what}: temperature 0.8 prompt "
                f"{i} fork 0 {a[0]} != the unforked request {u[0]}")
    parted = sum(not np.array_equal(f[0], t) for f in runs[0] for t in f[1:])
    print(f"[smoke] {what}: temperature 0.8 fan reproduced at one seed, every "
          f"fork 0 equal to its unforked request; {parted} of "
          f"{2 * (n - 1)} siblings part from fork 0")
    del eng
    torch.cuda.empty_cache()


def beam_session_wave(torch, np, cfg, model):
    """Wave (l): beam search and a session on the unified engine, bf16
    pool, traced (segments flushed, merged into one ``.prv``).  One
    512-token prompt: width 1 holds to ``forward()`` under the margin
    rule (and its first part from the greedy stream is printed), width 4
    over 32 tokens comes back best-first with finite scores, at least one
    CoW copy, the active blocks back where they started, and one
    ``EV_FORK`` in the merged trace per pool fork (the W - 1 aliases of
    the prompt plus every reseat).  Then a two-turn session: turn 2's
    prefix hits cover turn 1's whole blocks; ``close_session`` releases
    the pin."""
    from repro_torch import core as xtrace
    from repro_torch.core import events as ev
    from repro_torch.kernels.attention import ops
    from repro_torch.serve.step import UnifiedServeEngine

    gen, bs, w = 32, 16, 4
    rng = np.random.default_rng(21)
    prompt = rng.integers(0, cfg.vocab_size, (512,)).astype(np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        base = pathlib.Path(tmp) / "serve"
        tracer = xtrace.Tracer("chip-smoke-beam").init()
        eng = UnifiedServeEngine(cfg, model, device="cuda", num_slots=4,
                                 max_len=2 * 512, block_size=bs,
                                 tracer=tracer, flush_every=8, flush_base=base)
        r = eng.submit(prompt, gen)
        greedy = eng.run()[r.rid]
        pool = eng.pool
        active0, forks0 = pool.num_active(), pool.stats["forks"]
        cows0 = pool.stats["cow_copies"]
        ops.reset_counts()
        one = eng.beam_search(prompt, gen, width=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        beams = eng.beam_search(prompt, gen, width=w)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"paged_decode": ops.paged_attention.launches,
                    "paged_span": ops.paged_span_attention.launches}
        plain = _attention_counts()["plain"]
        forks = pool.stats["forks"] - forks0
        cows = pool.stats["cow_copies"] - cows0
        active1 = pool.num_active()
        # a two-turn session on the same engine and trace
        t1 = eng.submit(prompt[:300], gen, session="chat")
        ctx1 = np.concatenate([prompt[:300], eng.run()[t1.rid]])
        follow = rng.integers(0, cfg.vocab_size, (40,)).astype(np.int32)
        t2 = eng.submit(np.concatenate([ctx1, follow]), gen, session="chat")
        eng.run()
        released = eng.close_session("chat")
        trace, _, n_seg, _ = _merged_trace(tracer, base)
    n_fork_ev = int((trace.events["type"] == ev.EV_FORK).sum())
    scores = [sc for _, sc in beams]
    print(f"[smoke] beam wave (l): width {w} x {gen} tokens on a 512-token "
          f"prompt in {seconds:.2f}s; scores best-first {[round(x, 3) for x in scores]}; "
          f"pool forks {forks} ({forks - (w - 1)} reseats), CoW copies "
          f"{cows}, active blocks {active0} -> {active1}; EV_FORK in the "
          f"merged .prv ({n_seg} segments) {n_fork_ev}; kernel "
          f"launches {launches}, plain-path calls {plain}")
    require(len(beams) == w and all(math.isfinite(x) for x in scores)
            and scores == sorted(scores, reverse=True),
            f"beam wave: scores {scores}")
    require(all(len(t) == gen for t, _ in beams), "beam wave: short beam")
    require(all(v > 0 for v in launches.values()) and plain == 0,
            f"beam wave: launches {launches}, plain {plain}")
    require(cows > 0 and active1 == active0,
            f"beam wave: {cows} CoW copies, active {active0} -> {active1}")
    require(n_fork_ev == forks and forks >= w - 1,
            f"beam wave: {n_fork_ev} EV_FORK in the trace, {forks} pool forks")
    oracle_check(torch, np, model, cfg, [prompt], [one[0][0]],
                 "beam wave (l) width 1", SPEC_ORACLE_MARGIN["fp16"])
    print(f"[smoke] beam wave (l): width 1 first part from the greedy stream "
          f"(request, position): {first_part(np, [one[0][0]], [greedy])}")
    need = (len(ctx1) - 1) // bs * bs
    print(f"[smoke] session wave (l): turn 2 ({len(ctx1) + 40} tokens) hit "
          f"{t2.prefix_hit_tokens} prefix tokens of turn 1's {len(ctx1) - 1} "
          f"pooled ({need} in whole blocks); close_session released "
          f"{released} pinned blocks; active blocks now {pool.num_active()}")
    require(t2.prefix_hit_tokens >= need, f"session: {t2.prefix_hit_tokens} "
            f"prefix-hit tokens < {need}")
    require(released > 0 and pool.num_active() == active0,
            f"session: released {released}, active {pool.num_active()}")
    del eng
    torch.cuda.empty_cache()


def moe_phase(torch, np):
    """Waves (m) and (n): full-width deepseek-moe-16b (28 layers, d_model
    2048, 64 routed experts top-6 plus 2 shared, bf16, random weights
    from a seed) on the phase-4 stream with its vocab, at the published
    capacity factor 1.25 (m) and drop-free (n).  Returns nothing: the
    kernel table's launches come from granite's main path."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = get_config("deepseek-moe-16b")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = model.param_count()
    print(f"[smoke] deepseek-moe-16b full width: {n_params / 1e9:.3f}B params "
          f"{cfg.dtype} ({n_params * 2 / 1e9:.2f} GB), {cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.num_experts} experts top-"
          f"{cfg.experts_per_token} + {cfg.num_shared_experts} shared, cf "
          f"{cfg.capacity_factor}, init {time.perf_counter() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    _, prompts = shared_prefix_stream(np.random.default_rng(1), np,
                                      cfg.vocab_size, 16)
    moe_kernel_vs_plain(torch, np, model, cfg, prompts[:4])
    moe_engine_waves(torch, np, model, cfg, prompts)
    moe_drop_free_wave(torch, np, model, cfg, prompts)
    del model
    gc.collect()
    torch.cuda.empty_cache()


def moe_kernel_vs_plain(torch, np, model, cfg, prompts, gen=32, length=128):
    """Wave (m), the kernel path held to the plain path on the SAME batch:
    at cf 1.25 the expert drops depend on every token of a batch, so
    ``forward()`` is no oracle, and the two engines' streams part once a
    rounding flips a token.  Four 128-token rows (t = 512, one group) go
    through ``span_step`` and then ``gen`` decode steps over the paged
    pool under kernel_mode pallas (kernels 2 and 1) and xla (the plain
    path), each step fed the pallas argmax: at every step the plain
    path's logit of that token lies within ``MOE_MARGIN`` of its own
    argmax, and is its argmax wherever its top-2 margin exceeds
    ``MOE_MARGIN``."""
    from repro_torch.kernels.attention import ops

    b, bs = len(prompts), 16
    w = (length + gen) // bs + 1
    tables = (1 + torch.arange(b * w, device="cuda", dtype=torch.int32)
              ).reshape(b, w)
    tokens = torch.tensor(np.stack([p[:length] for p in prompts]),
                          device="cuda")
    zeros = torch.zeros((b,), dtype=torch.int32, device="cuda")
    views = {m: model.serving_view(cfg.replace(kernel_mode=m))
             for m in ("pallas", "xla")}
    pools = {m: {n: torch.zeros(shape, dtype=dt, device="cuda") for n, (shape, dt)
                 in v.paged_cache_specs(b, b * w + 1, bs).items()}
             for m, v in views.items()}
    v = cfg.vocab_size
    worst, checked, under, max_diff = 0.0, 0, 0, 0.0
    ops.reset_counts()
    with torch.inference_mode():
        lg = {m: views[m].span_step(pools[m], tokens, zeros, zeros + length,
                                    tables)[:, -1, :v] for m in views}
        for i in range(gen + 1):
            tok = lg["pallas"].argmax(-1)
            x = lg["xla"].float()
            top2 = x.topk(2, dim=-1).values
            gap = (top2[:, 0] - x.gather(1, tok[:, None])[:, 0]).cpu().numpy()
            sure = ((top2[:, 0] - top2[:, 1]) > MOE_MARGIN).cpu().numpy()
            agree = (x.argmax(-1) == tok).cpu().numpy()
            require((gap <= MOE_MARGIN).all() and agree[sure].all(),
                    f"moe kernel vs plain, step {i}: gaps {gap}, argmax agree "
                    f"{agree} where the top-2 margin > {MOE_MARGIN}: {sure}")
            worst = max(worst, float(gap.max()))
            checked += int(sure.sum())
            under += int((~sure).sum())
            max_diff = max(max_diff, (lg["pallas"].float() - x).abs().max()
                           .item())
            if i == gen:
                break
            idx = zeros + length + i
            lg = {m: views[m].decode_step(pools[m], tok.to(torch.int32), idx,
                                          tables)[:, :v] for m in views}
    launches = {"paged_decode": ops.paged_attention.launches,
                "paged_span": ops.paged_span_attention.launches}
    plain = _attention_counts()["plain"]
    print(f"[smoke] moe wave (m) kernel vs plain on one batch ({b} rows x "
          f"{length} prompt tokens, {gen} decode steps, cf "
          f"{cfg.capacity_factor}): plain logits at the kernel path's tokens "
          f"within {worst:.4f} of their argmax (margin {MOE_MARGIN}); "
          f"{checked} steps with a top-2 margin > {MOE_MARGIN} all agree, "
          f"{under} under it; max |kernel - plain| logit {max_diff:.4f}; "
          f"kernel launches {launches}, plain-path calls {plain} (the xla "
          f"half)")
    require(all(n > 0 for n in launches.values()),
            f"moe kernel vs plain: kernel idle {launches}")


def moe_engine_waves(torch, np, model, cfg, prompts):
    """Wave (m), served: the phase-4 stream (8 requests of 200-512
    tokens, 32 new each, 4 slots) through the unified engine under
    kernel_mode pallas (both paged kernels launched, no plain attention;
    tok/s, TTFT/TPOT, the pool's bytes per token, a profiled window with
    the moe dispatch ops named) and xla (the token agreement with the
    pallas streams is printed: at cf 1.25 a flipped token changes later
    drops), then through the grouped-prefill engine (the flash and decode
    kernels launched)."""
    from repro_torch.kernels.attention import ops
    from repro_torch.serve.engine import ContinuousServeEngine
    from repro_torch.serve.step import UnifiedServeEngine

    gen, bs = 32, 16
    streams = {}

    for label, make in (
            ("unified pallas", lambda: UnifiedServeEngine(
                cfg.replace(kernel_mode="pallas"), model, device="cuda",
                num_slots=4, max_len=512 + gen, block_size=bs)),
            ("unified xla", lambda: UnifiedServeEngine(
                cfg.replace(kernel_mode="xla"), model, device="cuda",
                num_slots=4, max_len=512 + gen, block_size=bs)),
            ("legacy pallas", lambda: ContinuousServeEngine(
                cfg.replace(kernel_mode="pallas"), model, device="cuda",
                num_slots=4, max_len=512 + gen, block_size=bs))):
        eng = make()
        warm = eng.submit(np.arange(40, dtype=np.int32), 2)
        eng.run()
        require(len(warm.tokens) == 2, f"moe {label}: warm-up unfinished")
        stats0 = dict(eng.stats)
        ops.reset_counts()
        plain0 = _attention_counts()["plain"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, gen) for p in prompts]
        out = eng.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        served(out, reqs, gen, cfg.vocab_size)
        streams[label] = [out[r.rid] for r in reqs]
        launches = {"flash_attention": ops.flash_attention.launches,
                    "paged_decode": ops.paged_attention.launches,
                    "paged_span": ops.paged_span_attention.launches}
        plain = _attention_counts()["plain"] - plain0
        tokens = eng.stats["tokens_decoded"] - stats0["tokens_decoded"]
        ttft = np.percentile([r.ttft_ns() / 1e6 for r in reqs], [50, 95])
        tpot = np.percentile([r.tpot_ns() / 1e6 for r in reqs], [50, 95])
        print(f"[smoke] moe wave (m) {label}: {len(reqs)} requests, {tokens} "
              f"tokens in {seconds:.2f}s = {tokens / seconds:.1f} tok/s; TTFT "
              f"p50 {ttft[0]:.0f} / p95 {ttft[1]:.0f} ms, TPOT p50 "
              f"{tpot[0]:.1f} / p95 {tpot[1]:.1f} ms; pool "
              f"{eng.kv_bytes_per_token} B/token, peak "
              f"{eng.stats['peak_blocks']} blocks, "
              f"{eng.stats['prefix_hit_tokens'] - stats0['prefix_hit_tokens']} "
              f"prefix-hit tokens; kernel launches {launches}, plain-path "
              f"calls {plain}")
        require(eng.kv_bytes_per_token == 229_376,
                f"moe pool {eng.kv_bytes_per_token} B/token, not 229,376")
        if label == "unified pallas":
            require(launches["paged_decode"] > 0 and launches["paged_span"] > 0
                    and plain == 0, f"moe {label}: {launches}, plain {plain}")
            profile_window(torch, eng, [p[:256] for p in prompts[:4]], gen,
                           "moe unified", families={
                               "moe top-k sort": ("sort", "radix"),
                               "moe cumsum": ("scan", "cumsum"),
                               "moe one-hot / scatter / gather": (
                                   "scatter", "gather", "index")})
        elif label == "legacy pallas":
            require(launches["flash_attention"] > 0
                    and launches["paged_decode"] > 0 and plain == 0,
                    f"moe {label}: {launches}, plain {plain}")
        else:
            require(sum(launches.values()) == 0 and plain > 0,
                    f"moe {label}: {launches}, plain {plain}")
        del eng
        torch.cuda.empty_cache()
    same = sum(np.array_equal(a, b) for a, b in
               zip(streams["unified pallas"], streams["unified xla"]))
    print(f"[smoke] moe wave (m): unified pallas vs xla streams identical for "
          f"{same} of {len(prompts)} requests, first part (request, position) "
          f"{first_part(np, streams['unified pallas'], streams['unified xla'])}"
          f"; legacy vs unified first part "
          f"{first_part(np, streams['unified pallas'], streams['legacy pallas'])}")


def moe_drop_free_wave(torch, np, model, cfg, prompts):
    """Wave (n): at cf 11 (>= E / k) no slot is dropped, so every grouping
    computes the same function and ``forward()`` is an oracle again: the
    unified engine's first token of each phase-4 prompt lies within
    ``MOE_MARGIN`` of ``forward()``'s argmax logit."""
    from repro_torch.serve.step import UnifiedServeEngine

    free = cfg.replace(capacity_factor=MOE_DROP_FREE_CF)
    eng = UnifiedServeEngine(free, model, device="cuda", num_slots=4,
                             max_len=512 + 2, block_size=16)
    reqs = [eng.submit(p, 2) for p in prompts]
    out = eng.run()
    served(out, reqs, 2, cfg.vocab_size)
    check_first_tokens(torch, model.serving_view(free), free, prompts,
                       [out[r.rid][0] for r in reqs],
                       f"moe wave (n) drop-free cf {MOE_DROP_FREE_CF}",
                       tol=MOE_MARGIN)
    del eng
    torch.cuda.empty_cache()


def mamba2_wave(torch, np):
    """Wave (f): full-width mamba2-370m through the unified engine on the
    phase-4 stream, traced and flushed into a merged ``.prv``; a profiled
    wave first (also the warm-up); then waves (i) and (j) on the same
    model.  Returns the SSD kernel's launches of wave (f)."""
    from repro_torch import core as xtrace
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import scan as ssd_scan
    from repro_torch.models.model import build_model
    from repro_torch.serve.step import UnifiedServeEngine

    cfg = get_config("mamba2-370m")
    gc.collect()  # the granite engines' reference cycles hold its weights
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in model.parameters())
    print(f"[smoke] mamba2-370m full width: {model.param_count() / 1e9:.3f}B "
          f"params {cfg.dtype} ({weights / 2**30:.2f} GiB), {cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.ssm_heads} SSD heads x "
          f"{cfg.ssm_headdim}, state {cfg.ssm_state}, init "
          f"{time.perf_counter() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    gen = 32
    lens, prompts = shared_prefix_stream(np.random.default_rng(1), np,
                                         cfg.vocab_size, 16)
    kw = dict(device="cuda", num_slots=4, max_len=512 + gen)
    eng = UnifiedServeEngine(cfg, model, **kw)
    idle = profile_window(torch, eng, [p[:256] for p in prompts[:4]], gen,
                          "mamba2")
    del eng
    with tempfile.TemporaryDirectory() as tmp:
        base = pathlib.Path(tmp) / "serve"
        tracer = xtrace.Tracer("chip-smoke-mamba2").init()
        eng = UnifiedServeEngine(cfg, model, tracer=tracer, flush_every=16,
                                 flush_base=base, **kw)
        state_bytes = sum(t.numel() * t.element_size()
                          for t in eng._caches.values()) // eng.num_slots
        ssd_ops.reset_counts()
        plain0 = _attention_counts()["plain"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, gen) for p in prompts]
        out = eng.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ssd_ops.ssd_scan.launches
        plain = ssd_scan.ssd_chunked_plain.calls
        plain_attn = _attention_counts()["plain"] - plain0
        trace, lat, n_seg, _ = _merged_trace(tracer, base)
    served(out, reqs, gen, cfg.vocab_size)
    st = eng.stats
    tokens = st["tokens_decoded"]
    print(f"[smoke] mamba2 unified: served {len(reqs)} requests (prompts "
          f"{lens}), {tokens} tokens in {seconds:.2f}s = "
          f"{tokens / seconds:.1f} tok/s; {st['prefills']} whole-prompt "
          f"prefills ({st['prefill_tokens']} tokens), {st['decode_dispatches']} "
          f"decode dispatches, {st['host_syncs']} host syncs; no pool "
          f"({eng.kv_bytes_per_token} B/token), slot state {state_bytes} bytes")
    print(f"[smoke] mamba2 main-path kernel launches: ssd_scan {launches}; "
          f"plain SSD calls {plain}; plain attention calls {plain_attn}")
    require(eng.pool is None and eng.kv_bytes_per_token == 0,
            "mamba2 engine holds a block pool")
    require(launches > 0, "the SSD scan kernel never launched on wave (f)")
    require(plain == 0 and plain_attn == 0,
            f"plain path ran on wave (f): {plain} SSD, {plain_attn} attention")
    n_budget = check_budget_triples(np, trace, sum(lens), "wave (f)")
    t, o = lat["ttft_us"], lat["tpot_us"]
    print(f"[smoke] mamba2 trace: {n_seg} flushed segments merged into "
          f"one .prv ({trace.summary()}); {n_budget} counter triples, "
          f"EV_STEP_BUDGET = EV_CHUNK_TOKENS + EV_DECODE_TOKENS at every "
          f"sample, chunk tokens = the {sum(lens)} prompt tokens; TTFT p50 "
          f"{t['p50']:.0f}us / p95 {t['p95']:.0f}us; TPOT p50 {o['p50']:.0f}us "
          f"/ p95 {o['p95']:.0f}us over {t['count']} requests; device idle "
          f"{idle if idle is None else f'{idle:.1%}'} (profiled wave)")
    require(n_seg > 0, "no trace segment was flushed")
    require(t["count"] == len(reqs), f"trace holds {t['count']} latencies")
    check_first_tokens(torch, model.serving_view(cfg.replace(kernel_mode="xla")),
                       cfg, prompts, [out[r.rid][0] for r in reqs],
                       "mamba2, full width (forward under kernel_mode xla)",
                       tol=MAMBA2_FIRST_TOKEN_TOL)
    del eng
    mamba2_engine_waves(torch, np, cfg, model, prompts,
                        [out[r.rid] for r in reqs])
    del model
    torch.cuda.empty_cache()
    return {"ssd_scan": launches}


def spec_stream(rng, np, vocab, n):
    """n prompts of 200-512 tokens: the even ones tiled from a 7-token
    motif (n-gram drafts accepted), the odd ones random (rejected)."""
    lens = [int(x) for x in rng.integers(200, 513, n)]
    prompts = []
    for i, length in enumerate(lens):
        if i % 2 == 0:
            motif = rng.integers(0, vocab, (7,)).astype(np.int32)
            prompts.append(np.tile(motif, -(-length // 7))[:length])
        else:
            prompts.append(rng.integers(0, vocab, (length,)).astype(np.int32))
    return lens, prompts


def oracle_check(torch, np, model, cfg, prompts, streams, what, margin,
                 patches=None, rel=False):
    """Greedy full recompute over the COMMITTED context: one ``forward()``
    of each prompt plus its committed tokens (after its ``patches`` for a
    vlm) gives the logits after every prefix.  Every committed token's
    logit must lie within ``margin`` of the argmax logit there, and
    wherever the top-2 margin exceeds ``margin`` (stated before the first
    card run) it must be the argmax; with ``rel`` both are in units of
    the row's logit RMS.
    Returns (steps held to the argmax, steps under the margin)."""
    checked = under = 0
    worst = 0.0
    with torch.inference_mode():
        for i, (p, toks) in enumerate(zip(prompts, streams)):
            toks = np.asarray(toks)
            ctx = np.concatenate([p, toks[:-1]]).astype(np.int32)
            pe = _patches_of(torch, patches, i)
            off = 0 if pe is None else pe.shape[1]
            lg = model(torch.tensor(ctx, device="cuda")[None], pe)[
                0, off + len(p) - 1:, :cfg.vocab_size].float()
            require(torch.isfinite(lg).all().item(), f"{what}: non-finite logits")
            lg = lg / _logit_scale(lg, rel)[:, None]
            top2 = lg.topk(2, dim=-1).values
            got = lg.gather(1, torch.as_tensor(toks, device="cuda").long()[:, None])
            gap = (top2[:, 0] - got[:, 0]).cpu().numpy()
            far = np.nonzero(gap > margin)[0]
            require(len(far) == 0, f"{what}: committed token {toks[far[:1]]} "
                    f"lies {gap[far[:1]]} below forward's argmax logit at step "
                    f"{far[:1]} (tol {margin})")
            worst = max(worst, float(gap.max()))
            sure = ((top2[:, 0] - top2[:, 1]) > margin).cpu().numpy()
            arg = lg.argmax(-1).cpu().numpy()
            bad = np.nonzero(sure & (arg != toks))[0]
            require(len(bad) == 0, f"{what}: committed token {toks[bad[:1]]} "
                    f"!= forward argmax {arg[bad[:1]]} at step {bad[:1]} with a "
                    f"top-2 margin above {margin}")
            checked += int(sure.sum())
            under += int((~sure).sum())
    unit = " logit RMS" if rel else ""
    print(f"[smoke] {what} vs forward() over the committed context: all "
          f"{checked + under} committed tokens within {worst:.4f}{unit} of "
          f"the argmax logit (tol {margin}); {checked} steps with a top-2 "
          f"margin > {margin}{unit} all the argmax, {under} under it")
    return checked, under


def first_part(np, a, b):
    """(request, position) where two sets of streams first differ, or
    None."""
    for i, (x, y) in enumerate(zip(a, b)):
        diff = np.nonzero(np.asarray(x) != np.asarray(y))[0]
        if len(diff):
            return i, int(diff[0])
    return None


class ReplayProposer:
    """Drafts the non-spec engine's own greedy continuation of each
    request (found by its prompt): nearly every draft is accepted until
    bf16 noise parts the streams, so the lane commits K + 1 tokens a
    dispatch at full width.  A point-mass proposal, as the n-gram one."""

    def __init__(self, np, prompts, streams):
        self.np, self.prompts, self.streams = np, prompts, streams

    def reset_slot(self, slot):
        pass

    def propose(self, slots, contexts, k):
        np = self.np
        drafts = np.zeros((len(slots), k), np.int32)
        for i, ctx in enumerate(contexts):
            j = next(j for j, p in enumerate(self.prompts)
                     if len(ctx) >= len(p) and (ctx[:len(p)] == p).all())
            cont = self.streams[j][len(ctx) - len(self.prompts[j]):][:k]
            drafts[i, :len(cont)] = cont
        return drafts, None


def spec_wave(torch, np, cfg, model, label, kind, kv_dtype, n_req, ref=None):
    """Waves (g) and (h): the speculative lane of the unified engine
    (``kind`` "ngram", "draft:granite-8b" or "replay": the ReplayProposer,
    K = SPEC_K, greedy) over a ``kv_dtype`` pool, traced and flushed into
    a merged ``.prv``; the non-spec unified engine first serves the same
    stream (outside the counted run; ``ref`` passes its streams in) for
    the first position where the two part.  Returns those streams."""
    from repro_torch import core as xtrace
    from repro_torch.core import events as ev
    from repro_torch.kernels.attention import ops
    from repro_torch.serve.spec import make_proposer
    from repro_torch.serve.step import UnifiedServeEngine

    gen, bs, slots = 32, 16, 4
    ecfg = cfg.replace(kv_dtype=kv_dtype)
    lens, prompts = spec_stream(np.random.default_rng(5), np, cfg.vocab_size,
                                n_req)
    kw = dict(device="cuda", num_slots=slots, max_len=512 + gen, block_size=bs)
    if ref is None:
        ref_eng = UnifiedServeEngine(ecfg, model, **kw)
        rr = [ref_eng.submit(p, gen) for p in prompts]
        ref_out = ref_eng.run()
        ref = [ref_out[r.rid] for r in rr]
        del ref_eng
    with tempfile.TemporaryDirectory() as tmp:
        base = pathlib.Path(tmp) / "serve"
        tracer = xtrace.Tracer(f"chip-smoke-spec-{label}").init()
        prop = (ReplayProposer(np, prompts, ref) if kind == "replay"
                else make_proposer(kind, cfg, num_slots=slots,
                                   max_len=512 + gen, device="cuda"))
        eng = UnifiedServeEngine(ecfg, model, spec=prop, spec_k=SPEC_K,
                                 tracer=tracer, flush_every=16,
                                 flush_base=base, **kw)
        ops.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, gen) for p in prompts]
        out = eng.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        w = ops.paged_span_attention
        span = w.launches if kv_dtype == "fp16" else w.quant_launches
        other_span = w.quant_launches if kv_dtype == "fp16" else w.launches
        decode = ops.paged_attention.launches + ops.paged_attention.quant_launches
        draft_flash = ops.flash_attention.launches
        plain = _attention_counts()["plain"]
        trace, _, n_seg, _ = _merged_trace(tracer, base)
        evs = trace.events
        sums = {c: int(evs[evs["type"] == c]["value"].astype(np.int64).sum())
                for c in (ev.EV_SPEC_DRAFTED, ev.EV_SPEC_ACCEPTED)}
        n_disp = int((evs["type"] == ev.EV_SPEC_K).sum())
    served(out, reqs, gen, cfg.vocab_size)
    st = eng.stats
    streams = [out[r.rid] for r in reqs]
    tokens = sum(len(t) for t in streams)
    what = f"spec ({label}) {kind} {kv_dtype}"
    rate = st["spec_accepted"] / max(st["spec_drafted"], 1)
    part = first_part(np, streams, ref)
    print(f"[smoke] {what}: served {len(reqs)} requests (prompts {lens}), "
          f"{tokens} tokens in {seconds:.2f}s = {tokens / seconds:.1f} tok/s; "
          f"{st['spec_dispatches']} verify dispatches, {st['spec_accepted']}/"
          f"{st['spec_drafted']} drafts accepted ({rate:.1%}), "
          f"{st['spec_rollback_blocks']} blocks rolled back, K={eng._spec_k}; "
          f"first position where spec and non-spec part: "
          f"{'none' if part is None else f'request {part[0]}, token {part[1]}'}")
    print(f"[smoke] {what} kernel launches: span {span}, other span body "
          f"{other_span}, decode {decode}, flash (draft prefill) {draft_flash}; "
          f"plain-path calls {plain}; engine dispatch counts "
          f"{st['kernel_dispatch']}; merged .prv: {n_seg} segments, "
          f"EV_SPEC_K x{n_disp}, EV_SPEC_DRAFTED sum "
          f"{sums[ev.EV_SPEC_DRAFTED]}, EV_SPEC_ACCEPTED sum "
          f"{sums[ev.EV_SPEC_ACCEPTED]}")
    require(span > 0, f"{what}: the span kernel never launched")
    require(decode == 0 and other_span == 0,
            f"{what}: {decode} decode / {other_span} other span launches")
    require(plain == 0, f"{what}: plain path ran {plain} times")
    require(st["spec_dispatches"] > 0, f"{what}: no verify dispatch")
    require(st["spec_accepted"] <= st["spec_drafted"],
            f"{what}: accepted {st['spec_accepted']} > drafted")
    require(n_disp == st["spec_dispatches"]
            and sums[ev.EV_SPEC_DRAFTED] == st["spec_drafted"]
            and sums[ev.EV_SPEC_ACCEPTED] == st["spec_accepted"],
            f"{what}: merged .prv spec counters {sums} x{n_disp} != stats")
    if kind == "replay":
        # drafts past the point where bf16 noise parts a stream from the
        # non-spec one are rejected, so only a quarter is required
        require(st["spec_accepted"] >= st["spec_drafted"] // 4 > 0,
                f"{what}: replayed drafts mostly rejected")
    oracle_check(torch, np, model, cfg, prompts, streams, what,
                 SPEC_ORACLE_MARGIN[kv_dtype])
    del eng, prop
    torch.cuda.empty_cache()
    return ref


def mamba2_engine_waves(torch, np, cfg, model, prompts, unified_out):
    """Waves (i) and (j): full-width mamba2-370m through the grouped-
    prefill ``ContinuousServeEngine`` on two random prompts of 300 tokens
    (admitted together: one B 2 prefill group) and then wave (f)'s
    stream, then the
    fixed-batch ``ServeEngine`` on 4 prompts of 300 tokens (one B 4
    prefill launch per layer); counts zeroed just before each and read
    just after; tokens held to forward() over the committed context
    (kernel_mode xla)."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import scan as ssd_scan
    from repro_torch.serve.engine import ContinuousServeEngine, ServeEngine

    gen = 32
    oracle_model = model.serving_view(cfg.replace(kernel_mode="xla"))

    def counts():
        return (ssd_ops.ssd_scan.launches, ssd_scan.ssd_chunked_plain.calls,
                _attention_counts()["plain"])

    eng = ContinuousServeEngine(cfg, model, device="cuda", num_slots=4,
                                max_len=512 + gen, max_prefills_per_iter=4)
    ssd_ops.reset_counts()
    plain_attn0 = counts()[2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pair = [np.random.default_rng(6).integers(0, cfg.vocab_size, (300,))
            .astype(np.int32) for _ in range(2)]
    wave = pair + list(prompts)
    reqs = [eng.submit(p, gen) for p in wave]
    out = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, plain, plain_attn = counts()
    plain_attn -= plain_attn0
    served(out, reqs, gen, cfg.vocab_size)
    streams = [out[r.rid] for r in reqs]
    st = eng.stats
    groups = st["host_syncs"] - st["decode_syncs"]  # one fetch per group
    match = float(np.mean([(a == b).mean()
                           for a, b in zip(streams[len(pair):], unified_out)]))
    print(f"[smoke] mamba2 legacy (i): served {len(reqs)} requests, "
          f"{st['tokens_decoded']} tokens in {seconds:.2f}s = "
          f"{st['tokens_decoded'] / seconds:.1f} tok/s; {st['prefills']} "
          f"whole-prompt prefills in {groups} "
          f"groups, {st['decode_dispatches']} decode bursts; ssd_scan "
          f"{launches} launches, plain SSD {plain}, plain attention "
          f"{plain_attn}; greedy token agreement with wave (f) {match:.3f}")
    require(eng.pool is None, "mamba2 legacy engine holds a block pool")
    require(launches > 0, "the SSD scan kernel never launched on wave (i)")
    require(st["prefills"] == len(wave) and groups < len(wave),
            f"wave (i): {st['prefills']} prefills in {groups} groups, none "
            f"of more than one prompt")
    require(plain == 0 and plain_attn == 0,
            f"plain path ran on wave (i): {plain} SSD, {plain_attn} attention")
    oracle_check(torch, np, oracle_model, cfg, wave, streams,
                 "mamba2 legacy (i)", MAMBA2_FIRST_TOKEN_TOL)
    del eng
    batch = np.stack([p[:300] for p in prompts[:4]])
    static = ServeEngine(cfg, model, device="cuda", max_len=300 + gen)
    ssd_ops.reset_counts()
    plain_attn0 = counts()[2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = static.generate(batch, num_tokens=gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    s_launches, s_plain, s_plain_attn = counts()
    s_plain_attn -= plain_attn0
    require(got.shape == (4, gen) and ((got >= 0) & (got < cfg.vocab_size)).all(),
            f"wave (j) returned {got.shape}")
    print(f"[smoke] mamba2 fixed batch (j): 4 prompts x 300 tokens, {got.size} "
          f"tokens in {seconds:.2f}s = {got.size / seconds:.1f} tok/s, "
          f"{static.host_syncs} host syncs; ssd_scan {s_launches} launches "
          f"(B 4), plain SSD {s_plain}, plain attention {s_plain_attn}")
    require(s_launches > 0, "the SSD scan kernel never launched on wave (j)")
    require(s_plain == 0 and s_plain_attn == 0,
            f"plain path ran on wave (j): {s_plain} SSD, {s_plain_attn} attention")
    oracle_check(torch, np, oracle_model, cfg, list(batch), list(got),
                 "mamba2 fixed batch (j)", MAMBA2_FIRST_TOKEN_TOL)
    return launches, s_launches


def profile_window(torch, eng, prompts, gen, label, families=None,
                   extras=None):
    """Where the time goes: one wave (4 requests) under ``torch.profiler``,
    recording device activity only; device-busy share of the wall time
    and the device time by kernel family (``families`` adds named ones).
    Read from the profiler's raw device events, not ``key_averages()``
    (whose event tree took ~30 s a window to build): the busy time is
    printed both as the sum of kernel times (as before) and as the union
    of their intervals (a programmatic dependent's wait overlaps its
    predecessor).  Runs outside the counted main-path waves; ``extras``
    holds each request's extras (a vlm's patches).  Returns the idle share
    of the union (None when the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            eng.submit(p, gen, extras=None if extras is None else extras[i])
        eng.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t_post = time.perf_counter()
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and e.duration_ns() > 0]
    busy_ms = sum(e.duration_ns() for e in kern) / 1e6
    if not kern or busy_ms <= 0:
        print(f"[smoke] {label} profile: no device time recorded (not measured)")
        return None
    union_ns, end = 0, None
    for a, b in sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                       for e in kern):
        if end is None or a > end:
            union_ns += b - a
            end = b
        elif b > end:
            union_ns += b - end
            end = b
    union_ms = union_ns / 1e6
    by_name: dict[str, list] = {}
    for e in kern:
        row = by_name.setdefault(e.name(), [0, 0])
        row[0] += e.duration_ns()
        row[1] += 1
    named = {f: (f,) for f in ("flash", "paged_decode", "paged_span",
                               "paged_merge")}
    named["ssd_scan"] = SSD_KERNELS
    named.update(families or {})
    fams = dict.fromkeys((*named, "gemm", "other"), 0.0)
    for name, (ns, _) in by_name.items():
        n = name.lower()
        fam = next((f for f, keys in named.items() if any(k in n for k in keys)),
                   None) or (
            "gemm" if any(s in n for s in ("gemm", "xmma", "cutlass", "nvjet"))
            else "other")
        fams[fam] += ns / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    idle = 1 - union_ms / wall_ms
    print(f"[smoke] {label} profile ({len(prompts)} requests x {gen} tokens): "
          f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({busy_ms / wall_ms:.1%}; union of intervals {union_ms:.1f} ms), "
          f"idle {1 - busy_ms / wall_ms:.1%} (of the union {idle:.1%}); "
          f"aggregation "
          f"{time.perf_counter() - t_post:.1f} s")
    print(f"[smoke] {label} profile device time by family: " + ", ".join(
        f"{k} {v:.1f} ms ({v / busy_ms:.1%})" for k, v in fams.items()))
    for name, (ns, count) in top:
        print(f"[smoke] {label} profile top: {ns / 1e6:8.2f}"
              f" ms x{count:<6} {name[:90]}")
    return idle


# ----------------------------------------------------------------------
# the hybrid (recurrentgemma-9b) and vlm (internvl2-2b) families
# ----------------------------------------------------------------------
def family_kernel_phase(torch, np):
    """Kernels 3 and 1/1q at the hybrid's and the vlm's shapes, bf16 q,
    each held to its plain version (within ``TOL``) and to the float64
    oracle (``ref.check_ratio`` <= 1; the decode cases with the plan's
    key splits and with one forced split), then timed beside the plain
    version, SDPA and the bound: flash (a) Hq 16 / Hkv 1 / D 256 under
    the 2048 window at S 2304 and 2560 (recurrentgemma's prefill) and (b)
    Hq 16 / Hkv 8 / D 128, causal, S 1536 (internvl2's 1,024 patches +
    512 text tokens); decode (c) G 16 / D 256 under the 2048 window, four
    slots at 2047 / 2048 / 2300 / 4000 and (d) G 2 / D 128, slots at 0 /
    17 / 1300 / 1543, each over a native and an int8 pool.  Returns
    {case: timing row}."""
    from repro_torch.core import quant
    from repro_torch.kernels.attention import flash, paged
    from repro_torch.kernels.attention import ref as aref

    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    gen = torch.Generator(device="cuda").manual_seed(28)
    rows = {}

    def row(name, err, ratio, kernel, plain, sdpa, bound):
        r = dict(max_abs_err=err, oracle_ratio=ratio,
                 ms=time_ms(torch, kernel, flush),
                 plain_ms=time_ms(torch, plain, flush),
                 library_ms=time_ms(torch, sdpa, flush))
        r["bound_ms"], r["bound_by"] = bound
        print(f"[smoke] {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
        rows[name] = r

    flash_cases = [("(a) recurrentgemma prefill", s, 16, 1, 256, 2048)
                   for s in (2304, 2560)]
    flash_cases.append(("(b) internvl2 prefill", 1536, 16, 8, 128, None))
    for what, s, hq, hkv, d, window in flash_cases:
        mk = lambda *sh: torch.randn(sh, generator=gen, device="cuda").to(
            torch.bfloat16)
        q, k, v = mk(1, s, hq, d), mk(1, s, hkv, d), mk(1, s, hkv, d)
        kw = dict(causal=True, window=window, q_offset=0)
        out = flash.flash_attention_fwd(q, k, v, **kw)
        plain = flash.flash_attention_plain(q, k, v, **kw)
        want = aref.flash_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - plain.float()).abs().max().item()
        r_k, r_p = aref.check_ratio(out, want), aref.check_ratio(plain, want)
        name = (f"flash_attention bf16 {what} (S {s}, Hq {hq} / Hkv {hkv}, "
                f"D {d}, window {window})")
        print(f"[smoke] {name}: max|kernel-plain| {err:.3e} (tol "
              f"{TOL['bfloat16']}); oracle ratio kernel {r_k:.3f} (plain "
              f"{r_p:.3f})")
        require(torch.isfinite(out).all().item(), f"{name}: non-finite")
        require(err <= TOL["bfloat16"], f"{name}: err {err}")
        require(r_k <= 1.0, f"{name}: oracle ratio {r_k}")
        sdpa = flash_sdpa_yardstick(torch, q, k, v, q_offset=0)
        if window is not None:  # SDPA with the same window mask
            import torch.nn.functional as F

            pos = torch.arange(s, device="cuda")
            m = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - window)
            qt = q.transpose(1, 2).contiguous()
            kt, vt = (x.repeat_interleave(hq // hkv, 2).transpose(1, 2)
                      .contiguous() for x in (k, v))
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,  # noqa: E731
                                                          attn_mask=m)
        row(name, err, r_k,
            lambda: flash.flash_attention_fwd(q, k, v, **kw),
            lambda: flash.flash_attention_plain(q, k, v, **kw), sdpa,
            flash_bound_ms("bfloat16", q, k, causal=True, window=window,
                           q_offset=0))
    rng = np.random.default_rng(28)
    sms = _sms(torch)
    decode_cases = [("(c) recurrentgemma decode", [2047, 2048, 2300, 4000],
                     1, 16, 256, 2048),
                    ("(d) internvl2 decode", [0, 17, 1300, 1543], 8, 2, 128,
                     None)]
    for what, starts, hkv, g, d, window in decode_cases:
        w = max(starts) // 16 + 2
        for kv_dtype in ("fp16", "int8"):
            q, kp, vp, bt, st, _ = _case(
                torch, rng, torch.bfloat16, b=4, q_len=1, hkv=hkv, g=g, d=d,
                bs=16, w=w, nb=4 * w + 8, starts=starts, lens=[1] * 4)
            sc = {}
            if kv_dtype != "fp16":
                kp, ks = quant.kv_quantize(kp, kv_dtype)
                vp, vs = quant.kv_quantize(vp, kv_dtype)
                sc = {"k_scales": ks, "v_scales": vs}
            out = paged.paged_decode_fwd(q, kp, vp, bt, st, window=window, **sc)
            one = paged.paged_decode_fwd(q, kp, vp, bt, st, window=window,
                                         splits=1, **sc)
            plain = paged.paged_decode_plain(q, kp, vp, bt, st, window=window,
                                             **sc)
            want = aref.paged_attention_ref(q, kp, vp, bt, st, window=window,
                                            **sc)
            torch.cuda.synchronize()
            err = (out.float() - plain.float()).abs().max().item()
            r_k, r_1k, r_p = (aref.check_ratio(x, want)
                              for x in (out, one, plain))
            r_1 = aref.check_ratio(out, one, *aref.SPLIT_CHECK)
            splits = paged.decode_split_plan(4, hkv, w, sms)
            name = (f"paged_decode bf16 q {what}, {kv_dtype} pool (slots "
                    f"{starts}, G {g}, D {d}, window {window})")
            print(f"[smoke] {name}: max|kernel-plain| {err:.3e}; oracle ratio "
                  f"kernel {r_k:.3f} ({splits} splits; one split {r_1k:.3f}; "
                  f"plain {r_p:.3f}); splits vs one {r_1:.3f}")
            require(torch.isfinite(out).all().item(), f"{name}: non-finite")
            require(err <= TOL["bfloat16"], f"{name}: err {err}")
            require(max(r_k, r_1k) <= 1.0 and r_1 <= 1.0,
                    f"{name}: oracle {r_k} / one split {r_1k} / vs one {r_1}")
            if kv_dtype == "fp16":
                sdpa = sdpa_yardstick(torch, q, kp, vp, bt, starts, 1, window)
            else:  # over the pre-dequantized view, dequant excluded
                kd = quant.kv_dequantize(kp, sc["k_scales"], torch.bfloat16)
                vd = quant.kv_dequantize(vp, sc["v_scales"], torch.bfloat16)
                sdpa = sdpa_yardstick(torch, q, kd, vd, bt, starts, 1, window)
            row(name, err, max(r_k, r_1k),
                lambda: paged.paged_decode_fwd(q, kp, vp, bt, st,
                                               window=window, **sc),
                lambda: paged.paged_decode_plain(q, kp, vp, bt, st,
                                                 window=window, **sc),
                sdpa, bound_ms("bfloat16", q, kp, bt, starts, [1] * 4, window,
                               g=g, quantized=kv_dtype != "fp16"))
    del flush_buf
    return rows


def hybrid_stream(rng, np, vocab):
    """8 prompts: four of 2100-2400 tokens (past the 2048 window on the
    prefill and on the decode side), four of 200-512."""
    lens = ([int(x) for x in rng.integers(2100, 2401, 4)]
            + [int(x) for x in rng.integers(200, 513, 4)])
    return lens, [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def rglru_timing(torch, model, cfg):
    """Device time of one rec layer's RG-LRU at the wave's shapes: the
    chunked scan over a 2304-token prompt (B 1) and the decode step over
    4 slots (the plain torch ops the JAX package also runs without a
    kernel; CUDA events, L2 flushed)."""
    from repro_torch.models import rglru

    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    rec = next(m for m in model.layers if hasattr(m, "rec")).rec
    lru = cfg.lru_width
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((1, 2304, lru), generator=gen, device="cuda").to(
        torch.bfloat16)
    x1 = x[:, :4].reshape(4, 1, lru)
    h0 = torch.zeros((4, lru), device="cuda")
    with torch.inference_mode():
        scan = time_ms(torch, lambda: rglru.rglru_scan(rec, x), flush_buf.zero_,
                       iters=5)
        step = time_ms(torch, lambda: rglru.rglru_step(rec, x1, h0),
                       flush_buf.zero_)
    n_rec = sum(hasattr(m, "rec") for m in model.layers)
    print(f"[smoke] RG-LRU (plain torch, one rec layer): chunked scan over "
          f"2304 tokens {scan:.3f} ms ({n_rec} layers: {n_rec * scan:.1f} ms a "
          f"prompt), decode step over 4 slots {step:.4f} ms")
    del flush_buf
    return scan, step


def precap_view(model):
    """``model`` with its final ``c tanh(x / c)`` logit softcap lifted: a
    shallow copy sharing every parameter and kernel, whose logits are
    those before the cap.  The cap is monotone, so greedy choice is the
    same in exact arithmetic (see ``HYBRID_REL_MARGIN``)."""
    view = copy.copy(model)
    view.cfg = model.cfg.replace(logit_softcap=None)
    return view


def hybrid_phase(torch, np):
    """Waves (o) and (p): full-width recurrentgemma-9b (38 layers: 12 x
    (rec, rec, attn) + 2 rec, d_model 4096, MQA 16 / 1 heads of 256, local
    window 2048, bf16, ~8.58B random weights from a seed).  (o)'s profiled
    window serves the model as configured; every checked wave serves its
    ``precap_view``.  The model is freed before it returns."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = get_config("recurrentgemma-9b")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = model.param_count()
    print(f"[smoke] recurrentgemma-9b full width: {n_params / 1e9:.3f}B params "
          f"{cfg.dtype} ({n_params * 2 / 1e9:.2f} GB), {cfg.num_layers} layers "
          f"({sum(hasattr(m, 'rec') for m in model.layers)} rec, "
          f"{sum(hasattr(m, 'attn') for m in model.layers)} attn), d_model "
          f"{cfg.d_model}, window {cfg.attention_window}, init "
          f"{time.perf_counter() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    lens, prompts = hybrid_stream(np.random.default_rng(1), np, cfg.vocab_size)
    rglru_timing(torch, model, cfg)
    ref = hybrid_unified_wave(torch, np, model, lens, prompts)
    hybrid_kernel_vs_plain(torch, np, precap_view(model), prompts[:4])
    hybrid_more_engines(torch, np, precap_view(model), prompts, ref)
    print(f"[smoke] recurrentgemma-9b peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del model
    gc.collect()
    torch.cuda.empty_cache()


def hybrid_unified_wave(torch, np, model, lens, prompts):
    """Wave (o): the unified engine, bf16 pool, 4 slots, prefix cache
    requested (the family gate keeps it off); a profiled window first
    (also the warm-up) with the RG-LRU's ops named, serving ``model`` as
    configured; then the stream, traced (segments flushed and merged into
    one ``.prv``), on the pre-cap view, its tokens held to that view's
    ``forward()`` under ``HYBRID_REL_MARGIN``.  Returns the streams."""
    from repro_torch import core as xtrace
    from repro_torch.kernels.attention import ops
    from repro_torch.serve.step import UnifiedServeEngine

    gen, cfg = 32, model.cfg
    kw = dict(device="cuda", num_slots=4, max_len=max(lens) + gen,
              block_size=16, prefix_cache=True)
    eng = UnifiedServeEngine(cfg, model, **kw)
    require(not eng.prefix_cache and not eng.chunkable,
            "recurrentgemma: prefix cache or chunked prefill on")
    require(eng.kv_bytes_per_token == 12_288,
            f"recurrentgemma pool {eng.kv_bytes_per_token} B/token, not 12,288")
    state = sum(t.numel() * t.element_size() for n, t in eng._caches.items()
                if not eng._paged_mask[n]) // eng.num_slots
    idle = profile_window(torch, eng, [prompts[0], prompts[1], prompts[4],
                                       prompts[5]], gen, "recurrentgemma (o)",
                          families={"rglru scan: cumsum": ("cumsum", "scan"),
                                    "rglru scan: masked exp / sum": (
                                        "reduce", "masked_fill", "exp"),
                                    "conv1d": ("conv",)})
    del eng
    model = precap_view(model)
    cfg = model.cfg
    with tempfile.TemporaryDirectory() as tmp:
        base = pathlib.Path(tmp) / "serve"
        tracer = xtrace.Tracer("chip-smoke-hybrid").init()
        eng = UnifiedServeEngine(cfg, model, tracer=tracer, flush_every=16,
                                 flush_base=base, **kw)
        ops.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, gen) for p in prompts]
        out = eng.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        c = _attention_counts()
        trace, lat, n_seg, _ = _merged_trace(tracer, base)
    served(out, reqs, gen, cfg.vocab_size)
    st = eng.stats
    tokens = st["tokens_decoded"]
    print(f"[smoke] recurrentgemma unified (o): served {len(reqs)} requests "
          f"(prompts {lens}), {tokens} tokens in {seconds:.2f}s = "
          f"{tokens / seconds:.1f} tok/s; {st['prefills']} whole-prompt "
          f"prefills, {st['decode_dispatches']} decode dispatches, peak "
          f"{st['peak_blocks']} blocks x {eng.kv_bytes_per_token * 16} B, "
          f"slot state {state} bytes, {st['prefix_hit_tokens']} prefix-hit "
          f"tokens; launches {c}")
    require(c["flash_attention"] > 0 and c["paged_decode"] > 0,
            f"wave (o): kernel idle {c}")
    require(c["paged_span"] == 0 and c["plain"] == 0,
            f"wave (o): span or plain path ran {c}")
    require(st["prefix_hit_tokens"] == 0, "wave (o): prefix hits")
    top = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    last = len(prompts[top]) + gen - 2  # the last decode write position
    require(len(prompts[top]) >= 2048 and len(out[reqs[top].rid]) == gen,
            f"wave (o): no decode past the window ({len(prompts[top])})")
    n_tr = check_budget_triples(np, trace, sum(lens), "wave (o)")
    t, o = lat["ttft_us"], lat["tpot_us"]
    print(f"[smoke] recurrentgemma (o) trace: {n_seg} flushed segments merged "
          f"({trace.summary()}); {n_tr} counter triples, budget = chunk + "
          f"decode at every sample, chunk tokens = the {sum(lens)} prompt "
          f"tokens; decode up to position {last} (window "
          f"{cfg.attention_window}); TTFT p50 {t['p50']:.0f}us / p95 "
          f"{t['p95']:.0f}us; TPOT p50 {o['p50']:.0f}us / p95 {o['p95']:.0f}us "
          f"over {t['count']} requests; device idle "
          f"{idle if idle is None else f'{idle:.1%}'} (profiled wave)")
    require(n_seg > 0 and t["count"] == len(reqs),
            f"wave (o): {n_seg} segments, {t['count']} latencies")
    streams = [out[r.rid] for r in reqs]
    rep = np.mean([(t == p[-1]).mean() for t, p in zip(streams, prompts)])
    print(f"[smoke] recurrentgemma (o): {rep:.3f} of the committed tokens "
          f"repeat their prompt's last token (random tied embeddings: the fed "
          f"token's own logit is the argmax), so the token checks below see "
          f"little more; the kernel-vs-plain batch compares the rest")
    check_first_tokens(torch, model, cfg, prompts, [s[0] for s in streams],
                       "recurrentgemma unified (o), pre-cap",
                       tol=HYBRID_REL_MARGIN["fp16"], rel=True)
    oracle_check(torch, np, model, cfg, prompts, streams,
                 "recurrentgemma unified (o), pre-cap",
                 HYBRID_REL_MARGIN["fp16"], rel=True)
    del eng
    torch.cuda.empty_cache()
    return streams


def hybrid_kernel_vs_plain(torch, np, model, prompts, gen=32, length=2112):
    """Wave (o), the kernel path held to the plain path on one batch, both
    on the pre-cap view ``model``: four rows of 2112 tokens prefilled
    under kernel_mode pallas (flash) and xla (its plain version), written
    into a paged pool as the engine writes them, then ``gen`` decode
    steps (positions 2112 on, past the window) through kernel 1 and its
    plain version, each step fed the pallas argmax.  With random tied
    embeddings the fed token's own logit (its embedding still leads the
    final hidden state; tens of logit RMS) is every argmax, so the
    logits are compared with that column taken out: in units of the
    plain row's logit RMS, the plain logit of the kernel path's
    runner-up within ``HYBRID_REL_MARGIN["fp16"]`` of the plain
    runner-up, the same token wherever the plain top-2 margin there
    exceeds it, and max |pallas - plain| within ``HYBRID_REL_DIFF``.  Two
    readings place that difference: the plain path's own rounding floor
    (its prefill logits of the four rows one at a time against the same
    rows as one B 4 batch), and the plain decode run on a copy of the
    kernel path's pool and state, which differs from the kernel path by
    the decode kernel alone (also within ``HYBRID_REL_DIFF``)."""
    from repro_torch.kernels.attention import ops

    cfg = model.cfg
    margin = HYBRID_REL_MARGIN["fp16"]
    b, bs = len(prompts), 16
    w = (length + gen) // bs + 1
    tables = (1 + torch.arange(b * w, device="cuda", dtype=torch.int32)
              ).reshape(b, w)
    tokens = torch.tensor(np.stack([p[:length] for p in prompts]),
                          device="cuda")
    views = {m: model.serving_view(cfg.replace(kernel_mode=m))
             for m in ("pallas", "xla")}
    v = cfg.vocab_size
    worst, checked, under, repeats, rms = 0.0, 0, 0, 0, []
    diff = {"xla": [], "mixed": []}  # max |pallas - run| a step, in RMS
    ops.reset_counts()
    pools, lg = {}, {}
    with torch.inference_mode():
        for m, view in views.items():
            pool = {n: torch.zeros(shape, dtype=dt, device="cuda") for n, (shape, dt)
                    in view.paged_cache_specs(b, b * w + 1, bs).items()}
            new, last = view.prefill(tokens, max_len=w * bs, ring=False)
            for n, leaf in pool.items():
                if view.paged_leaf_mask()[n]:
                    leaf[:, tables.reshape(-1).long()] = new[n].reshape(
                        leaf.shape[0], b * w, bs, *leaf.shape[3:]).to(leaf.dtype)
                else:
                    leaf.copy_(new[n])
            pools[m], lg[m] = pool, last[:, :v]
        # the plain decode on the kernel path's caches
        runs = dict(views, mixed=views["xla"])
        pools["mixed"] = {n: t.clone() for n, t in pools["pallas"].items()}
        lg["mixed"] = lg["pallas"]
        fed = tokens[:, -1].long()

        def out(t):  # logits in units of the plain row's RMS, fed column out
            return t.float().scatter(1, fed[:, None], float("nan")) / scale

        def dmax(t, u):
            return (out(t) - out(u)).abs().nan_to_num(0.0).max().item()

        def hold(x, t, what):  # t within the margin of x's argmax, and it
            top2 = x.topk(2, dim=-1).values  # where x's top-2 margin > it
            gap = (top2[:, 0] - x.gather(1, t[:, None])[:, 0]).cpu().numpy()
            sure = ((top2[:, 0] - top2[:, 1]) > margin).cpu().numpy()
            agree = (x.argmax(-1) == t).cpu().numpy()
            require((gap <= margin).all() and agree[sure].all(),
                    f"recurrentgemma kernel vs plain, step {i}, {what}: gaps "
                    f"{gap}, agree {agree} where the top-2 margin > {margin}: "
                    f"{sure}")
            return gap, sure

        scale = lg["xla"].float().pow(2).mean(-1, keepdim=True).sqrt()
        solo = torch.cat([views["xla"].prefill(tokens[r:r + 1], max_len=w * bs,
                                               ring=False)[1][:, :v]
                          for r in range(b)])
        floor = dmax(solo, lg["xla"])
        for i in range(gen + 1):
            tok = lg["pallas"].argmax(-1)
            repeats += int((tok == fed).sum())
            scale = lg["xla"].float().pow(2).mean(-1, keepdim=True).sqrt()
            rms.append(scale)
            hold(lg["xla"].float() / scale, tok, "argmax")
            ru = out(lg["pallas"]).nan_to_num(float("-inf")).argmax(-1)
            gap, sure = hold(out(lg["xla"]).nan_to_num(float("-inf")), ru,
                             "runner-up")
            worst = max(worst, float(gap.max()))
            checked += int(sure.sum())
            under += int((~sure).sum())
            for k, d in diff.items():
                d.append(dmax(lg["pallas"], lg[k]))
            if i == gen:
                break
            idx = torch.full((b,), length + i, dtype=torch.int32, device="cuda")
            fed = tok
            lg = {k: run.decode_step(pools[k], tok.to(torch.int32), idx,
                                     tables)[:, :v] for k, run in runs.items()}
    c = _attention_counts()
    rms = torch.cat(rms)
    dx, dm = diff["xla"], diff["mixed"]
    print(f"[smoke] recurrentgemma (o) kernel vs plain on one batch, pre-cap "
          f"({b} rows x {length} tokens, {gen} decode steps at positions "
          f"{length}-{length + gen - 1}; plain logit RMS "
          f"{rms.min().item():.2f}-{rms.max().item():.2f}): the argmax held "
          f"at every step, the fed token at {repeats} of {b * (gen + 1)}; "
          f"with the fed token's column out, the plain logits at the kernel "
          f"path's runner-up within {worst:.4f} RMS of theirs (margin "
          f"{margin}), {checked} steps with a top-2 margin > {margin} RMS "
          f"all the same token, {under} under it; max |kernel - plain| "
          f"logit {max(dx):.4f} RMS (limit {HYBRID_REL_DIFF}): {dx[0]:.4f} at "
          f"the prefill's logits (plain B 1 vs plain B 4 reads {floor:.4f}), "
          f"{dx[1]:.4f} at decode step 1, {dx[-1]:.4f} at step {gen}; the "
          f"plain decode on the kernel path's caches: max {max(dm):.4f} RMS "
          f"({dm[1]:.4f} at step 1, {dm[-1]:.4f} at step {gen}); counts {c} "
          f"(the xla half on the plain path)")
    require(c["flash_attention"] > 0 and c["paged_decode"] > 0,
            f"recurrentgemma kernel vs plain: kernel idle {c}")
    require(max(dx) <= HYBRID_REL_DIFF and max(dm) <= HYBRID_REL_DIFF,
            f"recurrentgemma kernel vs plain: max |d logit| {max(dx)} RMS, "
            f"{max(dm)} on the kernel's caches > {HYBRID_REL_DIFF}")


def hybrid_group_state(torch, np, model, pair):
    """Wave (p): two equal-length prompts admitted by the grouped-prefill
    engine as one B 2 group, one token each (no decode step moves the
    state); the RG-LRU state (``lru`` f32, ``conv`` tail) at each
    request's slot held to its solo prefill's within
    ``HYBRID_STATE_REL``."""
    from repro_torch.serve.engine import ContinuousServeEngine

    n = len(pair[0])
    eng = ContinuousServeEngine(model.cfg, model, device="cuda", num_slots=2,
                                max_len=n + 16, block_size=16,
                                max_prefills_per_iter=2)
    reqs = [eng.submit(p, 1) for p in pair]
    eng.run()
    st = eng.stats
    groups = st["host_syncs"] - st["decode_syncs"]
    rel = {}
    with torch.inference_mode():
        for r, p in zip(reqs, pair):
            solo, _ = model.prefill(torch.tensor(p, device="cuda")[None],
                                    max_len=n + 16, ring=False)
            for leaf in ("lru", "conv"):
                a = eng._caches[leaf][:, r.slot].float()
                ref = solo[leaf][:, 0].float()
                rel[leaf] = max(rel.get(leaf, 0.0),
                                ((a - ref).norm() / ref.norm()).item())
    print(f"[smoke] recurrentgemma legacy (p) B 2 group: {len(pair)} x {n}-token "
          f"prompts in {groups} prefill group(s), slots "
          f"{[r.slot for r in reqs]}; RG-LRU state at each slot vs the solo "
          f"prefill, |d| / |ref|: lru {rel['lru']:.4f}, conv {rel['conv']:.4f} "
          f"(limit {HYBRID_STATE_REL})")
    require(groups == 1 and sorted(r.slot for r in reqs) == [0, 1],
            f"wave (p) B 2 group: {groups} groups")
    require(max(rel.values()) <= HYBRID_STATE_REL,
            f"wave (p) B 2 group: state off its solo prefill {rel}")
    del eng
    torch.cuda.empty_cache()


def _engine_counts_run(torch, eng, prompts, gen, extras=None):
    from repro_torch.kernels.attention import ops

    stats0 = dict(eng.stats)
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, gen, extras=None if extras is None else extras[i])
            for i, p in enumerate(prompts)]
    out = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    tokens = eng.stats["tokens_decoded"] - stats0["tokens_decoded"]
    return reqs, out, seconds, tokens, _attention_counts()


def hybrid_more_engines(torch, np, model, prompts, ref):
    """Wave (p): the pre-cap view of (o)'s model through the unified engine
    on an int8 pool (kernel 1q; 6,240 B/token), the grouped-prefill
    ``ContinuousServeEngine`` (four 2304-token prompts admitted two at a
    time: two B 2 prefill groups, then (o)'s stream) and the fixed-batch
    ``ServeEngine`` (the same four prompts over ring caches of the 2048
    window; its contiguous decode is the naive one-query path, as in the
    JAX package: no decode kernel); each with (o)'s checks.  The paged
    engines print their token agreement with (o), the fixed batch its
    agreement with the grouped-prefill engine on the same four prompts."""
    from repro_torch.serve.engine import ContinuousServeEngine, ServeEngine
    from repro_torch.serve.step import UnifiedServeEngine

    cfg, gen = model.cfg, 32
    max_len = max(len(p) for p in prompts) + gen
    match = lambda streams, ref=ref: float(np.mean(  # noqa: E731
        [(a == b).mean() for a, b in zip(streams, ref)]))
    # unified, int8 pool
    eng = UnifiedServeEngine(cfg.replace(kv_dtype="int8"), model, device="cuda",
                             num_slots=4, max_len=max_len, block_size=16)
    reqs, out, seconds, tokens, c = _engine_counts_run(torch, eng, prompts, gen)
    served(out, reqs, gen, cfg.vocab_size)
    streams = [out[r.rid] for r in reqs]
    print(f"[smoke] recurrentgemma unified int8 (p): {tokens} tokens in "
          f"{seconds:.2f}s = {tokens / seconds:.1f} tok/s; pool "
          f"{eng.kv_bytes_per_token} B/token; launches {c}; greedy token "
          f"match vs (o) {match(streams):.3f}")
    require(eng.kv_bytes_per_token == 6_240,
            f"int8 pool {eng.kv_bytes_per_token} B/token, not 6,240")
    require(c["flash_attention"] > 0 and c["paged_decode_quant"] > 0
            and c["paged_decode"] == 0 and c["paged_span"] == 0
            and c["plain"] == 0, f"wave (p) unified int8: {c}")
    check_first_tokens(torch, model, cfg, prompts, [s[0] for s in streams],
                       "recurrentgemma unified int8 (p), pre-cap",
                       tol=HYBRID_REL_MARGIN["int8"], rel=True)
    oracle_check(torch, np, model, cfg, prompts, streams,
                 "recurrentgemma unified int8 (p), pre-cap",
                 HYBRID_REL_MARGIN["int8"], rel=True)
    del eng
    # grouped prefill: two B 2 groups of 2304-token prompts, then (o)'s
    rng = np.random.default_rng(7)
    quad = [rng.integers(0, cfg.vocab_size, (2304,)).astype(np.int32)
            for _ in range(4)]
    hybrid_group_state(torch, np, model, quad[:2])
    wave = quad + list(prompts)
    eng = ContinuousServeEngine(cfg, model, device="cuda", num_slots=4,
                                max_len=max(max_len, 2304 + gen),
                                block_size=16, max_prefills_per_iter=2)
    reqs, out, seconds, tokens, c = _engine_counts_run(torch, eng, wave, gen)
    served(out, reqs, gen, cfg.vocab_size)
    streams = [out[r.rid] for r in reqs]
    st = eng.stats
    groups = st["host_syncs"] - st["decode_syncs"]  # one fetch a group
    print(f"[smoke] recurrentgemma legacy (p): {len(reqs)} requests, {tokens} "
          f"tokens in {seconds:.2f}s = {tokens / seconds:.1f} tok/s; "
          f"{st['prefills']} prefills in {groups} groups, "
          f"{st['decode_dispatches']} decode bursts; launches {c}; greedy "
          f"token match vs (o) {match(streams[4:]):.3f}")
    require(c["flash_attention"] > 0 and c["paged_decode"] > 0
            and c["paged_span"] == 0 and c["plain"] == 0,
            f"wave (p) legacy: {c}")
    require(groups <= len(wave) - 2,
            f"wave (p) legacy: {groups} groups, not two B 2 groups")
    check_first_tokens(torch, model, cfg, wave, [s[0] for s in streams],
                       "recurrentgemma legacy (p), pre-cap",
                       tol=HYBRID_REL_MARGIN["fp16"], rel=True)
    oracle_check(torch, np, model, cfg, wave, streams,
                 "recurrentgemma legacy (p), pre-cap",
                 HYBRID_REL_MARGIN["fp16"], rel=True)
    legacy_quad = streams[:4]
    del eng
    torch.cuda.empty_cache()
    # fixed batch over ring caches, on the legacy engine's four prompts
    static = ServeEngine(cfg, model, device="cuda", max_len=2304 + gen)
    c0 = _attention_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = static.generate(np.stack(quad), num_tokens=gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    c = {k: n - c0[k] for k, n in _attention_counts().items()}
    print(f"[smoke] recurrentgemma fixed batch (p): 4 prompts x 2304 tokens "
          f"(ring caches of {cfg.attention_window}), {got.size} tokens in "
          f"{seconds:.2f}s = {got.size / seconds:.1f} tok/s, "
          f"{static.host_syncs} host syncs; launches {c}; greedy token match "
          f"vs the legacy engine on the same prompts "
          f"{match(list(got), legacy_quad):.3f}")
    require(c["flash_attention"] > 0 and c["plain"] == 0,
            f"wave (p) fixed batch: {c}")
    check_first_tokens(torch, model, cfg, quad, [s[0] for s in got],
                       "recurrentgemma fixed batch (p), pre-cap",
                       tol=HYBRID_REL_MARGIN["fp16"], rel=True)
    oracle_check(torch, np, model, cfg, quad, list(got),
                 "recurrentgemma fixed batch (p), pre-cap",
                 HYBRID_REL_MARGIN["fp16"], rel=True)


def vlm_stream(rng, np, cfg):
    """8 requests: 1,024 seeded patch embeddings each and 200-512 text
    tokens, in pairs that share a block-aligned text prefix."""
    lens, prompts = shared_prefix_stream(rng, np, cfg.vocab_size, 16)
    patches = rng.standard_normal(
        (len(prompts), cfg.num_patches, cfg.vision_dim)).astype(np.float32)
    return lens, prompts, [{"patch_embeds": e} for e in patches]


def vlm_phase(torch, np):
    """Waves (q) and (r): full-width internvl2-2b (24 layers, d_model
    2048, 16 / 8 heads of 128, ~1.89B random weights from a seed, 1,024
    patch embeddings of width 1,024 a request through ``vision_proj``)
    through the unified and grouped-prefill engines (q) and the
    fixed-batch engine (r): flash and decode kernels launched, no plain
    call, no prefix hit, first tokens within ``FIRST_TOKEN_TOL["fp16"]``
    of ``forward(tokens, patch_embeds)``'s argmax and the committed
    tokens under ``SPEC_ORACLE_MARGIN["fp16"]``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ContinuousServeEngine, ServeEngine
    from repro_torch.serve.step import UnifiedServeEngine

    cfg = get_config("internvl2-2b")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = model.param_count()
    print(f"[smoke] internvl2-2b full width: {n_params / 1e9:.3f}B params "
          f"{cfg.dtype} ({n_params * 2 / 1e9:.2f} GB), {cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.num_patches} patches x "
          f"{cfg.vision_dim}, init {time.perf_counter() - t0:.1f}s")
    gen, p0 = 32, cfg.num_patches
    lens, prompts, extras = vlm_stream(np.random.default_rng(1), np, cfg)
    patches = [e["patch_embeds"] for e in extras]
    max_len = max(lens) + p0 + gen
    ref = None
    for label, cls in (("unified", UnifiedServeEngine),
                       ("legacy", ContinuousServeEngine)):
        eng = cls(cfg, model, device="cuda", num_slots=4, max_len=max_len,
                  block_size=16, prefix_cache=True)
        require(not eng.prefix_cache, f"internvl2 {label}: prefix cache on")
        if label == "unified":
            profile_window(torch, eng, prompts[:4], gen, "internvl2 (q)",
                           extras=extras[:4])
        reqs, out, seconds, tokens, c = _engine_counts_run(
            torch, eng, prompts, gen, extras)
        served(out, reqs, gen, cfg.vocab_size)
        streams = [out[r.rid] for r in reqs]
        st = eng.stats
        ttft = np.percentile([r.ttft_ns() / 1e6 for r in reqs], [50, 95])
        tpot = np.percentile([r.tpot_ns() / 1e6 for r in reqs], [50, 95])
        agree = "" if ref is None else (
            f"; greedy token match vs unified "
            f"{float(np.mean([(a == b).mean() for a, b in zip(streams, ref)])):.3f}")
        print(f"[smoke] internvl2 {label} (q): {len(reqs)} requests (text "
              f"{lens} + {p0} patches each), {tokens} tokens in "
              f"{seconds:.2f}s = {tokens / seconds:.1f} tok/s; TTFT p50 "
              f"{ttft[0]:.0f} / p95 {ttft[1]:.0f} ms, TPOT p50 {tpot[0]:.1f} / "
              f"p95 {tpot[1]:.1f} ms; pool {eng.kv_bytes_per_token} B/token, "
              f"{st['prefix_hit_tokens']} prefix-hit tokens; launches "
              f"{c}{agree}")
        require(eng.kv_bytes_per_token == 98_304,
                f"internvl2 pool {eng.kv_bytes_per_token} B/token, not 98,304")
        require(c["flash_attention"] > 0 and c["paged_decode"] > 0
                and c["paged_span"] == 0 and c["plain"] == 0,
                f"wave (q) {label}: {c}")
        require(st["prefix_hit_tokens"] == 0 and all(
            r.prefix_hit_tokens == 0 and not r.extras for r in reqs),
            f"wave (q) {label}: prefix hits or extras kept")
        check_first_tokens(torch, model, cfg, prompts, [s[0] for s in streams],
                           f"internvl2 {label} (q)", patches=patches)
        oracle_check(torch, np, model, cfg, prompts, streams,
                     f"internvl2 {label} (q)", SPEC_ORACLE_MARGIN["fp16"],
                     patches=patches)
        ref = ref or streams
        del eng
        torch.cuda.empty_cache()
    # (r): the fixed batch, four requests of 512 text tokens
    batch = np.stack([np.resize(p, 512) for p in prompts[:4]])
    static = ServeEngine(cfg, model, device="cuda", max_len=512 + p0 + gen)
    c0 = _attention_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = static.generate(batch, num_tokens=gen,
                          extras={"patch_embeds": np.stack(patches[:4])})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    c = {k: n - c0[k] for k, n in _attention_counts().items()}
    print(f"[smoke] internvl2 fixed batch (r): 4 x ({p0} patches + 512 text "
          f"tokens), {got.size} tokens in {seconds:.2f}s = "
          f"{got.size / seconds:.1f} tok/s, {static.host_syncs} host syncs; "
          f"launches {c}")
    require(c["flash_attention"] > 0 and c["plain"] == 0,
            f"wave (r): {c}")
    check_first_tokens(torch, model, cfg, list(batch), got[:, 0],
                       "internvl2 fixed batch (r)", patches=patches[:4])
    oracle_check(torch, np, model, cfg, list(batch), list(got),
                 "internvl2 fixed batch (r)", SPEC_ORACLE_MARGIN["fp16"],
                 patches=patches[:4])
    print(f"[smoke] internvl2-2b peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del static, model
    gc.collect()
    torch.cuda.empty_cache()


def reduced_phase(torch, np):
    """Reduced granite in f32: the legacy, unified and fixed-batch engines
    under kernel modes pallas and xla give one greedy stream, equal to the
    forward() full-recompute oracle."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.attention import ops
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
            n_plain = _attention_counts()["plain"]
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
        for kv_dtype in ("int8", "fp8"):
            quant_streams_agree(torch, np, base.replace(kv_dtype=kv_dtype),
                                prompts, gen)
    mamba2_streams_agree(torch, np, gen)


def mamba2_streams_agree(torch, np, gen):
    """Reduced mamba2 in f32 through the unified engine: kernel_mode pallas
    (the SSD kernel) and xla (the plain scan) serve the same greedy streams,
    equal to the forward() full-recompute oracle."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import scan as ssd_scan
    from repro_torch.models.model import build_model
    from repro_torch.serve.step import UnifiedServeEngine

    base = reduced(get_config("mamba2-370m"))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, base.vocab_size, (n,)).astype(np.int32)
               for n in (7, 16, 21, 30)]
    model = build_model(base, device="cuda", seed=0)
    streams = {}
    for mode in ("pallas", "xla"):
        eng = UnifiedServeEngine(base.replace(kernel_mode=mode), model,
                                 device="cuda", num_slots=2, max_len=48)
        ssd_ops.reset_counts()
        reqs = [eng.submit(p, gen) for p in prompts]
        out = eng.run()
        streams[mode] = [out[r.rid] for r in reqs]
        n_kernel = ssd_ops.ssd_scan.launches
        n_plain = ssd_scan.ssd_chunked_plain.calls
        require((n_kernel > 0 and n_plain == 0) if mode == "pallas"
                else (n_kernel == 0 and n_plain > 0),
                f"mamba2 {mode}: {n_kernel} kernel launches, {n_plain} plain calls")
    with torch.inference_mode():
        for p, a, b in zip(prompts, streams["pallas"], streams["xla"]):
            ctx = torch.tensor(p, device="cuda")[None]
            for _ in range(gen):
                nxt = model(ctx)[0, -1, :base.vocab_size].argmax()
                ctx = torch.cat([ctx, nxt.view(1, 1).to(ctx.dtype)], 1)
            o = ctx[0, len(p):].cpu().numpy()
            require(np.array_equal(a, b) and np.array_equal(a, o),
                    f"mamba2: pallas {a} / xla {b} / oracle {o}")
    print(f"[smoke] reduced mamba2 f32: unified greedy streams identical under "
          f"kernel_mode pallas / xla and the forward() oracle ({len(prompts)} "
          f"requests x {gen} tokens)")


def quant_streams_agree(torch, np, base, prompts, gen):
    """Reduced f32 over an int8/fp8 pool: the legacy and unified engines
    serve the same greedy streams under kernel_mode pallas (the quantized
    CUDA bodies) and xla (the plain dequant-gather path)."""
    from repro_torch.kernels.attention import ops
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ContinuousServeEngine
    from repro_torch.serve.step import UnifiedServeEngine

    model = build_model(base, device="cuda", seed=0)
    streams = {}
    for mode in ("pallas", "xla"):
        cfg = base.replace(kernel_mode=mode)
        for name, cls, kw in (("legacy", ContinuousServeEngine, {}),
                              ("unified", UnifiedServeEngine,
                               {"chunk_size": 8})):
            ops.reset_counts()
            eng = cls(cfg, model, device="cuda", num_slots=2, max_len=48,
                      block_size=16, **kw)
            reqs = [eng.submit(p, gen) for p in prompts]
            out = eng.run()
            streams[name, mode] = [out[r.rid] for r in reqs]
            quant = (ops.paged_attention.quant_launches
                     + ops.paged_span_attention.quant_launches)
            native = (ops.paged_attention.launches
                      + ops.paged_span_attention.launches)
            n_plain = _attention_counts()["plain"]
            require(native == 0 and ((quant > 0 and n_plain == 0)
                                     if mode == "pallas" else quant == 0),
                    f"{base.kv_dtype} {name} {mode}: {quant} quantized / "
                    f"{native} native launches, {n_plain} plain calls")
    for name in ("legacy", "unified"):
        for a, b in zip(streams[name, "pallas"], streams[name, "xla"]):
            require(np.array_equal(a, b),
                    f"{base.kv_dtype} window={base.attention_window} {name}: "
                    f"pallas {a} != xla {b}")
    print(f"[smoke] reduced granite f32 {base.kv_dtype} pool window="
          f"{base.attention_window}: legacy and unified greedy streams "
          f"identical under kernel_mode pallas / xla ({len(prompts)} requests "
          f"x {gen} tokens)")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("[smoke] FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import flash, paged
    from repro_torch.kernels.ssd_scan import scan as ssd_scan

    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    print(f"[smoke] card: {card}")
    print(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"capability {cap[0]}.{cap[1]}, {torch.cuda.device_count()} device(s)")
    require(cap[0] == 9, f"compute capability {cap} is not Hopper (9.x)")

    t0 = time.perf_counter()
    for built in build.load_all([paged.SOURCE, flash.SOURCE, ssd_scan.SOURCE]):
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", built.log)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                             built.log) if int(b)]
        print(f"[smoke] built {built.path.name} in {built.seconds:.1f}s; "
              f"ptxas: {len(regs)} kernels, {min(regs, default=0)}-"
              f"{max(regs, default=0)} registers, {len(spills)} with spill "
              f"stores (max {max(spills, default=0)} bytes)")
        for kernel in ("paged_decode_kernel", *SSD_KERNELS):
            for args, n_regs, spill in ptxas_rows(built.log, kernel):
                print(f"[smoke] ptxas {kernel}{args}: {n_regs} registers, "
                      f"{spill} bytes spill stores")
    print(f"[smoke] build phase {time.perf_counter() - t0:.1f}s (parallel nvcc)")

    phase_s = {}

    def timed(name, phase):
        t = time.perf_counter()
        out = phase(torch, np)
        phase_s[name] = round(time.perf_counter() - t, 1)
        return out

    timings = timed("paged kernels", kernel_phase)
    timings.update(timed("quantized paged kernels", quant_kernel_phase))
    ratios = timed("paged span oracle", span_oracle_phase)
    timings["paged_span"]["oracle_ratio"] = ratios["fp16"]
    timings["paged_span_quant"]["oracle_ratio"] = ratios["int8"]
    for name, keys in timed("span verify rows", verify_rows_phase).items():
        timings[name].update(keys)
    ratios = timed("paged decode oracle", decode_oracle_phase)
    timings["paged_decode"]["oracle_ratio"] = ratios["fp16"]
    timings["paged_decode_quant"]["oracle_ratio"] = ratios["int8"]
    timings.update(timed("flash kernel", flash_phase))
    timings.update(timed("ssd scan kernel", ssd_phase))
    timed("hybrid / vlm kernel shapes", family_kernel_phase)
    launches = timed("full width", full_width_phase)
    timed("deepseek-moe", moe_phase)
    launches.update(timed("mamba2 wave", mamba2_wave))
    timed("recurrentgemma", hybrid_phase)
    timed("internvl2", vlm_phase)
    timed("reduced", reduced_phase)
    print(f"[smoke] phase wall seconds: {phase_s}")

    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=timings[name]["max_abs_err"],
                    ms=timings[name]["ms"], plain_ms=timings[name]["plain_ms"],
                    bound_ms=timings[name]["bound_ms"],
                    bound_by=timings[name]["bound_by"],
                    library_ms=timings[name]["library_ms"],
                    **{k: v for k, v in timings[name].items()
                       if k == "oracle_ratio" or k.startswith("verify")})
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
