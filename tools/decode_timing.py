#!/usr/bin/env python3
"""Time the paged-decode kernel (kernels 1/1q) on one GPU, at the main
path's timed shape: 4 slots at positions 200..543 (the inputs of
``chip_smoke.py``'s timed decode case), granite-8b's Hq 32 / Hkv 8, D 128,
block 16, bf16 q, over a native bf16 pool and the same pool as int8 and
fp8 codes with f32 scales.

    python3 tools/decode_timing.py [--src DIR] [--label NAME]

``--src`` names the source tree whose ``repro_torch`` is timed (default:
this checkout's ``src``), so one command can time an older tree's kernel
beside this one's on the same card, with the same inputs and the same
clock (``chip_smoke.time_ms``: CUDA events around each launch, L2
flushed before it).  A tree whose ``paged_decode_fwd`` takes ``splits``
is also timed at each forced count of ``SPLIT_COUNTS``;
every slot at position 0 (one block each) shows the cost that does not
scale with the blocks a CTA walks.
``--build-only`` builds the tree's paged kernels and prints the registers
and spill stores ``ptxas`` reports for every decode instantiation.

Prints the card line, then one JSON object a line:
``{"label", "pool", "splits", "ms"}`` per timing and ``{"label", "pool",
"sdpa_ms", "bound_ms"}`` for the yardsticks.
"""
from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPLIT_COUNTS = (1, 4, 5, 8, 10, 16)  # forced key splits, beside the plan's


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("decode_timing: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # the shared timing, inputs and bound

    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.core import quant
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import paged

    print(f"[decode_timing] {args.label}: card {cs.card_line()}; paged from "
          f"{paged.__file__}")
    if args.build_only:
        built = build.load(paged.SOURCE)
        print(f"[decode_timing] {args.label}: built in {built.seconds:.1f}s")
        for targs, regs, spill in cs.ptxas_rows(built.log, "paged_decode_kernel"):
            print(json.dumps({"label": args.label, "kernel": targs,
                              "registers": regs, "spill_stores": spill}))
        return 0

    rng = np.random.default_rng(0)  # chip_smoke.kernel_phase's timed case
    starts = [int(x) for x in rng.integers(200, 544, 4)]
    shape = dict(hkv=8, g=4, d=128, bs=16, w=34, nb=4096)
    q, kp, vp, bt, st, _ = cs._case(torch, rng, torch.bfloat16, b=4, q_len=1,
                                    starts=starts, lens=[1] * 4, **shape)
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    takes_splits = "splits" in inspect.signature(paged.paged_decode_fwd).parameters
    plan = (paged.decode_split_plan(4, 8, 34, torch.cuda.get_device_properties(0)
                                    .multi_processor_count)
            if hasattr(paged, "decode_split_plan") else 1)
    for pool in ("fp16", "int8", "fp8"):
        k, v, sc = kp, vp, {}
        if pool != "fp16":
            k, ks = quant.kv_quantize(kp, pool)
            v, vs = quant.kv_quantize(vp, pool)
            sc = {"k_scales": ks, "v_scales": vs}
        counts = [None]
        if takes_splits:
            counts += [n for n in SPLIT_COUNTS if n != plan]
        for n in counts:
            kw = dict(sc) if n is None else dict(sc, splits=n)
            ms = cs.time_ms(torch, lambda: paged.paged_decode_fwd(q, k, v, bt, st,
                                                                  **kw), flush)
            print(json.dumps({"label": args.label, "pool": pool,
                              "splits": plan if n is None else n,
                              "planned": n is None, "ms": ms}))
        kd, vd = k, v
        if pool != "fp16":
            kd = quant.kv_dequantize(k, sc["k_scales"], torch.bfloat16)
            vd = quant.kv_dequantize(v, sc["v_scales"], torch.bfloat16)
        sdpa = cs.time_ms(torch, cs.sdpa_yardstick(torch, q, kd, vd, bt, starts,
                                                   1, None), flush)
        bound = cs.bound_ms("bfloat16", q, k, bt, starts, [1] * 4, None, g=4,
                            quantized=pool != "fp16")
        print(json.dumps({"label": args.label, "pool": pool, "sdpa_ms": sdpa,
                          "bound_ms": bound[0]}))
    # the cost that does not scale with the blocks walked: every slot at
    # position 0 (one block), one split (no merge) against two (a merge)
    zero = torch.zeros_like(st)
    for n in ([None, 1, 2] if takes_splits else [None]):
        kw = {} if n is None else {"splits": n}
        ms = cs.time_ms(torch, lambda: paged.paged_decode_fwd(q, kp, vp, bt, zero,
                                                              **kw), flush)
        print(json.dumps({"label": args.label, "pool": "fp16",
                          "case": "4 slots at position 0",
                          "splits": plan if n is None else n, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
