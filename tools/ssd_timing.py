#!/usr/bin/env python3
"""Time the SSD scan kernel (kernel 4) on one GPU at mamba2-370m's widths
(H 32, P 64, N 128, G 1), bf16, one sequence (B 1): the timed shape S 512
(``chip_smoke.py``'s timed row, wave (f)'s longest prompt), and S 200 and
2560 beside it.

    python3 tools/ssd_timing.py [--src DIR] [--label NAME] [--build-only | --profile]

``--src`` names the source tree whose ``repro_torch`` is timed (default:
this checkout's ``src``), so one command can time an older tree's kernel
beside this one's on the same card, with the same inputs and the same
clock (``chip_smoke.time_ms``: CUDA events around each launch, L2
flushed before it); run it as parent, this tree, this tree, parent.
``tools/ssd_variants.py`` writes experiment copies of this tree's kernel
for ``--src``.
``--build-only`` builds the tree's SSD library and prints the registers
and spill stores ``ptxas`` reports for every SSD kernel (only in the
process that builds: a cached library has no log).  ``--profile`` adds,
per shape, each kernel's mean device time a scan under ``torch.profiler``
(L2 flushed before each scan; a programmatic dependent's time includes
its wait for the kernel before it).

Prints the card line, then one JSON object a line: ``{"label",
"baseline", "ms"}`` for a 4-byte ``zero_`` (the fixed cost of any
L2-flushed launch on this clock), ``{"label", "S", "ms", "bound_ms"}``
per shape, with ``--profile`` also
``{"label", "S", "kernel", "us"}`` per kernel, or with ``--build-only``
``{"label", "kernel", "registers", "spill_stores"}`` per kernel.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
LENGTHS = (512, 200, 2560)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ssd_timing: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # the shared timing, inputs and bound

    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import scan

    print(f"[ssd_timing] {args.label}: card {cs.card_line()}; scan from "
          f"{scan.__file__}")
    built = build.load(scan.SOURCE)
    if args.build_only:
        print(f"[ssd_timing] {args.label}: built in {built.seconds:.1f}s")
        for kernel in cs.SSD_KERNELS:
            for targs, regs, spill in cs.ptxas_rows(built.log, kernel):
                print(json.dumps({"label": args.label, "kernel": kernel + targs,
                                  "registers": regs, "spill_stores": spill}))
        return 0

    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    # the fixed cost of any L2-flushed launch on this clock: a 4-byte zero_
    tiny = torch.empty(1, device="cuda")
    print(json.dumps({"label": args.label, "baseline": "4-byte zero_",
                      "ms": cs.time_ms(torch, tiny.zero_, flush_buf.zero_)}))
    for s in LENGTHS:
        x, dt, a_log, bm, cm = cs.ssd_inputs(torch, torch.bfloat16, 1, s,
                                             seed=99)
        y, state = scan.ssd_scan_fwd(x, dt, a_log, bm, cm)
        ms = cs.time_ms(torch, lambda: scan.ssd_scan_fwd(x, dt, a_log, bm, cm),
                        flush_buf.zero_)
        bound, by = cs.ssd_bound_ms("bfloat16", x, dt, a_log, bm, cm, y, state,
                                    256)
        print(json.dumps({"label": args.label, "S": s, "ms": ms,
                          "bound_ms": bound, "bound_by": by}))
        if args.profile:
            for name, us in profile(torch, lambda: scan.ssd_scan_fwd(
                    x, dt, a_log, bm, cm), flush_buf.zero_):
                print(json.dumps({"label": args.label, "S": s, "kernel": name,
                                  "us": us}))
    return 0


def profile(torch, fn, flush, iters=20):
    """[(kernel, mean device us a call)] of the SSD kernels ``fn`` runs."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush()
            fn()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        m = re.search(r"ssd_\w+(<\d+>)?", evt.key)
        if m:
            rows.append((m.group(0), evt.self_device_time_total / iters))
    return rows


if __name__ == "__main__":
    sys.exit(main())
