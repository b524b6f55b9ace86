#!/usr/bin/env python3
"""Experiment copies of the SSD scan's bf16 body, for timing what each
part of it costs on the card with ``tools/ssd_timing.py``.

    python3 tools/ssd_variants.py OUT [NAME ...]
    python3 tools/ssd_timing.py --src OUT/NAME/src --label NAME

Each variant is this checkout's ``src/repro_torch`` copied to
``OUT/NAME/src/repro_torch`` with one edit of ``ssd_scan.cu``; no edit
touches the f32 body.  Variants that stop early or skip work compute
wrong outputs and are for timing only.  OUT belongs in a directory that
``.gitignore`` lists (``chiprun_work/``).
"""
from __future__ import annotations

import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCE = "kernels/ssd_scan/csrc/ssd_scan.cu"
_A_ONLY = ("  const int npq = N * P / 4;\n", "  return err;\n  const int npq = N * P / 4;\n")
_NO_STORE = [("      if (na < N)\n", "      if (na < 0)\n"),
             ("      if (nb < N)\n", "      if (nb < 0)\n")]
VARIANTS = {
    # the launches: no programmatic dependents; phase A alone; A and B
    "no_pdl": [("  cfg.numAttrs = 1;\n  return cudaLaunchKernelEx(&cfg, kernel, args...);",
                "  cfg.numAttrs = 0;\n  return cudaLaunchKernelEx(&cfg, kernel, args...);")],
    "a_only": [_A_ONLY],
    "a_only_no_store": [_A_ONLY, *_NO_STORE],
    "a_only_no_mma": [_A_ONLY, *_NO_STORE,
                      ("  const int ksteps = (lc + 15) / 16;", "  const int ksteps = 0;")],
    "ab": [("  if (err != cudaSuccess || nc == 0) return err;\n", "  return err;\n")],
    # phase C without the state product, or without S and the diagonal block
    "c_no_state": [("  if (c > 0) {  // CTA-uniform", "  if (c < 0) {  // CTA-uniform")],
    "c_no_diag": [
        ("  for (int kk = 0; kk < NP / 16; ++kk) {\n    uint32_t af[4];\n    ldsm_x4(cs",
         "  for (int kk = 0; kk < 0; ++kk) {\n    uint32_t af[4];\n    ldsm_x4(cs"),
        ("  for (int jp = 0; jp < 4; ++jp) {\n    if (jp > mt) break;\n    if (jp % kHalves",
         "  for (int jp = 0; jp < 0; ++jp) {\n    if (jp > mt) break;\n    if (jp % kHalves")],
    # the shapes this tree did not take
    "a_8_warps": [("constexpr int kStateThreads = 128;", "constexpr int kStateThreads = 256;")],
    "c_4_warps": [("constexpr int kOutThreads = 256;", "constexpr int kOutThreads = 128;")],
    "b_4_loads": [("constexpr int kPassChunks = 8;", "constexpr int kPassChunks = 4;")],
    "no_unroll": [("#pragma unroll\n    for (int kk = 0; kk < kL / 16; ++kk) {",
                   "    for (int kk = 0; kk < kL / 16; ++kk) {"),
                  ("#pragma unroll 4\n  for (int kk = 0; kk < NP / 16; ++kk) {",
                   "  for (int kk = 0; kk < NP / 16; ++kk) {"),
                  ("#pragma unroll 4\n    for (int kk = half;", "    for (int kk = half;")],
}


def make(out: pathlib.Path, name: str) -> pathlib.Path:
    """Write variant ``name`` under ``out``; returns its ``src``."""
    dst = out / name / "src" / "repro_torch"
    shutil.rmtree(dst.parent.parent, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = dst / SOURCE
    text = path.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the source no longer has {old!r} once")
        text = text.replace(old, new)
    path.write_text(text)
    return dst.parent


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    out = pathlib.Path(sys.argv[1]).resolve()
    for name in sys.argv[2:] or VARIANTS:
        print(f"[ssd_variants] {name}: {make(out, name)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
