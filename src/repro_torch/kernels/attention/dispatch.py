"""One dispatch point for the paged attention kernels.

Every paged attention call site asks :func:`resolve` which backend runs:
``cuda`` (the hand-written kernels in ``csrc/``) or ``torch`` (their plain
versions).  Modes keep the JAX package's names (``cfg.kernel_mode``,
overridable via ``REPRO_KERNEL_MODE``):

* ``auto`` (default) — the CUDA kernels for CUDA tensors, the plain torch
  path for CPU tensors;
* ``pallas`` — the CUDA kernels (the ops wrappers still take the plain
  path for a CPU tensor);
* ``xla`` — always the plain torch path.

There is no silent fallback on the card: a shape or dtype the kernels do
not take raises on CUDA unless the caller asked for ``xla``.  Engines log
per-variant dispatch counts (``stats["kernel_dispatch"]``) and emit
EV_KERNEL_VARIANT with the ``KERNEL_VARIANT_IDS`` value of what ran; the
ids are the JAX package's, ``cuda`` taking the old ``pallas`` entries.
"""
from __future__ import annotations

import dataclasses
import os

from repro_torch.kernels.attention.paged import HEAD_DIMS

MODES = ("auto", "pallas", "xla")
VARIANTS = ("paged_decode", "paged_span")
MODE_ENV = "REPRO_KERNEL_MODE"

# trace-event values for EV_KERNEL_VARIANT (0 is reserved: "no dispatch");
# the dense entries keep their ids for the flash kernel still to be ported
KERNEL_VARIANT_IDS = {
    "dense:torch": 1,
    "dense:cuda": 2,
    "paged_decode:torch": 3,
    "paged_decode:cuda": 4,
    "paged_span:torch": 5,
    "paged_span:cuda": 6,
}

_SUPPORTED_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class KernelDecision:
    variant: str  # paged_decode | paged_span
    backend: str  # cuda | torch
    reason: str = ""

    @property
    def tag(self) -> str:
        return f"{self.variant}:{self.backend}"

    @property
    def event_value(self) -> int:
        return KERNEL_VARIANT_IDS[self.tag]


def mode_from(cfg) -> str:
    """The effective kernel mode: env override first, then cfg.kernel_mode."""
    env = os.environ.get(MODE_ENV, "")
    if env:
        if env not in MODES:
            raise ValueError(f"{MODE_ENV}={env!r}: expected one of {MODES}")
        return env
    return cfg.kernel_mode


def resolve(mode: str, variant: str, *, head_dim: int, dtype: str,
            platform: str) -> KernelDecision:
    """Decide cuda-vs-torch for one call site.  ``platform`` is the device
    type of the tensors (``"cuda"`` or ``"cpu"``)."""
    if mode not in MODES:
        raise ValueError(f"kernel_mode {mode!r}: expected one of {MODES}")
    if variant not in VARIANTS:
        raise ValueError(f"kernel variant {variant!r}: expected one of {VARIANTS}")
    if mode == "xla":
        return KernelDecision(variant, "torch", "mode=xla")
    why = ""
    dtype = str(dtype).removeprefix("torch.")
    if dtype not in _SUPPORTED_DTYPES:
        why = f"dtype {dtype} unsupported"
    elif head_dim not in HEAD_DIMS:
        why = f"head_dim {head_dim} not lane-tileable"
    if why:
        if platform == "cuda":
            raise NotImplementedError(
                f"{variant}: {why}; the CUDA kernel cannot run it and there "
                f"is no silent fallback (set kernel_mode='xla')")
        return KernelDecision(variant, "torch", why)
    if mode == "auto" and platform != "cuda":
        return KernelDecision(variant, "torch", f"auto: {platform} has no CUDA")
    reason = "auto: cuda" if mode == "auto" else "mode=pallas"
    return KernelDecision(variant, "cuda", reason)


def engine_plan(cfg, *, platform: str) -> dict[str, KernelDecision]:
    """Resolve every variant once for an engine's config (used for the
    per-dispatch accounting)."""
    mode = mode_from(cfg)
    return {v: resolve(mode, v, head_dim=cfg.head_dim, dtype=cfg.dtype,
                       platform=platform)
            for v in VARIANTS}
