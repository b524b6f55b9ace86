"""Model-layout wrapper of the SSD scan: the kernel or its plain version.

The public signature is the model's (``repro.models.ssm.ssd_chunked``):
x ``[B, S, H, P]``, dt ``[B, S, H]``, a_log ``[H]``, B/C ``[B, S, G, N]``
-> (y ``[B, S, H, P]``, final state ``[B, H, N, P]`` float32).  Unlike the
JAX wrapper (``repro.kernels.ssd_scan.ops.ssd_scan``), nothing is
expanded per head, padded or transposed: the kernel reads the model
layout in place and each head's group by index.

``mode`` takes ``cfg.kernel_mode``'s names (``REPRO_KERNEL_MODE``
overrides it, as for attention): ``xla`` always runs the plain version;
``auto`` and ``pallas`` launch the CUDA kernel on a CUDA tensor and take
the plain version for a CPU tensor — the only case in which they do.  On
a CUDA tensor the kernel launches or the call raises: a shape or dtype
it does not take raises ``NotImplementedError`` unless the caller asked
for ``xla``.  ``ssd_scan.launches`` counts kernel launches;
``scan.ssd_chunked_plain.calls`` counts plain calls.  No trace event is
stamped: the JAX engine stamps ``EV_KERNEL_VARIANT`` for attention only.
"""
from __future__ import annotations

from repro_torch.kernels.attention.dispatch import MODES
from repro_torch.kernels.ssd_scan import scan


def backend(mode: str, x, bmat) -> str:
    """"cuda" (the kernel) or "torch" (the plain version) for one call."""
    if mode not in MODES:
        raise ValueError(f"kernel_mode {mode!r}: expected one of {MODES}")
    if mode == "xla" or not x.is_cuda:
        return "torch"
    why = scan.unsupported(x, bmat)
    if why:
        raise NotImplementedError(
            f"ssd_scan: {why}; the CUDA kernel cannot run it and there is "
            f"no silent fallback (set kernel_mode='xla')")
    return "cuda"


def ssd_scan(x, dt, a_log, bmat, cmat, *, chunk: int, mode: str = "auto"):
    """SSD scan from a zero state.  ``chunk`` is the plain version's chunk
    length (the kernel picks its own)."""
    if backend(mode, x, bmat) == "torch":
        return scan.ssd_chunked_plain(x, dt, a_log, bmat, cmat, chunk)
    out = scan.ssd_scan_fwd(x, dt, a_log, bmat, cmat)
    ssd_scan.launches += 1
    return out


def reset_counts() -> None:
    """Zero the kernel launch count and the plain-path call count."""
    ssd_scan.launches = 0
    scan.ssd_chunked_plain.calls = 0


reset_counts()
