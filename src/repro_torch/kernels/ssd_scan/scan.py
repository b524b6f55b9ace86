"""The Mamba-2 SSD chunked scan: the hand-written CUDA kernel
(``csrc/ssd_scan.cu``) and, beside it, its plain torch version.

Both take the model layout: x ``[B, S, H, P]``, dt ``[B, S, H]`` float32
after the softplus, a_log ``[H]`` float32, B and C ``[B, S, G, N]`` with
head ``h`` reading group ``h // (H // G)``; both return y ``[B, S, H, P]``
in x's dtype and the final state ``[B, H, N, P]`` in float32, from a zero
initial state (the only way the model calls the scan).

* :func:`ssd_chunked_plain` ports ``repro.models.ssm.ssd_chunked``: the
  chunked SSD algorithm at the config's chunk length, in float32, the
  decay built only on the lower triangle by selection.  It is the CPU
  path and the version the kernel is held against on the card.
* :func:`ssd_scan_fwd` launches the kernel on CUDA tensors only and
  raises on anything it does not take.  It reads every input in place
  through its strides (unit stride on P and N, 16-byte aligned rows): no
  group expansion, padding or transpose.  The kernel picks its own chunk
  length (64); the chunked algorithm computes the same function for every
  chunk length, up to float32 rounding.  bf16 runs the tensor-core body
  (three kernels: chunk states, a state pass, the outputs) over a float32
  workspace that :func:`scan_plan` sizes from the shapes alone; float32
  runs the CUDA-core body, which needs none.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
_DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
P_TILE = 16  # state columns per CTA (kPT in the source)
MAX_STATE = 256  # largest N (kMaxN in the source)
CHUNK = 64  # the kernels' chunk length (kL in the source)
BF16_P_TILES = (64, 32, 16)  # the bf16 body's P tiles, widest first
ROW_PAD = 8  # bf16 elements padding a shared-memory row (kPad)


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """The bf16 body's launch plan for one scan, from shapes alone."""
    chunks: int  # nc = ceil(S / CHUNK)
    p_tile: int  # P columns a CTA (the widest of BF16_P_TILES dividing P)
    n_pad: int  # N rounded up to the mma depth (16)
    workspace: int  # float32 elements: B nc H N P states, B H nc decays
    smem_state: int  # dynamic shared bytes of a chunk-state CTA
    smem_out: int  # dynamic shared bytes of an output CTA (+ f32 partial y)


def scan_plan(b: int, s: int, h: int, p: int, n: int) -> ScanPlan:
    """Chunk count, P tile, padded N, workspace and shared memory of the
    bf16 body (``chunk_state_smem`` / ``chunk_out_smem`` in the source)."""
    nc = -(-s // CHUNK)
    pt = next(t for t in BF16_P_TILES if p % t == 0)
    npad = -(-n // 16) * 16
    ld_n, ld_p = npad + ROW_PAD, pt + ROW_PAD
    cum = 2 * 4 * CHUNK  # dt and cum, f32
    return ScanPlan(
        chunks=nc, p_tile=pt, n_pad=npad,
        workspace=b * nc * h * n * p + b * h * nc,
        smem_state=2 * (CHUNK * ld_n + 2 * CHUNK * ld_p) + cum,
        smem_out=2 * (2 * CHUNK * ld_n + CHUNK * ld_p + 2 * npad * ld_p)
        + 4 * CHUNK * ld_p + cum)


def ssd_chunked_plain(x, dt, a_log, bmat, cmat, chunk: int):
    """The chunked SSD scan in float32 (see the module docstring)."""
    ssd_chunked_plain.calls += 1
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    hg = h // g
    pad = (-s) % chunk
    if pad:  # dt = 0 rows are identity steps
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
    nc, l = (s + pad) // chunk, chunk
    xr = x.reshape(b, nc, l, g, hg, p)
    dtr = dt.reshape(b, nc, l, g, hg).float()
    br = bmat.reshape(b, nc, l, g, n).float()
    cr = cmat.reshape(b, nc, l, g, n).float()
    a = -torch.exp(a_log.float()).reshape(g, hg)

    cum = torch.cumsum(dtr * a, dim=2)  # [b, nc, l, g, hg], inclusive
    cum_t = cum.movedim(2, -1)  # [b, nc, g, hg, l]
    # decay L[i, j] = exp(cum_i - cum_j) for j <= i; exp may overflow to
    # inf above the diagonal, which the selection drops (no inf * 0)
    tril = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    ldec = torch.where(tril, torch.exp(cum_t[..., :, None] - cum_t[..., None, :]),
                       0.0)  # [b, nc, g, hg, l, l]
    xdt = xr.float() * dtr[..., None]  # [b, nc, l, g, hg, p]
    cb = torch.einsum("bcign,bcjgn->bcgij", cr, br)  # [b, nc, g, l, l]
    y_diag = torch.einsum("bcgeij,bcjgep->bcigep", cb[:, :, :, None] * ldec, xdt)

    # per-chunk local final states, then the recurrence over chunks
    decay_last = torch.exp(cum_t[..., -1:] - cum_t)  # [b, nc, g, hg, l]
    s_local = torch.einsum("bcjgn,bcjgep->bcgenp", br,
                           xdt * decay_last.movedim(-1, 2)[..., None])
    chunk_decay = torch.exp(cum_t[..., -1])  # [b, nc, g, hg]
    state = torch.zeros((b, g, hg, n, p), dtype=torch.float32, device=x.device)
    entering = []  # the state entering each chunk
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, ..., None, None] + s_local[:, c]
    y_off = torch.einsum("bcign,bcgenp->bcigep", cr, torch.stack(entering, 1)) \
        * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(b, s + pad, h, p)[:, :s]
    return y.to(x.dtype), state.reshape(b, h, n, p)


ssd_chunked_plain.calls = 0


# ----------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE).lib
    lib.ssd_scan_launch.argtypes = [_P] * 7 + [_I] * 7 + [_L] * 12 + [_P, _I, _P]
    lib.ssd_scan_launch.restype = _I
    return lib


def build_kernels() -> build.Built:
    """Compile (first use) and load the SSD scan library."""
    _lib()
    return build.load(SOURCE)


def unsupported(x, bmat) -> str:
    """Why the kernel cannot take a scan of these shapes and dtype ("" if
    it can); the device is not looked at."""
    h, p = x.shape[2], x.shape[3]
    g, n = bmat.shape[2], bmat.shape[3]
    if x.dtype not in _DTYPE_IDS:
        return f"dtype {x.dtype} unsupported (float32, bfloat16)"
    if p % P_TILE:
        return f"head dim P {p} is not a multiple of {P_TILE}"
    if n % 8 or not 8 <= n <= MAX_STATE:
        return f"state size N {n} is not a multiple of 8 in [8, {MAX_STATE}]"
    if g < 1 or h % g:
        return f"heads {h} not a multiple of groups {g}"
    return ""


def _check(x, dt, a_log, bmat, cmat):
    if not x.is_cuda:
        raise ValueError("the CUDA SSD scan kernel takes CUDA tensors")
    if x.dim() != 4 or bmat.dim() != 4 or bmat.shape != cmat.shape:
        raise ValueError(f"x must be [B, S, H, P] and B/C [B, S, G, N], got "
                         f"{tuple(x.shape)} / {tuple(bmat.shape)} / "
                         f"{tuple(cmat.shape)}")
    b, s, h, _ = x.shape
    if bmat.shape[:2] != (b, s) or dt.shape != (b, s, h) or a_log.shape != (h,):
        raise ValueError(f"dt {tuple(dt.shape)}, a_log {tuple(a_log.shape)} and "
                         f"B/C {tuple(bmat.shape)} do not match x {tuple(x.shape)}")
    why = unsupported(x, bmat)
    if why:
        raise ValueError(why)
    for name, t in (("dt", dt), ("a_log", a_log), ("B", bmat), ("C", cmat)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("B", bmat), ("C", cmat)):
        if t.dtype != x.dtype:
            raise ValueError(f"{name} dtype {t.dtype} differs from x's {x.dtype}")
    for name, t in (("dt", dt), ("a_log", a_log)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not a_log.is_contiguous():
        raise ValueError("a_log must be contiguous")
    vec = 16 // x.element_size()  # elements a 16-byte load
    for name, t in (("x", x), ("B", bmat), ("C", cmat)):
        if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a unit stride on its last dim, "
                             f"strides that are multiples of {vec} and "
                             f"16-byte alignment")


def ssd_scan_fwd(x, dt, a_log, bmat, cmat):
    """Launch the CUDA SSD scan on the current stream.  Returns
    (y [B, S, H, P] in x's dtype, final state [B, H, N, P] float32)."""
    _check(x, dt, a_log, bmat, cmat)
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    ws, p_tile = None, 0
    if x.dtype == torch.bfloat16:
        plan = scan_plan(b, s, h, p, n)
        ws = torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
        p_tile = plan.p_tile
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), bmat.data_ptr(),
        cmat.data_ptr(), y.data_ptr(), state.data_ptr(), _DTYPE_IDS[x.dtype],
        b, s, h, p, g, n, *x.stride()[:3], *dt.stride(), *bmat.stride()[:3],
        *cmat.stride()[:3], None if ws is None else ws.data_ptr(), p_tile,
        stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {rc}")
    return y, state
