"""Torch port, the bf16 SSD scan body (kernel 4) on the CPU: its three
phases (chunk states, the state pass, the outputs) written in plain
torch at the kernel's chunk length, with the tensor cores' bf16 hi + lo
operands emulated (``t.bfloat16().float()`` and the rest) and float32
sums, held to the float64 recurrence (``ref.check_ratio``), to the plain
chunked scan and to the JAX package's scan kernel in interpret mode; and
the host plan (chunk count, P tile, padded N, workspace, shared memory)
against the source layout."""
from __future__ import annotations

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import ref, scan  # noqa: E402

SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on an H100


def _split(t):
    """t = hi + lo as two bf16-valued float32 tensors (the mma operands)."""
    hi = t.bfloat16().float()
    return hi, (t - hi).bfloat16().float()


def chunked_tc(x, dt, a_log, bmat, cmat, split=_split):
    """The bf16 body's computation in plain torch, chunk ``scan.CHUNK``:
    A. Z = x dt exp(cum_L - cum_j) split into hi + lo, s_local = B^T Z_hi +
    B^T Z_lo and the chunk decay exp(cum_L); B. entering[c] = decay[c-1]
    entering[c-1] + s_local[c-1]; C. M = (C B^T) exp(cum_i - cum_j) dt_j on
    the lower triangle (selection), y = M_hi x + M_lo x + exp(cum_i)
    (C state_hi + C state_lo), rounded once to bf16.  Rows past S are
    dt = 0 identity steps.  Returns (y bf16, final state float32)."""
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    ln = scan.CHUNK
    nc = -(-s // ln)
    pad = nc * ln - s
    f = lambda t, *sh: torch.nn.functional.pad(t.float(), sh).reshape(
        b, nc, ln, *t.shape[2:])
    xf = f(x, 0, 0, 0, 0, 0, pad)  # [b, nc, L, h, p]
    dtf = f(dt, 0, 0, 0, pad)  # [b, nc, L, h]
    heads = torch.arange(h) // (h // g)  # head -> group, by index
    bf = f(bmat, 0, 0, 0, 0, 0, pad)[:, :, :, heads]  # [b, nc, L, h, n]
    cf = f(cmat, 0, 0, 0, 0, 0, pad)[:, :, :, heads]
    cum = torch.cumsum(dtf * -torch.exp(a_log.float()), dim=2)
    cum_l = cum[:, :, -1:]  # [b, nc, 1, h]

    # A. chunk-local states
    zh, zl = split(xf * (dtf * torch.exp((cum_l - cum).clamp(max=0)))[..., None])
    s_local = (torch.einsum("bcjhn,bcjhp->bchnp", bf, zh)
               + torch.einsum("bcjhn,bcjhp->bchnp", bf, zl))
    decay = torch.exp(cum_l[:, :, 0].clamp(max=0))  # [b, nc, h]

    # B. the state pass, in the order of the recurrence
    state = torch.zeros((b, h, n, p))
    entering = []
    for c in range(nc):
        entering.append(state)
        state = decay[:, c, :, None, None] * state + s_local[:, c]
    entering = torch.stack(entering, 1)  # [b, nc, h, n, p]

    # C. outputs
    cb = torch.einsum("bcihn,bcjhn->bchij", cf, bf)
    cum_t = cum.movedim(3, 2)  # [b, nc, h, L]
    tril = torch.ones((ln, ln), dtype=torch.bool).tril()
    m = torch.where(tril, cb * torch.exp(cum_t[..., :, None] - cum_t[..., None, :])
                    * dtf.movedim(3, 2)[..., None, :], 0.0)
    mh, ml = split(m)
    y = (torch.einsum("bchij,bcjhp->bcihp", mh, xf)
         + torch.einsum("bchij,bcjhp->bcihp", ml, xf))
    sh, sl = split(entering)
    y_off = (torch.einsum("bcihn,bchnp->bcihp", cf, sh)
             + torch.einsum("bcihn,bchnp->bcihp", cf, sl))
    y = y + torch.exp(cum)[..., None] * y_off
    return y.reshape(b, nc * ln, h, p)[:, :s].bfloat16(), state


def _inputs(b, s, h, p, n, g, *, seed, dt_max=None, a_max=16.0):
    """bf16-valued x/B/C (normal, rounded) and float32 dt and a_log as the
    model's inits draw them (dt log-uniform in [1e-3, 0.1], A ~ U[1,
    a_max]) or, with ``dt_max``, dt ~ U[0, dt_max]."""
    rng = np.random.default_rng(seed)
    bf = lambda *sh: torch.from_numpy(
        rng.standard_normal(sh).astype(np.float32)).bfloat16()
    x, bm, cm = bf(b, s, h, p), bf(b, s, g, n), bf(b, s, g, n)
    if dt_max is None:
        dt = np.exp(rng.uniform(math.log(1e-3), math.log(0.1), (b, s, h)))
    else:
        dt = rng.uniform(0.0, dt_max, (b, s, h))
    a_log = np.log(rng.uniform(1.0, a_max, h))
    return (x, torch.from_numpy(dt.astype(np.float32)),
            torch.from_numpy(a_log.astype(np.float32)), bm, cm)


# b, s, h, p, n, g, dt_max
CASES = {
    "ragged": (1, 200, 4, 64, 128, 1, None),
    "S<64": (2, 40, 4, 32, 32, 1, None),
    "S1": (1, 1, 4, 64, 128, 1, None),
    "g2": (1, 100, 4, 32, 16, 2, None),
    "g4-n8-p16": (2, 64, 8, 16, 8, 4, None),
    "n16": (1, 130, 2, 32, 16, 1, None),
    "overflow": (1, 300, 2, 64, 128, 1, 3.0),
    "b4": (4, 150, 2, 64, 64, 1, None),
}


@pytest.fixture(scope="module", params=list(CASES), ids=list(CASES))
def case(request):
    b, s, h, p, n, g, dt_max = CASES[request.param]
    inputs = _inputs(b, s, h, p, n, g, seed=len(request.param), dt_max=dt_max)
    return request.param, inputs, chunked_tc(*inputs)


def test_chunks_hold_to_f64_oracle(case):
    """y (bf16) and the final state (float32) within the kernel's check."""
    _, inputs, (y, state) = case
    ry, rstate = ref.ssd_sequential_ref(*inputs)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(state).all()
    assert ref.check_ratio(y, ry) <= 1.0
    assert ref.check_ratio(state, rstate) <= 1.0


def test_chunks_match_plain_chunked_scan(case):
    """The plain scan over the same (bf16-valued) inputs in float32, at the
    config's chunk of 256: y within the bf16 check, the state within the
    float32 one."""
    _, (x, dt, a_log, bm, cm), (y, state) = case
    py, pstate = scan.ssd_chunked_plain(x.float(), dt, a_log, bm.float(),
                                        cm.float(), 256)
    assert ref.check_ratio(y, py) <= 1.0
    assert ref.check_ratio(state, pstate) <= 1.0


@pytest.mark.parametrize("name", ["ragged", "S1", "g4-n8-p16", "overflow"])
def test_chunks_match_jax_scan_kernel(name):
    """The JAX package's Pallas scan (interpret mode) on the same values."""
    b, s, h, p, n, g, dt_max = CASES[name]
    x, dt, a_log, bm, cm = _inputs(b, s, h, p, n, g, seed=len(name),
                                   dt_max=dt_max)
    y, state = chunked_tc(x, dt, a_log, bm, cm)
    arrays = [jnp.asarray(t.float().numpy()) for t in (x, dt, a_log, bm, cm)]
    jy, jstate = jax_ssd_scan(*arrays, chunk=64, interpret=True)
    assert ref.check_ratio(y, torch.from_numpy(np.array(jy))) <= 1.0
    assert ref.check_ratio(state, torch.from_numpy(
        np.array(jstate)).reshape(state.shape)) <= 1.0


def test_one_bf16_pass_fails_the_check():
    """Why the split: the same phases with Z, M and the entering state
    each rounded to one bf16 operand fall outside the check."""
    x, dt, a_log, bm, cm = _inputs(*CASES["overflow"][:6], seed=8, dt_max=3.0)
    ry, rstate = ref.ssd_sequential_ref(x, dt, a_log, bm, cm)
    y, state = chunked_tc(x, dt, a_log, bm, cm,
                          split=lambda t: (t.bfloat16().float(), 0.0 * t))
    assert max(ref.check_ratio(y, ry), ref.check_ratio(state, rstate)) > 1.0


def _source_constants():
    text = scan.SOURCE.read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def test_plan_constants_match_the_source():
    k = _source_constants()
    assert (k["kL"], k["kPad"], k["kPT"], k["kMaxN"]) == (
        scan.CHUNK, scan.ROW_PAD, scan.P_TILE, scan.MAX_STATE)
    # an output CTA holds one or two warps for each 16 rows of the chunk
    warps, tiles = k["kOutThreads"] // 32, scan.CHUNK // 16
    assert warps % tiles == 0 and warps // tiles in (1, 2)


@pytest.mark.parametrize("b,s,h,p,n,chunks,p_tile,n_pad", [
    (1, 512, 32, 64, 128, 8, 64, 128),  # mamba2-370m, the timed shape
    (1, 2560, 32, 64, 128, 40, 64, 128),
    (4, 300, 32, 64, 128, 5, 64, 128),
    (1, 1, 32, 64, 128, 1, 64, 128),
    (1, 17, 4, 32, 16, 1, 32, 16),
    (2, 64, 8, 16, 8, 1, 16, 16),
    (1, 100, 2, 48, 24, 2, 16, 32),
    (1, 65, 2, 96, 256, 2, 32, 256),
    (1, 0, 2, 64, 128, 0, 64, 128),
])
def test_scan_plan(b, s, h, p, n, chunks, p_tile, n_pad):
    """Chunks, P tile and padded N from the shapes; the workspace holds B
    nc H N P states then B H nc decays; shared memory as the source lays
    it out (bf16 rows of padded width + kPad, dt and cum in f32), within
    the card's limit at every N the launcher takes."""
    plan = scan.scan_plan(b, s, h, p, n)
    assert (plan.chunks, plan.p_tile, plan.n_pad) == (chunks, p_tile, n_pad)
    assert p % plan.p_tile == 0 and plan.p_tile in scan.BF16_P_TILES
    assert plan.workspace == b * chunks * h * n * p + b * h * chunks
    row_n, row_p = (n_pad + scan.ROW_PAD) * 2, (p_tile + scan.ROW_PAD) * 2
    cum = 2 * 4 * scan.CHUNK
    assert plan.smem_state == scan.CHUNK * row_n + 2 * scan.CHUNK * row_p + cum
    assert plan.smem_out == (2 * scan.CHUNK * row_n + scan.CHUNK * row_p
                             + 2 * n_pad * row_p + scan.CHUNK * 2 * row_p + cum)
    for nbytes in (row_n, row_p, scan.CHUNK * row_n, n_pad * row_p):
        assert nbytes % 16 == 0  # every array 16-byte aligned
    # ldmatrix: 8 consecutive rows on 8 distinct 16-byte bank groups
    for row in (row_n, row_p):
        assert len({r * row % 128 // 16 for r in range(8)}) == 8
    assert plan.smem_out <= SMEM_LIMIT and plan.smem_state <= SMEM_LIMIT


def test_widest_plan_fits_the_card():
    plan = scan.scan_plan(1, 64, 1, 64, scan.MAX_STATE)
    assert plan.smem_out == 169_472 <= SMEM_LIMIT


def test_launcher_contract_unchanged_on_the_cpu():
    """The plan adds no argument: the launcher still checks the device
    first, and the wrapper takes the plain path for a CPU tensor."""
    inputs = _inputs(1, 8, 2, 16, 8, 1, seed=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        scan.ssd_scan_fwd(*inputs)
    assert scan.unsupported(inputs[0], inputs[3]) == ""
