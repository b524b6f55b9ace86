"""Torch port, the RG-LRU block (``repro_torch.models.rglru``) on the CPU,
against the JAX package's ``repro.models.rglru`` on the same seeded
numpy inputs and on the weights of a reduced recurrentgemma-9b
(``model.init(PRNGKey(0))`` through ``convert.params_from_jax``), and
against a float64 sequential recurrence.

The port's scan is chunked (``RG_CHUNK`` tokens a chunk, the state
carried across chunks); the JAX one is an ``associative_scan``.  Both
run in float32, so they agree to float32 rounding (``TOL``)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import rglru as jax_rglru  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import convert, rglru  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

TOL = 1e-5  # float32, a different order of operations (abs and rel)
ORACLE_TOL = 2e-5  # float32 scan vs the float64 recurrence


@pytest.fixture(scope="module")
def pair():
    """Layer 0 (a rec layer) of reduced recurrentgemma-9b, JAX and port,
    on the same weights; the gate and conv biases drawn non-zero, so the
    gates differ per channel."""
    jcfg = jax_reduced(jax_get_config("recurrentgemma-9b"), num_layers=5)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: np.asarray(a[0]),
                      jparams["stack"]["units"]["sub0"]["rec"])
    rng = np.random.default_rng(11)
    for name in ("rg_a_b", "rg_x_b"):
        jp[name] = rng.standard_normal(jp[name].shape).astype(np.float32)
    jp["conv_b"] = rng.standard_normal(jp["conv_b"].shape).astype(np.float32)
    cfg = reduced(get_config("recurrentgemma-9b"), num_layers=5)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    m = model.layers[0].rec
    with torch.no_grad():
        for name in ("rg_a_b", "rg_x_b", "conv_b"):
            getattr(m, name).copy_(torch.from_numpy(jp[name]))
    jp = jax.tree.map(jnp.asarray, jp)
    return jcfg, jp, cfg, m


def _x(b, s, c, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, c)).astype(
        np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


def _seq_ref(m, x, h0=None):
    """float64 sequential RG-LRU over the same gates, one token a step."""
    b, s, lru = x.shape
    g, bw = m.lam.shape
    log_a, u = rglru._rg_gates(m, torch.from_numpy(x).reshape(b, s, g, bw))
    a = log_a.double().exp().reshape(b, s, lru)
    u = u.double().reshape(b, s, lru)
    h = torch.zeros((b, lru), dtype=torch.float64) if h0 is None \
        else torch.from_numpy(h0).double()
    out = []
    for t in range(s):
        h = a[:, t] * h + u[:, t]
        out.append(h)
    return torch.stack(out, 1), h


def test_conv_linear_matches_jax(pair):
    _, jp, _, m = pair
    x = _x(2, 9, m.conv_w.shape[1])
    _close(rglru._conv_linear(torch.from_numpy(x), m.conv_w, m.conv_b),
           jax_rglru._conv_linear(jnp.asarray(x), jp["conv_w"], jp["conv_b"]))
    got = rglru._conv_linear_step(torch.from_numpy(x[:, :1]),
                                  torch.from_numpy(x[:, 1:4]), m.conv_w,
                                  m.conv_b)
    want = jax_rglru._conv_linear_step(jnp.asarray(x[:, :1]),
                                       jnp.asarray(x[:, 1:4]), jp["conv_w"],
                                       jp["conv_b"])
    for a, b in zip(got, want):
        _close(a, b)


def test_gates_match_jax(pair):
    """The port keeps ``log a`` from the gate; ``exp`` of it is JAX's a."""
    _, jp, _, m = pair
    g, bw = m.lam.shape
    xg = _x(2, 7, g * bw, seed=1).reshape(2, 7, g, bw)
    log_a, u = rglru._rg_gates(m, torch.from_numpy(xg))
    ja, jb = jax_rglru._rg_gates(jp, jnp.asarray(xg))
    _close(log_a.exp(), ja)
    _close(u, jb)
    assert (log_a <= 0).all() and log_a.dtype == torch.float32


@pytest.mark.parametrize("s", [1, 37, 64, 65, 130],
                         ids=["S1", "odd", "one-chunk", "chunk+1", "two+"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_scan_matches_jax_and_f64_recurrence(pair, s, with_h0):
    """S 1, an odd length, exactly one chunk, a chunk boundary plus one
    and two chunks plus a part: against the JAX associative scan and the
    float64 recurrence, from a zero state and from ``h0``."""
    _, jp, _, m = pair
    lru = m.lam.numel()
    x = _x(2, s, lru, seed=s)
    h0 = _x(1, 2, lru, seed=99)[0] if with_h0 else None
    h, last = rglru.rglru_scan(m, torch.from_numpy(x),
                               None if h0 is None else torch.from_numpy(h0))
    jh, jlast = jax.jit(jax_rglru.rglru_scan)(
        jp, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    rh, rlast = _seq_ref(m, x, h0)
    assert h.shape == (2, s, lru) and last.dtype == torch.float32
    _close(h, jh)
    _close(last, jlast)
    _close(h, rh, ORACLE_TOL)
    _close(last, rlast, ORACLE_TOL)


@pytest.mark.parametrize("split", [1, 8, 64, 99])
def test_scan_split_with_h0_equals_whole(pair, split):
    """The scan over the first ``split`` tokens, then over the rest from
    its last state as ``h0``, gives the scan over all 100 tokens: the
    state carried across any boundary, inside a chunk or on one."""
    _, _, _, m = pair
    x = torch.from_numpy(_x(1, 100, m.lam.numel(), seed=4))
    h, last = rglru.rglru_scan(m, x)
    h1, mid = rglru.rglru_scan(m, x[:, :split])
    h2, last2 = rglru.rglru_scan(m, x[:, split:], mid)
    _close(torch.cat([h1, h2], dim=1), h)
    _close(last2, last)


def test_scan_stays_finite_at_strong_decay(pair):
    """lam 40: log a reaches -320 a token, so exp(L_t - L_s) underflows to
    0 across a chunk; masked before the exp, nothing overflows."""
    _, _, _, m = pair
    x = _x(1, 80, m.lam.numel(), seed=5)
    with torch.no_grad():
        lam = m.lam.clone()
        m.lam.fill_(40.0)
        try:
            h, last = rglru.rglru_scan(m, torch.from_numpy(x))
            rh, rlast = _seq_ref(m, x)
        finally:
            m.lam.copy_(lam)
    assert torch.isfinite(h).all() and torch.isfinite(last).all()
    _close(h, rh, ORACLE_TOL)


def test_step_matches_jax(pair):
    _, jp, _, m = pair
    lru = m.lam.numel()
    x = _x(3, 1, lru, seed=6)
    h0 = _x(1, 3, lru, seed=7)[0]
    got = rglru.rglru_step(m, torch.from_numpy(x), torch.from_numpy(h0))
    want = jax_rglru.rglru_step(jp, jnp.asarray(x), jnp.asarray(h0))
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("s", [2, 70], ids=["short", "past-a-chunk"])
def test_prefill_then_step_equals_scan(pair, s):
    """The scan over S tokens, then one step a token, gives the scan over
    S + 5 tokens at every later position."""
    _, _, _, m = pair
    x = torch.from_numpy(_x(2, s + 5, m.lam.numel(), seed=8))
    full, full_last = rglru.rglru_scan(m, x)
    _, h = rglru.rglru_scan(m, x[:, :s])
    for t in range(s, s + 5):
        y, h = rglru.rglru_step(m, x[:, t:t + 1], h)
        _close(y[:, 0], full[:, t])
    _close(h, full_last)


def test_rec_block_prefill_and_decode_match_jax(pair):
    """griffin_rec_block: prefill of 11 tokens (state: last h and the
    last W-1 raw inputs), then two decode steps from that state; and a
    prompt shorter than the conv tail (zero-padded)."""
    jcfg, jp, cfg, m = pair
    block = jax.jit(lambda p, x, state=None: jax_rglru.griffin_rec_block(
        p, x, jcfg, state=state))
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    y, state = rglru.griffin_rec_block(m, torch.from_numpy(x[:, :11]), cfg)
    jy, jstate = block(jp, jnp.asarray(x[:, :11]))
    _close(y, jy)
    assert sorted(state) == sorted(jstate) == ["conv", "lru"]
    for k in state:
        _close(state[k], jstate[k])
    for t in (11, 12):
        y, state = rglru.griffin_rec_block(m, torch.from_numpy(x[:, t:t + 1]),
                                           cfg, state=state)
        jy, jstate = block(jp, jnp.asarray(x[:, t:t + 1]), jstate)
        _close(y, jy)
        for k in state:
            _close(state[k], jstate[k])
    _, short = rglru.griffin_rec_block(m, torch.from_numpy(x[:, :2]), cfg)
    _, jshort = block(jp, jnp.asarray(x[:, :2]))
    _close(short["conv"], jshort["conv"])
    assert not short["conv"][:, 0].any()  # the zero pad before token 0


def test_state_spec_matches_jax(pair):
    jcfg, _, cfg, _ = pair
    mine = rglru.griffin_rec_state_spec(cfg, 3, torch.bfloat16)
    theirs = jax_rglru.griffin_rec_state_spec(jcfg, 3, jnp.bfloat16)
    assert {k: s for k, (s, _) in mine.items()} == \
        {k: v.shape for k, v in theirs.items()}
    assert mine["lru"][1] == torch.float32 and mine["conv"][1] == torch.bfloat16
