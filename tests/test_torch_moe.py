"""Torch port, the moe family on the CPU, against the JAX package on the
same weights (``model.init(PRNGKey(0))`` through
``convert.params_from_jax``).

* ``models/moe``: ``moe_block`` equals the JAX one for both dispatches
  (``einsum``, ``sort``) at capacity factors 8.0 (drop-free), 1.25 (the
  published one) and 0.25, at 4, 64 and 512 tokens and at 1024 (two
  groups): the expert choices and the dropped slots exactly, y within
  1e-5 absolute (float32) and aux within 1e-6 relative.  The JAX drop
  set is read from JAX's own dispatch: with the gates of one choice set
  to 1 and the others to 0, a slot is kept iff its token's output is
  nonzero.  Top-k ties (a zero router) take the lower expert first, as
  ``jax.lax.top_k``.  600 tokens (over ``moe_group`` 512 and no multiple
  of it) raise, where the reference's reshape fails too.
* the model: ``forward`` logits and aux, ``decode_step`` and
  ``span_step`` (inactive rows and padding columns included) of reduced
  deepseek-moe and mixtral (sliding window 16) at the published 1.25,
  logits within ``LOGIT_TOL``; the state dict round trip.
* the engines: unified, legacy and fixed-batch greedy streams equal the
  greedy full-recompute oracle from the JAX ``forward`` at cf 8.0, and
  unified equals legacy.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import moe as jax_moe  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.models import convert, moe  # noqa: E402
from repro_torch.serve.engine import ContinuousServeEngine, ServeEngine  # noqa: E402
from repro_torch.serve.step import UnifiedServeEngine  # noqa: E402
from test_torch_spec import _setup  # noqa: E402

Y_TOL = 1e-5  # moe_block output, float32, absolute
AUX_RTOL = 1e-6  # load-balance loss, float32, relative
LOGIT_TOL = 1e-4  # the suite's float32 logit tolerance
CFS = [8.0, 1.25, 0.25]
# (B, S): t = B * S tokens — one group each, then two groups of 512
SHAPES = [(4, 1), (2, 32), (4, 128), (2, 512)]


def _layer0(arch, router_scale=1.0):
    """(jax cfg, the JAX moe params of layer 0, port cfg, port MoE), the
    router weights of both scaled by ``router_scale``."""
    jcfg, jparams, cfg, model, _ = _setup(arch)
    jp = jax.tree.map(lambda a: a[0], jparams["stack"]["units"]["moe"])
    jp = dict(jp, router={"w": jp["router"]["w"] * router_scale})
    m = model.layers[0].moe
    m = moe.MoE({n: (p * router_scale if n == "router" else p)
                 for n, p in m.named_parameters()})
    return jcfg, jp, cfg, m


def _x(shape, d, seed=0, common=0.0):
    """Unit-normal tokens plus ``common`` times one direction they all
    share (as hidden states do): the shared part skews the routing, so
    capacity binds."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((d,))
    return (rng.standard_normal((*shape, d)) + common * u).astype(np.float32)


def _jax_kept(jp, xg, idx, jcfg):
    """JAX's own drop set [G, g, K]: dispatch once per choice k with that
    choice's gate 1 and the others 0; a slot is kept iff its token's
    output is nonzero (a kept slot adds its expert's FFN of the token, a
    dropped one adds 0)."""
    dispatch = (jax_moe._dispatch_einsum if jcfg.moe_impl == "einsum"
                else jax_moe._dispatch_sort)
    k = idx.shape[-1]
    kept = []
    for j in range(k):
        gates = jax.nn.one_hot(jnp.full(idx.shape[:-1], j), k)
        y = dispatch(jp, xg, gates, idx, jcfg)
        kept.append(np.asarray(jnp.abs(y).max(-1) > 0))
    return np.stack(kept, -1)


def _port_kept(idx, cfg, g):
    if cfg.moe_impl == "einsum":
        return moe.einsum_slots(idx, cfg.num_experts, moe.capacity(g, cfg))[1]
    t, k = idx.shape[0] * idx.shape[1], idx.shape[2]
    ce = max(int(t * k / cfg.num_experts * cfg.capacity_factor), 1)
    return moe.sort_slots(idx.reshape(t, k), cfg.num_experts, ce)[1].reshape(
        idx.shape)


@pytest.mark.parametrize("shape", SHAPES, ids=[f"t{b * s}" for b, s in SHAPES])
@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_moe_block_matches_jax(impl, cf, shape):
    jcfg, jp, cfg, m = _layer0("deepseek-moe-16b")
    jcfg = jcfg.replace(capacity_factor=cf, moe_impl=impl)
    cfg = cfg.replace(capacity_factor=cf, moe_impl=impl)
    x = _x(shape, cfg.d_model, seed=int(cf * 4) + shape[1], common=1.0)
    t = shape[0] * shape[1]
    g = min(cfg.moe_group, t)
    xg = x.reshape(t // g, g, -1)
    # expert choices
    jg, jidx, jaux = jax_moe._router(jp, jnp.asarray(xg), jcfg)
    with torch.inference_mode():
        tg, tidx, taux = moe.router(m, torch.from_numpy(xg), cfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    # dropped slots
    want = _jax_kept(jp, jnp.asarray(xg), jidx, jcfg)
    got = _port_kept(tidx, cfg, g).numpy()
    np.testing.assert_array_equal(got, want)
    if cf == 8.0:
        assert got.all(), "cf 8 is drop-free for E 8, k 2"
    elif t >= 64:
        assert not got.all(), "no slot dropped: the case tests nothing"
    # the block
    jy, jaux = jax.jit(lambda p, v: jax_moe.moe_block(p, v, jcfg))(
        jp, jnp.asarray(x))
    with torch.inference_mode():
        ty, taux = moe.moe_block(m, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_TOL, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL)


@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_top_k_ties_take_the_lower_expert_like_jax(impl):
    """A zero router gives every expert probability 1/E: both packages
    pick experts 0..k-1 for every token, in that order."""
    jcfg, jp, cfg, m = _layer0("deepseek-moe-16b", router_scale=0.0)
    jcfg, cfg = (c.replace(moe_impl=impl, capacity_factor=1.25)
                 for c in (jcfg, cfg))
    x = _x((2, 32), cfg.d_model, seed=5)
    xg = x.reshape(1, 64, -1)
    _, jidx, _ = jax_moe._router(jp, jnp.asarray(xg), jcfg)
    with torch.inference_mode():
        _, tidx, _ = moe.router(m, torch.from_numpy(xg), cfg)
        ty, _ = moe.moe_block(m, torch.from_numpy(x), cfg)
    assert (np.asarray(jidx) == np.arange(cfg.experts_per_token)).all()
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    jy, _ = jax_moe.moe_block(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_TOL, rtol=0)


def test_tokens_that_do_not_split_into_groups_raise():
    """600 tokens over moe_group 512: the reference fails at its reshape;
    the port refuses with a ValueError instead of regrouping."""
    jcfg, jp, cfg, m = _layer0("deepseek-moe-16b")
    x = _x((1, 600), cfg.d_model)
    with pytest.raises(Exception):
        jax_moe.moe_block(jp, jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match="groups of 512"):
        moe.moe_block(m, torch.from_numpy(x), cfg)


ARCHS = ["deepseek-moe-16b", "mixtral-8x22b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_jax(arch):
    jcfg, jparams, cfg, model, _ = _setup(arch, capacity_factor=1.25)
    jm = jax_build_model(jcfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
    jl, _, jaux = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}))(
        jparams, jnp.asarray(toks, jnp.int32))
    with torch.inference_mode():
        tl, taux = model(torch.from_numpy(toks), with_aux=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_span_and_decode_match_jax_with_inactive_rows(arch):
    """At the published capacity factor 1.25 (drops at every step): three
    span rows, one padded and one inactive (row_len 0), then two decode
    steps over four rows of which the last is inactive (NULL table, as
    the engines mask it).  Every row's tokens take capacity in both
    packages, so every row's logits are compared."""
    jcfg, jparams, cfg, model, _ = _setup(arch, capacity_factor=1.25)
    jm = jax_build_model(jcfg)
    nb, bs = 12, 8
    L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    jpool = {"units": {n: jnp.zeros((L, nb, bs, kv, hd), jnp.float32)
                       for n in ("k", "v")}}
    tpool = {n: torch.zeros((L, nb, bs, kv, hd)) for n in ("k", "v")}
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (3, 20)).astype(np.int32)
    bt = np.array([[1, 2, 3, 0], [4, 5, 6, 0], [0, 0, 0, 0]], np.int32)
    st = np.zeros((3,), np.int32)
    ln = np.array([20, 13, 0], np.int32)
    jpool, jl = jax.jit(jm.span_step)(
        jparams, jpool, jnp.asarray(toks), jnp.asarray(st), jnp.asarray(ln),
        jnp.asarray(bt))
    with torch.inference_mode():
        tl = model.span_step(tpool, torch.from_numpy(toks),
                             torch.from_numpy(st), torch.from_numpy(ln),
                             torch.from_numpy(bt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    dec = jax.jit(lambda p, c, t, i, b: jm.decode_step(p, c, t, i,
                                                       block_tables=b))
    bt4 = np.array([[1, 2, 3, 0], [4, 5, 6, 0], [7, 8, 9, 0], [0, 0, 0, 0]],
                   np.int32)
    tok = rng.integers(0, cfg.vocab_size, (4,)).astype(np.int32)
    idx = np.array([20, 13, 0, 0], np.int32)
    for _ in range(2):
        jpool, jlog = dec(jparams, jpool, jnp.asarray(tok), jnp.asarray(idx),
                          jnp.asarray(bt4))
        with torch.inference_mode():
            tlog = model.decode_step(tpool, torch.from_numpy(tok),
                                     torch.from_numpy(idx),
                                     torch.from_numpy(bt4))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_TOL, rtol=0)
        tok = np.asarray(jlog)[:, :cfg.vocab_size].argmax(-1).astype(np.int32)
        idx = idx + np.array([1, 1, 1, 0], np.int32)
    for n in ("k", "v"):
        np.testing.assert_allclose(tpool[n].numpy(),
                                   np.asarray(jpool["units"][n]),
                                   atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_round_trip(arch):
    """Every leaf of the JAX moe tree maps onto one port parameter, and
    back: the experts' [L, E, ...] axes and the shared experts
    included."""
    jcfg, jparams, cfg, model, _ = _setup(arch)
    sd = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(sd) == set(model.state_dict())
    assert model.param_count() == jax_build_model(jcfg).param_count()
    units = jparams["stack"]["units"]["moe"]
    for i in range(cfg.num_layers):
        m = model.layers[i].moe
        np.testing.assert_array_equal(m.router.numpy(),
                                      np.asarray(units["router"]["w"][i]))
        for name in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                getattr(m, name).numpy(), np.asarray(units["experts"][name][i]))
        assert m.has_shared == ("shared" in units)
        for name, proj in units.get("shared", {}).items():
            np.testing.assert_array_equal(getattr(m, f"shared_{name}").numpy(),
                                          np.asarray(proj["w"][i]))


def _streams(eng, prompts, gen):
    reqs = [eng.submit(p, gen) for p in prompts]
    out = eng.run()
    return [out[r.rid] for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_engines_equal_the_greedy_oracle_drop_free(arch):
    """cf 8.0 (drop-free): every engine groups tokens differently, and
    none of them may change a token; unified == legacy == fixed batch ==
    the JAX-forward full-recompute oracle."""
    _, _, cfg, model, oracle = _setup(arch)
    assert cfg.capacity_factor == 8.0
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (7, 16, 21, 30)]
    gen = 8
    unified = _streams(UnifiedServeEngine(
        cfg, model, device="cpu", num_slots=2, max_len=48, block_size=16,
        chunk_size=8), prompts, gen)
    legacy = _streams(ContinuousServeEngine(
        cfg, model, device="cpu", num_slots=2, max_len=48, block_size=16),
        prompts, gen)
    fixed = ServeEngine(cfg, model, device="cpu", max_len=48)
    for p, u, lg in zip(prompts, unified, legacy):
        want = oracle(p, gen)
        np.testing.assert_array_equal(u, want)
        np.testing.assert_array_equal(lg, u)
        np.testing.assert_array_equal(
            fixed.generate(p[None], num_tokens=gen)[0], want)
