"""Torch port, dense decoder: forward / decode_step / span_step logits and
pool state against the JAX package's jitted functions on the same weights
(``model.init(PRNGKey(0))`` mapped through ``convert.params_from_jax``) for
GQA, sliding-window and MHA-with-bias configs; the seeded init, sampling,
and the family gate."""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core import sampling as jax_sampling  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import sampling  # noqa: E402
from repro_torch.models import convert, params  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

LOGIT_TOL = 1e-4  # float32, different op order (absolute, logits ~ O(1))


@pytest.fixture(scope="module", params=[
    ("granite-8b", {}),  # GQA 4:1
    ("granite-8b", {"attention_window": 5}),  # sliding window
    ("codeqwen1.5-7b", {}),  # MHA + qkv biases
], ids=["granite", "granite-swa", "codeqwen"])
def pair(request):
    arch, kw = request.param
    jcfg = jax_reduced(jax_get_config(arch), num_layers=2, **kw)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    if jcfg.qkv_bias:  # biases init to zero: make them count
        rng = np.random.default_rng(9)
        for n in ("wq", "wk", "wv"):
            b = jparams["stack"]["units"]["attn"][n]["b"]
            jparams["stack"]["units"]["attn"][n]["b"] = jnp.asarray(
                rng.standard_normal(b.shape).astype(np.float32))
    cfg = reduced(get_config(arch), num_layers=2, **kw)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    return jcfg, jmodel, jparams, cfg, model


def test_forward_matches_jax(pair):
    jcfg, jmodel, jparams, cfg, model = pair
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
    jl, _, _ = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t}))(
        jparams, jnp.asarray(toks, jnp.int32))
    tl = model(torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)


def test_span_then_decode_match_jax_on_same_pool(pair):
    """Two ragged span rows (one crossing a block edge, one padded), then
    two decode steps: logits within 1e-4 and the pools equal within the
    same tolerance after every step."""
    jcfg, jmodel, jparams, cfg, model = pair
    nb, bs, w = 10, 8, 4
    L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    jpool = {"units": {n: jnp.zeros((L, nb, bs, kv, hd), jnp.float32)
                       for n in ("k", "v")}}
    tpool = {n: torch.zeros((L, nb, bs, kv, hd)) for n in ("k", "v")}
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    bt = np.array([[1, 2, 3, 0], [4, 5, 0, 0]], np.int32)
    st = np.array([0, 0], np.int32)
    ln = np.array([12, 9], np.int32)
    span = jax.jit(jmodel.span_step)
    dec = jax.jit(lambda p, c, t, i, b: jmodel.decode_step(p, c, t, i,
                                                           block_tables=b))

    def check_pools():
        for n in ("k", "v"):
            np.testing.assert_allclose(tpool[n].numpy(),
                                       np.asarray(jpool["units"][n]),
                                       atol=LOGIT_TOL, rtol=0)

    jpool, jl = span(jparams, jpool, jnp.asarray(toks), jnp.asarray(st),
                     jnp.asarray(ln), jnp.asarray(bt))
    tl = model.span_step(tpool, torch.from_numpy(toks), torch.from_numpy(st),
                         torch.from_numpy(ln), torch.from_numpy(bt))
    valid = np.arange(12)[None, :] < ln[:, None]
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                               atol=LOGIT_TOL, rtol=0)
    check_pools()
    tok = np.asarray(jl)[[0, 1], ln - 1].argmax(-1).astype(np.int32)
    idx = ln.copy()
    for _ in range(2):
        jpool, jlog = dec(jparams, jpool, jnp.asarray(tok), jnp.asarray(idx),
                          jnp.asarray(bt))
        tlog = model.decode_step(tpool, torch.from_numpy(tok),
                                 torch.from_numpy(idx), torch.from_numpy(bt))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_TOL, rtol=0)
        check_pools()
        tok = np.asarray(jlog).argmax(-1).astype(np.int32)
        idx = idx + 1


def test_state_dict_covers_every_parameter(pair):
    jcfg, jmodel, jparams, cfg, model = pair
    sd = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(sd) == set(model.state_dict())
    assert model.param_count() == jmodel.param_count() == cfg.approx_params()


def test_seeded_init_matches_decl_shapes_and_scales():
    """Same shapes and init scales as the JAX ``_init_leaf``: stddev
    1/sqrt(prod(stacked shape[:-1])) for "normal" leaves, 1 for the
    embedding, ones for norms; reproducible per seed."""
    cfg = reduced(get_config("granite-8b"), num_layers=2, d_model=256)
    a = build_model(cfg, device="cpu", seed=3)
    b = build_model(cfg, device="cpu", seed=3)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    jshapes = jax.tree.map(lambda s: s.shape, jax_build_model(
        jax_reduced(jax_get_config("granite-8b"), num_layers=2, d_model=256)
    ).abstract_params())
    decls = params.decl_tree(cfg)
    wq = decls["stack"]["units"]["attn"]["wq"]["w"]
    assert wq.shape == jshapes["stack"]["units"]["attn"]["wq"]["w"]
    assert a.layers[0].attn.wq.shape == wq.shape[1:]
    std = a.layers[0].attn.wq.std().item()
    assert abs(std * math.sqrt(math.prod(wq.shape[:-1])) - 1) < 0.05
    assert abs(a.embedding.std().item() - 1) < 0.05
    assert torch.equal(a.layers[1].ln2.scale, torch.ones(cfg.d_model))
    assert a.embedding.shape == jshapes["embed"]["embedding"]


def test_other_families_raise():
    with pytest.raises(NotImplementedError,
                       match="dense, moe, ssm, hybrid and vlm"):
        build_model(reduced(get_config("whisper-small")), device="cpu")


def test_build_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is for hosts without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(reduced(get_config("granite-8b")))


def test_greedy_is_first_argmax_over_unpadded_vocab():
    lg = torch.tensor([[0.0, 3.0, 3.0, 9.0], [5.0, 1.0, 5.0, 0.0]])
    out = sampling.sample_logits(lg, None, 0.0, vocab=3, top_k=1, top_p=0.1)
    assert out.tolist() == [1, 0] and out.dtype == torch.int32


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.8), (7, 0.6)])
def test_filter_logits_matches_jax(top_k, top_p):
    lg = np.random.default_rng(2).standard_normal((3, 40)).astype(np.float32)
    ref = np.asarray(jax_sampling.filter_logits(jnp.asarray(lg), top_k, top_p))
    out = sampling.filter_logits(torch.from_numpy(lg), top_k, top_p).numpy()
    np.testing.assert_array_equal(out, ref)


def test_temperature_sampling_is_seeded_and_respects_filters():
    lg = torch.from_numpy(
        np.random.default_rng(3).standard_normal((64, 50)).astype(np.float32))
    draw = [sampling.sample_logits(lg, torch.Generator().manual_seed(9), 0.9,
                                   vocab=50, top_k=4) for _ in range(2)]
    assert torch.equal(draw[0], draw[1])
    top4 = torch.topk(lg, 4, dim=-1).indices
    assert (top4 == draw[0][:, None].long()).any(dim=-1).all()
