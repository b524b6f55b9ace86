"""Parameter declarations and seeded initialisation for the dense, moe
and ssm (Mamba-2) decoders.

The JAX package declares every parameter once as a ``ParamDecl`` (shape +
initializer) and initialises the whole layers-stacked tree from one PRNG
key.  The port keeps the declaration tree with the SAME shapes — the
``layers`` axis stacked in front, exactly as ``transformer.stack_decl``
builds it — so the init scales match ``_init_leaf``: a "normal" leaf's
stddev is ``1/sqrt(prod(shape[:-1]))`` of the stacked shape.

The tensors themselves are drawn per layer, straight into the model dtype
on the target device from an explicit ``torch.Generator`` — a full-width
model is never materialised as a float32 host copy.  The bits differ from
JAX's threefry stream; parity tests load the JAX weights through
:mod:`repro_torch.models.convert` instead.
"""
from __future__ import annotations

import dataclasses
import math

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    """Declaration of one parameter: its (stacked) shape and initializer."""

    shape: tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | embed | conv | ssm_*
    scale: float | None = None  # stddev override for "normal"
    dtype: torch.dtype | None = None  # None -> model default dtype


def padded_vocab(vocab_size: int, multiple: int = 128) -> int:
    """Vocab padded for divisibility + alignment (pad ids never win: their
    logits are masked to a large negative)."""
    return (vocab_size + multiple - 1) // multiple * multiple


def _dense(in_dim, out_dims, *, bias=False, scale=None):
    d = {"w": ParamDecl((in_dim, *out_dims), scale=scale)}
    if bias:
        d["b"] = ParamDecl(tuple(out_dims), "zeros", dtype=torch.float32)
    return d


def _stack(tree, n: int):
    if isinstance(tree, ParamDecl):
        return dataclasses.replace(tree, shape=(n,) + tree.shape)
    return {k: _stack(v, n) for k, v in tree.items()}


FAMILIES = ("dense", "moe", "ssm")  # the ported layer families


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"repro_torch ports the dense, moe and ssm families only; "
            f"{cfg.name!r} is family {cfg.family!r}")


def moe_decl(cfg) -> dict:
    """One MoE FFN (``repro.models.moe.moe_decl``): the router (stddev
    0.02), the experts stacked on a leading E axis and, with shared
    experts, one dense gated FFN ``num_shared_experts`` experts wide."""
    d, ff, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts
    decl = {
        "router": _dense(d, (e,), scale=0.02),
        "experts": {"w_gate": ParamDecl((e, d, ff)),
                    "w_up": ParamDecl((e, d, ff)),
                    "w_down": ParamDecl((e, ff, d))},
    }
    if cfg.num_shared_experts:
        sf = cfg.num_shared_experts * ff
        decl["shared"] = {"w_gate": _dense(d, (sf,)), "w_up": _dense(d, (sf,)),
                          "w_down": _dense(sf, (d,))}
    return decl


def _mamba2(cfg) -> dict:
    """One Mamba-2 unit (``repro.models.ssm.mamba2_decl``)."""
    d, di, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_heads
    gn, w = cfg.ssm_groups * cfg.ssm_state, cfg.conv_width
    f32 = torch.float32
    return {
        "norm": {"scale": ParamDecl((d,), "ones", dtype=f32)},
        "wz": _dense(d, (di,)), "wx": _dense(d, (di,)),
        "wb": _dense(d, (gn,)), "wc": _dense(d, (gn,)),
        "wdt": _dense(d, (h,)),
        "conv_x": ParamDecl((w, di), "conv"),
        "conv_x_b": ParamDecl((di,), "zeros", dtype=f32),
        "conv_b": ParamDecl((w, gn), "conv"),
        "conv_b_b": ParamDecl((gn,), "zeros", dtype=f32),
        "conv_c": ParamDecl((w, gn), "conv"),
        "conv_c_b": ParamDecl((gn,), "zeros", dtype=f32),
        "A_log": ParamDecl((h,), "ssm_a_log", dtype=f32),
        "D": ParamDecl((h,), "ones", dtype=f32),
        "dt_bias": ParamDecl((h,), "ssm_dt_bias", dtype=f32),
        "out_norm": {"scale": ParamDecl((di,), "ones", dtype=f32)},
        "out_proj": _dense(di, (d,)),
    }


def decl_tree(cfg) -> dict:
    """The JAX ``DecoderLM.decl()`` tree for a dense, moe or ssm config,
    layers-stacked: ``{"embed", "stack": {"units": ...}, "final_norm"}``
    (an ssm unit is ``{"mamba": ...}``; a moe unit holds ``"moe"`` in
    place of ``"mlp"``, ``transformer.layer_decl``)."""
    check_family(cfg)
    d = cfg.d_model
    v = padded_vocab(cfg.vocab_size)
    norm = {"scale": ParamDecl((d,), "ones", dtype=torch.float32)}
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported")
    embed = {"embedding": ParamDecl((v, d), "embed")}
    if not cfg.tie_embeddings:
        embed["lm_head"] = ParamDecl((d, v))
    if cfg.family == "ssm":
        return {"embed": embed,
                "stack": {"units": _stack({"mamba": _mamba2(cfg)},
                                          cfg.num_layers)},
                "final_norm": dict(norm)}
    hd, ff = cfg.head_dim, cfg.d_ff
    layer = {
        "ln1": dict(norm), "ln2": dict(norm),
        "attn": {
            "wq": _dense(d, (cfg.num_heads, hd), bias=cfg.qkv_bias),
            "wk": _dense(d, (cfg.num_kv_heads, hd), bias=cfg.qkv_bias),
            "wv": _dense(d, (cfg.num_kv_heads, hd), bias=cfg.qkv_bias),
            "wo": {"w": ParamDecl((cfg.num_heads, hd, d))},
        },
    }
    if cfg.family == "moe":
        layer["moe"] = moe_decl(cfg)
    else:
        mlp = {"w_up": _dense(d, (ff,))}
        if cfg.gated_mlp:
            mlp["w_gate"] = _dense(d, (ff,))
        mlp["w_down"] = _dense(ff, (d,))
        layer["mlp"] = mlp
    return {"embed": embed, "stack": {"units": _stack(layer, cfg.num_layers)},
            "final_norm": dict(norm)}


def _leaves(tree):
    if isinstance(tree, ParamDecl):
        yield tree
    else:
        for v in tree.values():
            yield from _leaves(v)


def param_count(cfg) -> int:
    return sum(math.prod(d.shape) for d in _leaves(decl_tree(cfg)))


def init_leaf(d: ParamDecl, shape, default_dtype, generator, device):
    """One tensor of ``shape`` (a per-layer slice of ``d.shape`` or the
    whole of it) drawn like JAX ``_init_leaf`` draws ``d``."""
    dtype = d.dtype or default_dtype
    if d.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if d.init == "normal":
        fan_in = math.prod(d.shape[:-1]) if len(d.shape) > 1 else d.shape[0]
        std = d.scale if d.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    elif d.init == "embed":
        std = d.scale if d.scale is not None else 1.0
    elif d.init == "conv":
        bound = 1.0 / math.sqrt(max(d.shape[-1], 1))
        out = torch.empty(shape, dtype=torch.float32, device=device)
        return out.uniform_(-bound, bound, generator=generator).to(dtype)
    elif d.init == "ssm_a_log":
        # Mamba-2: A ~ U[1, 16], stored as log(A); dA = -exp(A_log) * dt
        a = torch.empty(shape, dtype=torch.float32, device=device)
        return a.uniform_(1.0, 16.0, generator=generator).log().to(dtype)
    elif d.init == "ssm_dt_bias":
        # dt = softplus(raw + bias) in ~[1e-3, 0.1] at init
        u = torch.empty(shape, dtype=torch.float32, device=device)
        u.uniform_(0.0, 1.0, generator=generator)
        lo, hi = math.log(1e-3), math.log(0.1)
        dt = torch.exp(u * (hi - lo) + lo)
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    else:
        raise NotImplementedError(f"init {d.init!r} is not ported")
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.normal_(0.0, std, generator=generator)
