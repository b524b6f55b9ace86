"""Parameter declarations and seeded initialisation for the dense, moe,
ssm (Mamba-2), hybrid (Griffin: RG-LRU + local attention) and vlm
decoders.

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
    init: str = "normal"  # normal | zeros | ones | embed | conv | ssm_* | rglru_lambda
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


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")  # the ported families


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"repro_torch ports the dense, moe, ssm, hybrid and vlm "
            f"families only; {cfg.name!r} is family {cfg.family!r}")


def unit_kinds(cfg) -> tuple[str, ...]:
    """Layer kinds of one scanned unit (JAX ``transformer.unit_kinds``):
    one layer, or the hybrid's ``block_pattern`` super-block."""
    if cfg.family == "hybrid":
        return tuple(cfg.block_pattern)
    return ("dense" if cfg.family == "vlm" else cfg.family,)


def layer_plan(cfg) -> list[tuple[str, str, str | None]]:
    """The stack's layers in the order the JAX package runs them: the
    ``units`` (each unit's sub-layers in turn), then the ``tail``
    (``transformer.stack_decl``: layers that do not fill a whole
    super-block, recurrentgemma-9b's 12 x (rec, rec, attn) + 2 rec).
    Each entry is (kind, stack key "units" | "tail", sub-layer key
    "subI" or None for a one-layer unit)."""
    kinds = unit_kinds(cfg)
    if len(kinds) == 1:
        return [(kinds[0], "units", None)] * cfg.num_layers
    nb, rem = divmod(cfg.num_layers, len(kinds))
    plan = [(k, "units", f"sub{i}") for _ in range(nb)
            for i, k in enumerate(kinds)]
    return plan + [(k, "tail", f"sub{i}") for i, k in enumerate(kinds[:rem])]


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


def _griffin_rec(cfg) -> dict:
    """One RG-LRU block (``repro.models.rglru.griffin_rec_decl``): gates
    block-diagonal, one [bw, bw] block per head."""
    d, lru, g, w = cfg.d_model, cfg.lru_width, cfg.num_heads, cfg.conv_width
    bw = lru // g
    f32 = torch.float32
    return {
        "w_gate": _dense(d, (lru,)), "w_in": _dense(d, (lru,)),
        "conv_w": ParamDecl((w, lru), "conv"),
        "conv_b": ParamDecl((lru,), "zeros", dtype=f32),
        "rg_a_w": ParamDecl((g, bw, bw)),
        "rg_a_b": ParamDecl((g, bw), "zeros", dtype=f32),
        "rg_x_w": ParamDecl((g, bw, bw)),
        "rg_x_b": ParamDecl((g, bw), "zeros", dtype=f32),
        "lam": ParamDecl((g, bw), "rglru_lambda", dtype=f32),
        "w_out": _dense(lru, (d,)),
    }


def _layer(cfg, kind: str) -> dict:
    """One layer of ``kind`` (JAX ``transformer.layer_decl``): an ssm
    layer is ``{"mamba": ...}``; the others are ln1 + mixer + ln2 + FFN,
    the mixer ``attn`` (dense, moe, attn) or ``rec``, the FFN ``moe`` for
    a moe layer and ``mlp`` otherwise."""
    if kind == "ssm":
        return {"mamba": _mamba2(cfg)}
    d, hd, ff = cfg.d_model, cfg.head_dim, cfg.d_ff
    norm = {"scale": ParamDecl((d,), "ones", dtype=torch.float32)}
    layer = {"ln1": dict(norm), "ln2": dict(norm)}
    if kind == "rec":
        layer["rec"] = _griffin_rec(cfg)
    else:
        layer["attn"] = {
            "wq": _dense(d, (cfg.num_heads, hd), bias=cfg.qkv_bias),
            "wk": _dense(d, (cfg.num_kv_heads, hd), bias=cfg.qkv_bias),
            "wv": _dense(d, (cfg.num_kv_heads, hd), bias=cfg.qkv_bias),
            "wo": {"w": ParamDecl((cfg.num_heads, hd, d))},
        }
    if kind == "moe":
        layer["moe"] = moe_decl(cfg)
    else:
        mlp = {"w_up": _dense(d, (ff,))}
        if cfg.gated_mlp:
            mlp["w_gate"] = _dense(d, (ff,))
        mlp["w_down"] = _dense(ff, (d,))
        layer["mlp"] = mlp
    return layer


def _unit(cfg, kinds) -> dict:
    if len(kinds) == 1:
        return _layer(cfg, kinds[0])
    return {f"sub{i}": _layer(cfg, k) for i, k in enumerate(kinds)}


def decl_tree(cfg) -> dict:
    """The JAX ``DecoderLM.decl()`` tree, layers-stacked:
    ``{"embed", "stack": {"units"[, "tail"]}, "final_norm"[,
    "vision_proj"]}`` (``transformer.stack_decl``): ``units`` stacks one
    layer per unit, or a hybrid's ``sub0..subK`` super-block; a hybrid's
    leftover layers form a length-1 ``tail`` stack; a vlm adds the biased
    ``vision_proj`` [vision_dim, d_model]."""
    check_family(cfg)
    d = cfg.d_model
    v = padded_vocab(cfg.vocab_size)
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported")
    embed = {"embedding": ParamDecl((v, d), "embed")}
    if not cfg.tie_embeddings:
        embed["lm_head"] = ParamDecl((d, v))
    kinds = unit_kinds(cfg)
    nb, rem = divmod(cfg.num_layers, len(kinds))
    stack = {"units": _stack(_unit(cfg, kinds), nb)}
    if rem:
        stack["tail"] = _stack({f"sub{i}": _layer(cfg, k)
                                for i, k in enumerate(kinds[:rem])}, 1)
    tree = {"embed": embed, "stack": stack,
            "final_norm": {"scale": ParamDecl((d,), "ones",
                                              dtype=torch.float32)}}
    if cfg.family == "vlm":
        tree["vision_proj"] = _dense(cfg.vision_dim, (d,), bias=True)
    return tree


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
    elif d.init == "rglru_lambda":
        # RG-LRU Lambda: a = exp(-c softplus(Lambda)) in [0.9, 0.999]
        u = torch.empty(shape, dtype=torch.float32, device=device)
        u.uniform_(0.9, 0.999, generator=generator)
        sp = -torch.log(u ** (1.0 / 8.0))
        return torch.log(torch.expm1(sp)).to(dtype)
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
