"""Map the JAX package's parameter tree onto the port's modules.

The JAX tree of a dense ``DecoderLM`` (``transformer.stack_decl``) is::

    {"embed": {"embedding", "lm_head"},
     "stack": {"units": {"ln1": {"scale"}, "ln2": {"scale"},
                         "attn": {"wq": {"w"[, "b"]}, "wk", "wv", "wo": {"w"}},
                         "mlp": {"w_up", "w_gate", "w_down": {"w"}}}},
     "final_norm": {"scale"}}

with a leading ``layers`` axis on every ``units`` leaf; a moe unit holds
``"moe": {"router": {"w"}, "experts": {"w_gate", "w_up", "w_down"},
"shared": {"w_gate", "w_up", "w_down": {"w"}}}`` (experts ``[L, E, ...]``,
``shared`` only with shared experts) in place of ``"mlp"``; an ssm stack's
unit is ``{"mamba": {"norm": {"scale"}, "wz", "wx", "wb", "wc", "wdt":
{"w"}, "conv_x", "conv_x_b", "conv_b", "conv_b_b", "conv_c", "conv_c_b",
"A_log", "D", "dt_bias", "out_norm": {"scale"}, "out_proj": {"w"}}}``
(``ssm.mamba2_decl``).  A hybrid stack's ``units`` hold
``sub0..subK`` sub-layers (a ``rec`` layer: ``"rec": {"w_gate", "w_in",
"w_out": {"w"}, "conv_w", "conv_b", "rg_a_w", "rg_a_b", "rg_x_w",
"rg_x_b", "lam"}`` beside ln1/ln2/mlp) and a length-1 ``tail`` of the
leftover sub-layers; they map onto the flat layer list in the order the
JAX package runs them (``params.layer_plan``).  A vlm adds
``"vision_proj": {"w", "b"}``.  The port keeps the ``[in, out...]``
dense layout, so the mapping only slices the layers axis.  Leaves may be
numpy arrays (bfloat16 arrays from ml_dtypes included) or anything
``np.asarray`` accepts.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _unit_leaves(unit) -> dict:
    """One (sub-)layer's JAX subtree -> {state-dict suffix: stacked leaf}."""
    if "mamba" in unit:
        # a dict entry holds a norm's scale or a dense's w
        return {f"mamba.{k}" + (".scale" if k.endswith("norm") else ""):
                next(iter(v.values())) if isinstance(v, dict) else v
                for k, v in unit["mamba"].items()}
    leaves = {"ln1.scale": unit["ln1"]["scale"],
              "ln2.scale": unit["ln2"]["scale"]}
    for name, v in unit.get("rec", {}).items():
        leaves[f"rec.{name}"] = v["w"] if isinstance(v, dict) else v
    for n, proj in unit.get("attn", {}).items():  # wq, wk, wv, wo
        leaves[f"attn.{n}"] = proj["w"]
        if "b" in proj:
            leaves[f"attn.b{n[1]}"] = proj["b"]
    for name, proj in unit.get("mlp", {}).items():
        leaves[f"mlp.{name}"] = proj["w"]
    if "moe" in unit:
        m = unit["moe"]
        leaves["moe.router"] = m["router"]["w"]
        for name, w in m["experts"].items():
            leaves[f"moe.{name}"] = w
        for name, proj in m.get("shared", {}).items():
            leaves[f"moe.shared_{name}"] = proj["w"]
    return leaves


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """JAX param tree -> a state dict for :class:`DecoderLM`
    (``model.load_state_dict(params_from_jax(tree))``)."""
    sd = {"embedding": _tensor(tree["embed"]["embedding"]),
          "final_norm.scale": _tensor(tree["final_norm"]["scale"])}
    if "lm_head" in tree["embed"]:
        sd["lm_head"] = _tensor(tree["embed"]["lm_head"])
    if "vision_proj" in tree:
        for k, v in tree["vision_proj"].items():
            sd[f"vision_proj.{k}"] = _tensor(v)
    # run order: units (each unit's sub-layers in turn), then the tail
    i = 0
    for stack in ("units", "tail"):
        node = tree["stack"].get(stack)
        if node is None:
            continue
        subs = [node[k] for k in sorted((k for k in node if k.startswith("sub")),
                                        key=lambda k: int(k[3:]))] or [node]
        stacked = [{k: _tensor(v) for k, v in _unit_leaves(sub).items()}
                   for sub in subs]
        for u in range(next(iter(stacked[0].values())).shape[0]):
            for leaves in stacked:
                for k, v in leaves.items():
                    sd[f"layers.{i}.{k}"] = v[u].clone()
                i += 1
    return sd
