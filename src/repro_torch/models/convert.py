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
(``ssm.mamba2_decl``).  The port keeps
the ``[in, out...]`` dense layout, so the mapping only slices the layers
axis.  Leaves may be numpy arrays (bfloat16 arrays from ml_dtypes
included) or anything ``np.asarray`` accepts.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """JAX param tree -> a state dict for :class:`DecoderLM`
    (``model.load_state_dict(params_from_jax(tree))``)."""
    if "tail" in tree["stack"]:
        raise NotImplementedError("stacks with a tail unit are not ported")
    sd = {"embedding": _tensor(tree["embed"]["embedding"]),
          "final_norm.scale": _tensor(tree["final_norm"]["scale"])}
    if "lm_head" in tree["embed"]:
        sd["lm_head"] = _tensor(tree["embed"]["lm_head"])
    units = tree["stack"]["units"]
    if "mamba" in units:
        # a dict entry holds a norm's scale or a dense's w
        leaves = {f"mamba.{k}" + (".scale" if k.endswith("norm") else ""):
                  next(iter(v.values())) if isinstance(v, dict) else v
                  for k, v in units["mamba"].items()}
    else:
        leaves = {"ln1.scale": units["ln1"]["scale"],
                  "ln2.scale": units["ln2"]["scale"]}
        for n in "qkvo":
            proj = units["attn"][f"w{n}"]
            leaves[f"attn.w{n}"] = proj["w"]
            if "b" in proj:
                leaves[f"attn.b{n}"] = proj["b"]
        for name, proj in units.get("mlp", {}).items():
            leaves[f"mlp.{name}"] = proj["w"]
        if "moe" in units:
            m = units["moe"]
            leaves["moe.router"] = m["router"]["w"]
            for name, w in m["experts"].items():
                leaves[f"moe.{name}"] = w
            for name, proj in m.get("shared", {}).items():
                leaves[f"moe.shared_{name}"] = proj["w"]
    stacked = {k: _tensor(v) for k, v in leaves.items()}
    num_layers = next(iter(stacked.values())).shape[0]
    for i in range(num_layers):
        for k, v in stacked.items():
            sd[f"layers.{i}.{k}"] = v[i].clone()
    return sd
