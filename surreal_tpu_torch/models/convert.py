"""Carries flax parameters across to the port's modules.

flax `Dense` kernels are (in, out); `nn.Linear` weights are (out, in).
The flax tree `{'params': {torso: {'dense_i': {kernel, bias}}, mean_head,
value_head, log_std}}` maps to state-dict names `torso.dense_i.weight`
etc. Input is the tree with numpy leaves (e.g. `jax.device_get(params)`).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def params_from_flax(flax_params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    tree = flax_params.get("params", flax_params)
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}{k}"
            if isinstance(v, Mapping):
                walk(v, name + ".")
            elif k == "kernel":
                out[f"{prefix}weight"] = torch.as_tensor(np.asarray(v).T.copy())
            else:
                out[name] = torch.as_tensor(np.asarray(v).copy())

    walk(tree, "")
    return out


def params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """Inverse of `params_from_flax` (numpy leaves), for comparing a trained
    port module with the reference's parameter tree."""
    tree: dict[str, Any] = {}
    for name, t in state_dict.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        arr = t.detach().cpu().numpy()
        if leaf == "weight":
            node["kernel"] = arr.T.copy()
        else:
            node[leaf] = arr
    return {"params": tree}
