"""Carries flax parameters across to the port's modules.

flax `Dense` kernels are (in, out); `nn.Linear` weights are (out, in).
The flax tree `{'params': {torso: {'dense_i': {kernel, bias}}, mean_head,
value_head, log_std}}` maps to state-dict names `torso.dense_i.weight`
etc. Input is the tree with numpy leaves (e.g. `jax.device_get(params)`).

Three more forms:
- flax names unnamed sub-modules by class (`MLP_0`, `Dense_0`,
  `LayerNorm_0` in the DDPG nets); the port's attributes are `torso`,
  `head` and `layer_norm`;
- `LayerNorm`'s `scale` is torch's `weight`;
- `OptimizedLSTMCell` keeps eight sub-trees, `ii, if, ig, io` (kernel) and
  `hi, hf, hg, ho` (kernel and bias); `blocks.LSTMCell` stacks them, in the
  order i, f, g, o, into `weight_ih`, `weight_hh` and `bias`.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_AUTO_NAMES = {"MLP_0": "torso", "Dense_0": "head", "LayerNorm_0": "layer_norm"}
_PORT_NAMES = {v: k for k, v in _AUTO_NAMES.items()}
_GATES = "ifgo"
_LSTM_KEYS = {f"{side}{g}" for side in "ih" for g in _GATES}


def params_from_flax(flax_params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    tree = flax_params.get("params", flax_params)
    out: dict[str, torch.Tensor] = {}

    def put(name, array):
        out[name] = torch.tensor(np.ascontiguousarray(array))  # copies

    def walk(node, prefix):
        if set(node) == _LSTM_KEYS:
            for side in "ih":
                put(f"{prefix}weight_{side}h", np.concatenate(
                    [np.asarray(node[f"{side}{g}"]["kernel"]).T for g in _GATES]))
            put(f"{prefix}bias", np.concatenate(
                [np.asarray(node[f"h{g}"]["bias"]) for g in _GATES]))
            return
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{_AUTO_NAMES.get(k, k)}.")
            elif k == "kernel":
                put(f"{prefix}weight", np.asarray(v).T)
            elif k == "scale":
                put(f"{prefix}weight", np.asarray(v))
            else:
                put(f"{prefix}{k}", np.asarray(v))

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
            node = node.setdefault(_PORT_NAMES.get(p, p), {})
        arr = t.detach().cpu().numpy()
        prefix = name[: len(name) - len(leaf)]
        if leaf in ("weight_ih", "weight_hh"):
            for g, w in zip(_GATES, np.split(arr, 4)):
                node.setdefault(f"{leaf[-2]}{g}", {})["kernel"] = w.T.copy()
        elif leaf == "bias" and f"{prefix}weight_hh" in state_dict:
            for g, b in zip(_GATES, np.split(arr, 4)):
                node.setdefault(f"h{g}", {})["bias"] = b
        elif leaf == "weight":
            node["kernel" if arr.ndim == 2 else "scale"] = arr.T.copy()
        else:
            node[leaf] = arr
    return {"params": tree}
