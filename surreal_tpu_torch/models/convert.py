"""Carries flax parameters across to the port's modules.

flax `Dense` kernels are (in, out); `nn.Linear` weights are (out, in).
The flax tree `{'params': {torso: {'dense_i': {kernel, bias}}, mean_head,
value_head, log_std}}` maps to state-dict names `torso.dense_i.weight`
etc. Input is the tree with numpy leaves (e.g. `jax.device_get(params)`).

Four more forms:
- flax names unnamed sub-modules by class (`MLP_0`, `Dense_0`,
  `LayerNorm_0` in the DDPG nets); the port's attributes are `torso`,
  `head` and `layer_norm`. The conv stem is `stem` in the port; in flax
  it is `stem` in the actor-critic, `ConvStem_0` in the compact DDPG nets,
  and the root of a bare `ConvStem`'s tree, so the caller names it
  (`stem_key`: 'stem', 'ConvStem_0' or ''). Inside a conv stem, flax's
  `Conv_i` and `Dense_0` are `conv_i` and `dense`;
- a flax `Conv` kernel is (kh, kw, in, out); a `Conv2d` weight is (out, in,
  kh, kw): permute(3, 2, 0, 1), not a transpose, which would swap kh and kw;
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
_STEM_NAMES = {"Conv_0": "conv_0", "Conv_1": "conv_1", "Conv_2": "conv_2", "Dense_0": "dense"}
_PORT_NAMES = {v: k for k, v in _AUTO_NAMES.items()}
_PORT_STEM_NAMES = {v: k for k, v in _STEM_NAMES.items()}
_GATES = "ifgo"
_LSTM_KEYS = {f"{side}{g}" for side in "ih" for g in _GATES}


def params_from_flax(flax_params: Mapping[str, Any],
                     stem_key: str = "stem") -> dict[str, torch.Tensor]:
    tree = flax_params.get("params", flax_params)
    auto = {**_AUTO_NAMES, stem_key: "stem"}
    out: dict[str, torch.Tensor] = {}

    def put(name, array):
        out[name] = torch.tensor(np.ascontiguousarray(array))  # copies

    def walk(node, prefix, names):
        if set(node) == _LSTM_KEYS:
            for side in "ih":
                put(f"{prefix}weight_{side}h", np.concatenate(
                    [np.asarray(node[f"{side}{g}"]["kernel"]).T for g in _GATES]))
            put(f"{prefix}bias", np.concatenate(
                [np.asarray(node[f"h{g}"]["bias"]) for g in _GATES]))
            return
        for k, v in node.items():
            if isinstance(v, Mapping):
                name = names.get(k, k)
                walk(v, f"{prefix}{name}.", _STEM_NAMES if name == "stem" else auto)
            elif k == "kernel":
                v = np.asarray(v)
                put(f"{prefix}weight", v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T)
            elif k == "scale":
                put(f"{prefix}weight", np.asarray(v))
            else:
                put(f"{prefix}{k}", np.asarray(v))

    walk(tree, "", _STEM_NAMES if stem_key == "" else auto)
    return out


def params_to_flax(state_dict: Mapping[str, torch.Tensor],
                   stem_key: str = "stem") -> dict[str, Any]:
    """Inverse of `params_from_flax` (numpy leaves), for comparing a trained
    port module with the reference's parameter tree."""
    tree: dict[str, Any] = {}
    names = {**_PORT_NAMES, "stem": stem_key or "stem"}
    for name, t in state_dict.items():
        *path, leaf = (("stem." if stem_key == "" else "") + name).split(".")
        node = tree
        for i, p in enumerate(path):
            in_stem = i > 0 and path[i - 1] == "stem"
            node = node.setdefault((_PORT_STEM_NAMES if in_stem else names).get(p, p), {})
        arr = t.detach().cpu().numpy()
        prefix = name[: len(name) - len(leaf)]
        if leaf in ("weight_ih", "weight_hh"):
            for g, w in zip(_GATES, np.split(arr, 4)):
                node.setdefault(f"{leaf[-2]}{g}", {})["kernel"] = w.T.copy()
        elif leaf == "bias" and f"{prefix}weight_hh" in state_dict:
            for g, b in zip(_GATES, np.split(arr, 4)):
                node.setdefault(f"h{g}", {})["bias"] = b
        elif leaf == "weight" and arr.ndim == 4:
            node["kernel"] = arr.transpose(2, 3, 1, 0).copy()
        elif leaf == "weight":
            node["kernel" if arr.ndim == 2 else "scale"] = arr.T.copy()
        else:
            node[leaf] = arr
    return {"params": tree["stem"] if stem_key == "" else tree}


def flax_leaves(shapes: Mapping[str, tuple[int, ...]], stem_key: str = "stem"):
    """The leaves of `params_to_flax`'s tree for parameters of these shapes
    (name -> shape, in the module's order), in JAX's flatten order (a
    dict's keys sorted, at every level: `ravel_pytree`'s order): a list of
    (flax path, port name, flat indices). The flat indices say where each
    element of the leaf, in its row-major order, sits in the concatenation
    of the port's flattened parameters; a port parameter may give several
    leaves (the LSTM's gates)."""
    index, starts, n = {}, [], 0
    for name, shape in shapes.items():
        size = int(np.prod(shape, dtype=np.int64))
        index[name] = torch.arange(n, n + size, dtype=torch.int64).reshape(shape)
        starts.append((n, name))
        n += size
    out = []

    def walk(node, path):
        for k in sorted(node):
            if isinstance(node[k], Mapping):
                walk(node[k], path + (k,))
            else:
                flat = np.asarray(node[k]).reshape(-1)
                owner = max((s for s in starts if s[0] <= flat[0]), key=lambda s: s[0])[1]
                out.append((path + (k,), owner, flat))

    walk(params_to_flax(index, stem_key), ())
    return out
