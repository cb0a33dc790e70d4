"""Flax variables of the JAX package's TaMOsNet -> state_dict of the port's
TaMOsNet.

Input is the JAX package's `{"params": ..., "batch_stats": ...}` tree as
nested dicts of numpy arrays (np.asarray of each leaf), so this module
imports no JAX. Conversions:
  * Conv kernels HWIO -> OIHW; Dense kernels (in, out) -> (out, in);
  * attention projections (d, H, hd) -> (H*hd, d) and (H, hd, d) -> (d, H*hd),
    biases (H, hd) -> (H*hd,);
  * norm scale -> weight; BatchNorm mean/var -> running_mean/running_var;
  * the scanned encoder/decoder stacks (leading layer axis) are unstacked
    into `encoder.{i}` / `decoder.{i}`.
Every flax leaf is consumed by construction (an unknown one raises); with
`net` given, the result must hold exactly the net's keys and shapes.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

_MHA = "MultiHeadDotProductAttention_0"
_STACK_NAMES = {
    "encoder": {"_MHA_0": "self_attn", "LayerNorm_0": "norm1", "LayerNorm_1": "norm2",
                "Dense_0": "linear1", "Dense_1": "linear2"},
    "decoder": {"_MHA_0": "self_attn", "_MHA_1": "cross_attn", "LayerNorm_0": "norm1",
                "LayerNorm_1": "norm2", "LayerNorm_2": "norm3", "Dense_0": "linear1",
                "Dense_1": "linear2"},
}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _torch_module_path(path: tuple) -> tuple:
    """Flax module path -> (torch module path, layer index or None)."""
    for stack, names in _STACK_NAMES.items():
        if stack in path and path[path.index(stack) + 1:path.index(stack) + 2] == ("layer",):
            i = path.index(stack)
            rest = path[i + 2:]
            if not rest or rest[0] not in names:
                raise KeyError(f"unknown {stack} submodule {'/'.join(path)}")
            sub = (names[rest[0]],) + tuple(p for p in rest[1:] if p != _MHA)
            return path[:i + 1], sub
    return path, None


def _convert_leaf(module_path: tuple, leaf: str, arr: np.ndarray) -> tuple:
    """One flax leaf of one (unstacked) module -> (torch name, array)."""
    name = module_path[-1] if module_path else ""
    if leaf == "kernel":
        if name in ("query", "key", "value"):             # (d, H, hd)
            return "weight", arr.reshape(arr.shape[0], -1).T
        if name == "out":                                  # (H, hd, d)
            return "weight", arr.reshape(-1, arr.shape[-1]).T
        if arr.ndim == 4:                                  # HWIO
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:
            return "weight", arr.T
        raise ValueError(f"unexpected kernel {'/'.join(module_path)} {arr.shape}")
    if leaf == "bias":
        return "bias", arr.reshape(-1) if name in ("query", "key", "value") else arr
    if leaf == "scale":
        return "weight", arr
    if leaf == "mean":
        return "running_mean", arr
    if leaf == "var":
        return "running_var", arr
    if leaf == "query_embed_fg":
        return "query_embed_fg", arr
    raise KeyError(f"unknown flax leaf {'/'.join(module_path + (leaf,))}")


def tamosnet_from_flax(variables: Mapping,
                       net: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Convert the flax variables of a TaMOsNet into the port's state_dict.
    With `net`, raise unless the keys and shapes are exactly the net's."""
    flat = {}
    for collection in ("params", "batch_stats"):
        flat.update(_flatten(variables.get(collection, {})))
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise KeyError(f"unconverted flax collections {sorted(extra)}")

    sd: Dict[str, torch.Tensor] = {}

    def put(key: str, arr: np.ndarray):
        if key in sd:
            raise KeyError(f"two flax leaves map to {key}")
        sd[key] = torch.from_numpy(np.array(arr, dtype=np.float32))

    for path, arr in flat.items():
        module_path, leaf = path[:-1], path[-1]
        stack_path, sub = _torch_module_path(module_path)
        if sub is None:
            tname, tarr = _convert_leaf(module_path, leaf, arr)
            put(".".join(module_path + (tname,)), tarr)
            continue
        for layer in range(arr.shape[0]):
            tname, tarr = _convert_leaf(sub, leaf, arr[layer])
            put(".".join(stack_path + (str(layer),) + sub + (tname,)), tarr)

    if net is not None:
        expected = net.state_dict()
        missing = sorted(set(expected) - set(sd))
        unexpected = sorted(set(sd) - set(expected))
        if missing or unexpected:
            raise KeyError(f"torch keys without a flax leaf: {missing}; "
                           f"flax leaves without a torch key: {unexpected}")
        bad = [k for k in sd if tuple(sd[k].shape) != tuple(expected[k].shape)]
        if bad:
            raise ValueError("shape mismatch: " + ", ".join(
                f"{k} {tuple(sd[k].shape)} vs {tuple(expected[k].shape)}" for k in bad))
    return sd
