"""Flax variables of the JAX package's TaMOsNet, ToMPnet, DiMPnet, KYSNet,
KeepTrack's target candidate matching net, LWL's LWTLNet and LWTLBoxNet,
STANet, RTSNet, ATOMnet and ECO's backbones (ResNet18VGGm1,
MobileNetV3Large, and their wrapper) -> state_dicts of the port's nets.

Input is the JAX package's `{"params": ..., "batch_stats": ...}` tree as
nested dicts of numpy arrays (np.asarray of each leaf), so this module
imports no JAX. Conversions:
  * Conv kernels HWIO -> OIHW; Dense kernels (in, out) -> (out, in);
  * attention projections (d, H, hd) -> (H*hd, d) and (H, hd, d) -> (d, H*hd),
    biases (H, hd) -> (H*hd,);
  * norm scale -> weight; BatchNorm mean/var -> running_mean/running_var;
  * the scanned encoder/decoder stacks (leading layer axis) are unstacked
    into `encoder.{i}` / `decoder.{i}` (TaMOs, ToMP);
  * the learned tokens (`query_embed_fg`, `query_embed_test`) and Swin's
    relative position bias tables keep their names and shapes;
  * IoU-Net's LinearBlock Dense kernels flatten NHWC RoIs in (h, w, c)
    order, the port flattens (c, h, w): their rows are permuted (DiMP);
  * the DiMP optimiser's parameters keep their names and shapes;
  * KYS's response predictor and the matching net's SuperGlue are plain
    convolutions, dense layers and BatchNorms under the flax names; the
    matcher's scalar `bin_score` keeps its name;
  * the LWL target models' `filter_reg` keeps its name and shape; STA's two
    target models share one feature block, held under `target_model` in
    both trees.
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
    if leaf in ("query_embed_fg", "query_embed_test", "rel_pos_bias", "bin_score",
                "filter_reg"):
        return leaf, arr
    raise KeyError(f"unknown flax leaf {'/'.join(module_path + (leaf,))}")


def _flat_variables(variables: Mapping) -> Dict[tuple, np.ndarray]:
    flat = {}
    for collection in ("params", "batch_stats"):
        flat.update(_flatten(variables.get(collection, {})))
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise KeyError(f"unconverted flax collections {sorted(extra)}")
    return flat


def _put(sd: Dict[str, torch.Tensor], key: str, arr: np.ndarray) -> None:
    if key in sd:
        raise KeyError(f"two flax leaves map to {key}")
    sd[key] = torch.from_numpy(np.array(arr, dtype=np.float32))


def _check_against(sd: Dict[str, torch.Tensor], net: Optional[nn.Module]) -> None:
    """Raise unless sd holds exactly the net's keys, at the net's shapes."""
    if net is None:
        return
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


def tamosnet_from_flax(variables: Mapping,
                       net: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Convert the flax variables of a TaMOsNet (ResNet-50 or Swin-Base
    backbone) into the port's state_dict. With `net`, raise unless the keys
    and shapes are exactly the net's."""
    return _net_from_flax(variables, net)


def tompnet_from_flax(variables: Mapping,
                      net: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Convert the flax variables of a ToMPnet into the port's state_dict.
    With `net`, raise unless the keys and shapes are exactly the net's."""
    return _net_from_flax(variables, net)


def _net_from_flax(variables: Mapping, net: Optional[nn.Module]) -> Dict[str, torch.Tensor]:
    """Each flax leaf under its module path as the torch name, the scanned
    encoder/decoder stacks unstacked."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in _flat_variables(variables).items():
        module_path, leaf = path[:-1], path[-1]
        stack_path, sub = _torch_module_path(module_path)
        if sub is None:
            tname, tarr = _convert_leaf(module_path, leaf, arr)
            _put(sd, ".".join(module_path + (tname,)), tarr)
            continue
        for layer in range(arr.shape[0]):
            tname, tarr = _convert_leaf(sub, leaf, arr[layer])
            _put(sd, ".".join(stack_path + (str(layer),) + sub + (tname,)), tarr)
    _check_against(sd, net)
    return sd


_DIMP_OPTIMIZER_LEAVES = ("log_step_length", "filter_reg", "label_map_w", "target_mask_w",
                          "spatial_weight_w")
# IoU-Net LinearBlocks and the (h, w) of the RoI each flattens
_LINEAR_BLOCK_HW = {"fc3_rt": (5, 5), "fc4_rt": (3, 3)}


def dimpnet_from_flax(variables: Mapping,
                      net: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Convert the flax variables of a DiMPnet into the port's state_dict.
    With `net`, raise unless the keys and shapes are exactly the net's."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in _flat_variables(variables).items():
        module_path, leaf = path[:-1], path[-1]
        if module_path[-1:] == ("filter_optimizer",) and leaf in _DIMP_OPTIMIZER_LEAVES:
            tname, tarr = leaf, arr
        elif leaf == "kernel" and len(module_path) >= 2 and module_path[-2] in _LINEAR_BLOCK_HW:
            h, w = _LINEAR_BLOCK_HW[module_path[-2]]
            n_in, n_out = arr.shape
            tname = "weight"
            tarr = arr.reshape(h, w, n_in // (h * w), n_out).transpose(3, 2, 0, 1).reshape(
                n_out, n_in)
        else:
            tname, tarr = _convert_leaf(module_path, leaf, arr)
        _put(sd, ".".join(module_path + (tname,)), tarr)
    _check_against(sd, net)
    return sd


def kysnet_from_flax(variables: Mapping,
                     net: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Convert the flax variables of a KYSNet (the DiMPnet tree merged with
    the response predictor's `predictor` tree) into the port's state_dict.
    With `net`, raise unless the keys and shapes are exactly the net's."""
    return dimpnet_from_flax(variables, net)


def tcmnet_from_flax(variables: Mapping,
                     net: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Convert the flax variables of a TargetCandidateMatchingNetwork (its
    ResNet, the descriptor conv, the SuperGlue graph net, `final_proj` and
    `bin_score`) into the port's state_dict. With `net`, raise unless the
    keys and shapes are exactly the net's."""
    return _net_from_flax(variables, net)


def lwtlnet_from_flax(variables: Mapping,
                      net: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Convert the flax variables of an LWTLNet into the port's state_dict.
    With `net`, raise unless the keys and shapes are exactly the net's."""
    return _net_from_flax(variables, net)


def lwtlboxnet_from_flax(variables: Mapping,
                         net: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Convert the flax variables of an LWTLBoxNet (LWL's tree merged with
    the box label encoder's) into the port's state_dict. With `net`, raise
    unless the keys and shapes are exactly the net's."""
    return _net_from_flax(variables, net)


def stanet_from_flax(variables: Mapping,
                     net: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Convert the flax variables of an STANet into the port's state_dict.
    With `net`, raise unless the keys and shapes are exactly the net's."""
    return _net_from_flax(variables, net)


def rtsnet_from_flax(variables: Mapping,
                     net: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Convert the flax variables of an RTSNet (the hinge optimiser has no
    parameters) into the port's state_dict. With `net`, raise unless the
    keys and shapes are exactly the net's."""
    return _net_from_flax(variables, net)


def atomnet_from_flax(variables: Mapping,
                      net: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Convert the flax variables of an ATOMnet (backbone and IoU-Net) into
    the port's state_dict. With `net`, raise unless the keys and shapes are
    exactly the net's."""
    return dimpnet_from_flax(variables, net)


def resnet18_vggm_from_flax(variables: Mapping,
                            net: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Convert the flax variables of a ResNet18VGGm1 into the port's
    state_dict. With `net`, raise unless the keys and shapes are exactly the
    net's."""
    return _net_from_flax(variables, net)


def mobilenet3_from_flax(variables: Mapping,
                         net: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Convert the flax variables of a MobileNetV3Large (depthwise kernels
    (kh, kw, 1, C) -> (C, 1, kh, kw)) into the port's state_dict. With `net`,
    raise unless the keys and shapes are exactly the net's."""
    return _net_from_flax(variables, net)


def eco_backbone_from_flax(variables: Mapping,
                           net: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Convert the flax variables of ECO's backbone wrapper (either backbone
    under `feature_extractor`) into the port's state_dict. With `net`, raise
    unless the keys and shapes are exactly the net's."""
    return _net_from_flax(variables, net)
