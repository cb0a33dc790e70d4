"""The port's network files, upstream checkpoints and weight precision
(counterpart of pytracking_tpu/utils/loading.py).

A network file is `torch.save` of a net's state_dict at `<path>` plus a JSON
sidecar `<path>.json` naming the constructor (module, name, keyword
arguments) that builds the net it loads into, as the JAX package's
`.msgpack` files carry theirs. Files are read with
`torch.load(weights_only=True)` only, upstream's `.pth.tar` checkpoints too.
"""

from __future__ import annotations

import importlib
import json
import os
import pickle
import re
from typing import Optional, Tuple

import torch
from torch import nn

from pytracking_tpu_torch.utils.device import resolve_device

MODELS_PACKAGE = "pytracking_tpu_torch.models"

# The classes upstream's trainer pickles into a checkpoint beside the
# state_dict (ltr/trainers/base_trainer.py save_checkpoint: the net's
# `constructor`, the `settings` with their `env`, the `stats` meters). Each
# is read as a data-only stand-in of the same name: unpickling sets its
# attributes and runs none of upstream's code. Any other class in a file is
# refused, by name.
UPSTREAM_CLASSES = ("ltr.admin.model_constructor.NetConstructor",
                    "ltr.admin.settings.Settings",
                    "ltr.admin.local.EnvironmentSettings",
                    "ltr.admin.stats.AverageMeter",
                    "ltr.admin.stats.StatValue")


class UpstreamObject:
    """A data-only stand-in for a pickled upstream object: its attributes,
    none of its behaviour."""


# one stand-in class per upstream class, under the upstream class's name
UPSTREAM_STAND_INS = {name: type(name.rsplit(".", 1)[1], (UpstreamObject,),
                                 {"__module__": name.rsplit(".", 1)[0]})
                      for name in UPSTREAM_CLASSES}


def read_upstream_checkpoint(path: str) -> Tuple[dict, Optional[str]]:
    """The `net` state_dict and `net_type` of an upstream `.pth.tar`
    (reference ltr/admin/loading.py:35-117), read with
    `torch.load(weights_only=True)` and the stand-ins of UPSTREAM_CLASSES. A
    file that is a bare state_dict gives (it, None). A class outside the
    list raises pickle.UnpicklingError naming it."""
    pairs = [(cls, name) for name, cls in UPSTREAM_STAND_INS.items()]
    try:
        with torch.serialization.safe_globals(pairs):
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        found = re.search(r"GLOBAL (\S+)", str(e))
        raise pickle.UnpicklingError(
            f"{path} pickles {found.group(1) if found else 'an object'}, which is not among "
            f"the upstream classes read as data ({', '.join(UPSTREAM_CLASSES)})") from e
    if isinstance(ckpt, dict) and "net" in ckpt:
        return ckpt["net"], ckpt.get("net_type")
    return ckpt, None


def save_network(path: str, state_dict, constructor_module: str, constructor_name: str,
                 constructor_kwargs: dict) -> None:
    """Write `state_dict` (on the CPU) to `path` through `path + '.tmp'`, then
    the sidecar `path + '.json'` with the constructor that builds its net
    (reference base_trainer.py:95-125 keeps the pickled constructor; the
    port keeps JSON)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)
    meta = {"constructor_module": constructor_module,
            "constructor_name": constructor_name,
            "constructor_kwargs": constructor_kwargs}
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)


def load_network(path: str, device="cuda", **overrides) -> nn.Module:
    """The net of the network file `path`: built by its sidecar's
    constructor (its keyword arguments updated by `overrides`, e.g.
    `backbone_dtype`) on the CPU, loaded with strict=True, then moved to
    `device` in eval mode. The constructor must live under
    pytracking_tpu_torch.models: a JAX package sidecar (pytracking_tpu.models)
    is refused, and nothing it names is imported."""
    device = resolve_device(device)
    with open(path + ".json") as f:
        meta = json.load(f)
    module = meta["constructor_module"]
    if not module.startswith(MODELS_PACKAGE + "."):
        raise ValueError(f"{path}.json names the constructor module {module!r}; the port "
                         f"builds nets only from {MODELS_PACKAGE}")
    state = torch.load(path, map_location="cpu", weights_only=True)
    ctor = getattr(importlib.import_module(module), meta["constructor_name"])
    net = ctor(**{**meta["constructor_kwargs"], **overrides}, device="cpu")
    net.load_state_dict(state, strict=True)
    return net.to(device).eval()


@torch.no_grad()
def round_to_bf16_(net: nn.Module) -> nn.Module:
    """Round every float32 parameter and buffer of `net` through bfloat16, in
    place; they stay float32 tensors. The JAX package's bf16 mode stores
    them as bfloat16: where a layer computes in float32 it promotes them
    back, so the float32 layers (heads, box encoder, feature block) see the
    rounded values, as here. flax's BatchNorm with bf16 statistics computes
    its multiplier rsqrt(var + eps) * scale in bf16 arithmetic, and on a
    bf16 input (the bf16 backbone) the whole normalisation: the BatchNorms
    are marked to do the same (`BatchNorm.param_dtype`), and so are the
    filter optimisers, which compute their step length and regulariser
    from the parameters alone (`param_dtype`). A float32 net with
    rounded weights (LWL's `weights_bf16`) thus matches flax promoting bf16
    parameters to float32 activations."""
    for t in net.state_dict().values():
        if t.dtype == torch.float32:
            t.copy_(t.to(torch.bfloat16))
    for m in net.modules():
        if hasattr(m, "param_dtype"):
            m.param_dtype = torch.bfloat16
    return net
