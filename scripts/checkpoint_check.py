#!/usr/bin/env python3
"""Upstream-format checkpoints from the port's nets, to check the loader.

No published upstream `.pth.tar` is in the repository. This script writes
files in upstream's layout from a port net's weights: `upstream_state_dict`
names every tensor as upstream's modules do and gives it upstream's layout
(the inverse of `pytracking_tpu_torch.utils.port_weights`), with BatchNorm's
batch counters and ToMP's aliased query embedding as upstream's state_dict
holds them; `write_upstream_checkpoint` saves it as upstream's trainer does,
a dict with `net`, `net_type`, `epoch` and a pickled
`ltr.admin.model_constructor.NetConstructor` (a stand-in class registered
under that module only while saving). tests/test_torch_port_weights.py holds
these files against the JAX package's porters; `chip_smoke.py` ingests them
on the card.

    python3 scripts/checkpoint_check.py write dimp50 /tmp/dimp50.pth.tar [seed]
    python3 scripts/checkpoint_check.py roundtrip [family ...]

`write` saves the family's net drawn from `seed` (default 7) on the CPU;
`roundtrip` writes, ingests and loads each family (all by default) in a
temporary directory and prints whether the loaded net equals the source bit
for bit. Neither imports JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import sys
import tempfile
import time
import types
from collections import OrderedDict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pytracking_tpu_torch.utils import port_weights as pw  # noqa: E402


def upstream_state_dict(porter: pw.Porter, state_dict) -> "OrderedDict[str, torch.Tensor]":
    """The port's `state_dict` in upstream's names and layouts (float32 on
    the CPU), for the family of `porter`."""
    layout = porter.layout(list(state_dict))
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    in_proj = {}
    for key, value in state_dict.items():
        up, kind = layout[key]
        arr = value.detach().cpu().float().numpy()
        if kind in pw.IN_PROJ:
            in_proj.setdefault(up, {})[pw.IN_PROJ.index(kind)] = arr
            out.setdefault(up, None)              # keeps the key's place
            continue
        out[up] = torch.from_numpy(np.array(pw.to_upstream(arr, kind)))
        if up.endswith(".running_var"):
            out[up[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    for up, parts in in_proj.items():
        out[up] = torch.from_numpy(np.concatenate([parts[i] for i in range(3)]))
    for alias, source in porter.aliases.items():
        out[alias] = out[source]
    return out


class NetConstructor:
    """Upstream's ltr.admin.model_constructor.NetConstructor: the function
    name, module and arguments that build the net."""

    def __init__(self, fun_name, fun_module, args, kwds):
        self.fun_name, self.fun_module, self.args, self.kwds = fun_name, fun_module, args, kwds


@contextlib.contextmanager
def _upstream_modules():
    """NetConstructor importable as ltr.admin.model_constructor.NetConstructor
    (pickle records a class by its module and name) while saving only."""
    names = ("ltr", "ltr.admin", "ltr.admin.model_constructor")
    saved = {n: sys.modules.get(n) for n in names}
    mods = {n: types.ModuleType(n) for n in names}
    mods["ltr.admin.model_constructor"].NetConstructor = NetConstructor
    old = NetConstructor.__module__
    NetConstructor.__module__ = "ltr.admin.model_constructor"
    sys.modules.update(mods)
    try:
        yield
    finally:
        NetConstructor.__module__ = old
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


def write_upstream_checkpoint(path: str, porter: pw.Porter, state_dict, net_type: str,
                              fun_name: str = "net", fun_module: str = "ltr.models") -> int:
    """Save the port's `state_dict` as an upstream `.pth.tar` at `path`;
    returns its size in bytes."""
    ckpt = {"epoch": 50, "net_type": net_type, "net": upstream_state_dict(porter, state_dict),
            "net_info": None,
            "constructor": NetConstructor(fun_name, fun_module, (), {"backbone_pretrained": True})}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with _upstream_modules():
        torch.save(ckpt, path)
    return os.path.getsize(path)


def seeded_net(family: str, seed: int, device="cpu"):
    """The registry family's port net with weights drawn from `seed`."""
    from pytracking_tpu_torch.ingest_checkpoint import REGISTRY

    _, _, module, name, kwargs, _ = REGISTRY[family]
    return getattr(importlib.import_module(module), name)(
        **kwargs, generator=torch.Generator().manual_seed(seed), device=device)


def write_family(family: str, path: str, seed: int = 7) -> int:
    """An upstream file of the registry family from its net drawn from `seed`."""
    from pytracking_tpu_torch.ingest_checkpoint import REGISTRY

    porter, _, _, name, _, net_type = REGISTRY[family]
    return write_upstream_checkpoint(path, porter, seeded_net(family, seed).state_dict(),
                                     net_type or "net", fun_name=name)


def main(argv):
    if argv[:1] == ["write"] and len(argv) in (3, 4):
        size = write_family(argv[1], argv[2], int(argv[3]) if len(argv) == 4 else 7)
        print(f"{argv[2]}: {size} bytes")
        return 0
    if argv[:1] == ["roundtrip"]:
        from pytracking_tpu_torch.ingest_checkpoint import REGISTRY, ingest
        from pytracking_tpu_torch.utils.loading import load_network

        ok = True
        with tempfile.TemporaryDirectory() as d:
            for family in argv[1:] or sorted(REGISTRY):
                src = seeded_net(family, 7).state_dict()
                path = os.path.join(d, f"{family}.pth.tar")
                write_upstream_checkpoint(path, REGISTRY[family][0], src,
                                          REGISTRY[family][5] or "net")
                t0 = time.perf_counter()
                out = ingest(path, family, out_dir=d)["out"]
                net = load_network(out, device="cpu")
                same = all(torch.equal(v, src[k]) for k, v in net.state_dict().items())
                ok &= same and set(net.state_dict()) == set(src)
                print(f"{family}: {os.path.getsize(path)} bytes; ingest + load "
                      f"{time.perf_counter() - t0:.1f} s; loaded equals source: {same}")
        return 0 if ok else 1
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
