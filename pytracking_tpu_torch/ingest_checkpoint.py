"""Upstream pytracking checkpoint (`.pth.tar`) -> the port's network file
(counterpart of scripts/ingest_checkpoint.py).

Reads the checkpoint with `torch.load(weights_only=True)` (the pickled
upstream objects beside the weights as data-only stand-ins,
`utils/loading.UPSTREAM_CLASSES`), maps its `net` state_dict to the port's
(`utils/port_weights`), and writes `<network_path>/<name>.pth` with its
constructor sidecar, where the matching parameter module looks for it
(`parameter/networks.py`):

    python -m pytracking_tpu_torch.ingest_checkpoint dimp50.pth.tar --family dimp50
    python -m pytracking_tpu_torch.ingest_checkpoint tomp50.pth.tar      # auto-detect

Every checkpoint key must be consumed (BatchNorm's batch counters and the
backbone's `fc` excepted) or the command fails, unless --allow_unconsumed is
given; every key of the port's net must be found in the checkpoint. It
prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from pytracking_tpu_torch.utils import port_weights as pw
from pytracking_tpu_torch.utils.loading import read_upstream_checkpoint, save_network

# family -> (porter, network file name, constructor module, name, kwargs,
#            upstream net_type for auto-detection)
_M = "pytracking_tpu_torch.models"
REGISTRY = {
    "dimp50": (pw.port_dimpnet, "dimp50", f"{_M}.tracking.dimpnet", "dimpnet50", {}, None),
    "super_dimp": (pw.port_dimpnet, "super_dimp", f"{_M}.tracking.dimpnet", "dimpnet50", {},
                   None),
    "super_dimp_simple": (pw.port_dimpnet, "super_dimp_simple", f"{_M}.tracking.dimpnet",
                          "dimpnet50_simple", {}, "SimpleSuperDiMPnet"),
    "dimp18": (pw.port_dimpnet, "dimp18", f"{_M}.tracking.dimpnet", "dimpnet18", {}, None),
    "prdimp50": (pw.port_dimpnet, "prdimp50", f"{_M}.tracking.dimpnet", "klcedimpnet50", {},
                 "KLDiMPnet"),
    "prdimp18": (pw.port_dimpnet, "prdimp18", f"{_M}.tracking.dimpnet", "klcedimpnet18", {},
                 None),
    "atom": (pw.port_atomnet, "atom_default", f"{_M}.tracking.atomnet", "atom_resnet18", {},
             "ATOMnet"),
    "kys": (pw.port_kysnet, "kys", f"{_M}.tracking.kysnet", "kysnet_res50", {}, "KYSNet"),
    "lwl": (pw.port_lwlnet, "lwl_stage2", f"{_M}.lwl.lwl_net", "steepest_descent_resnet50",
            {"filter_size": 3, "num_filters": 16, "optim_iter": 5, "out_feature_dim": 512,
             "label_encoder_dims": [16, 32, 64]}, "LWTLNet"),
    "rts50": (pw.port_rtsnet, "rts50", f"{_M}.rts.rts_net", "rts50", {}, "RTSNet"),
    "sta": (pw.port_stanet, "sta", f"{_M}.lwl.sta_net", "sta_resnet50",
            {"clf_feat_blocks": 0, "clf_final_conv": True}, "STANet"),
    "tomp50": (pw.port_tompnet, "tomp50", f"{_M}.tracking.tompnet", "tompnet50",
               {"feature_sz": 18}, None),
    "tomp101": (pw.port_tompnet, "tomp101", f"{_M}.tracking.tompnet", "tompnet101",
                {"feature_sz": 18}, None),
    "tamos_resnet50": (pw.port_tamosnet, "tamos_resnet50", f"{_M}.tracking.tamosnet",
                       "tamosnet_resnet50", {"feature_sz": 36, "num_tokens": 10}, "TaMOsNet"),
    "keep_track_tcm": (pw.port_tcm, "keep_track_tcm", f"{_M}.tcm.target_candidate_matching",
                       "target_candidate_matching_net_resnet50", {"image_shape": [480, 480]},
                       "TargetCandiateMatchingNet"),
}


def detect_family(ckpt, path: str) -> str:
    """The family of a loaded checkpoint: by its `net_type`, then by the file
    name, then by its keys."""
    net_type = ckpt.get("net_type") if isinstance(ckpt, dict) else None
    base = os.path.basename(path).lower()
    for fam, (*_, ref_type) in REGISTRY.items():
        if net_type and ref_type == net_type:
            return fam
    for fam in sorted(REGISTRY, key=len, reverse=True):
        if fam.replace("_", "") in base.replace("_", "").replace("-", ""):
            return fam
    sd = ckpt.get("net", ckpt) if isinstance(ckpt, dict) else ckpt
    keys = set(sd)
    if any(k.startswith("predictor.") for k in keys):
        return "kys"
    if any("fpn" in k for k in keys):
        return "tamos_resnet50"
    if any(k.startswith("head.filter_predictor") for k in keys):
        return "tomp50"
    if any(k.startswith("clf_encoder") for k in keys):
        return "rts50"
    if any(k.startswith("bbox_encoder") for k in keys):
        return "sta"
    if any(k.startswith("target_model_segm") for k in keys):
        return "lwl"
    raise SystemExit(f"cannot auto-detect family for {path} "
                     f"(net_type={net_type!r}); pass --family")


def build_net(family: str):
    """The family's port net on the CPU (weights from the constructor's seed,
    to be overwritten)."""
    import importlib

    _, _, module, name, kwargs, _ = REGISTRY[family]
    return getattr(importlib.import_module(module), name)(**kwargs, device="cpu")


def ingest(path: str, family=None, out_dir=None, allow_unconsumed=False) -> dict:
    """Ingest the upstream checkpoint `path`; returns what `main` prints."""
    state_dict, net_type = read_upstream_checkpoint(path)
    family = family or detect_family({"net": state_dict, "net_type": net_type}, path)
    porter, out_name, module, name, kwargs, _ = REGISTRY[family]
    tsd = pw.TrackingStateDict(state_dict)
    ported = porter(tsd, build_net(family))
    unconsumed = sorted(tsd.unconsumed())
    if unconsumed:
        msg = (f"{family}: {len(unconsumed)} checkpoint keys NOT consumed: "
               f"{unconsumed[:20]}")
        if not allow_unconsumed:
            raise SystemExit("FATAL " + msg + "  (use --allow_unconsumed to force)")
        print("WARNING " + msg, file=sys.stderr)
    if out_dir is None:
        from pytracking_tpu_torch.evaluation.environment import env_settings
        out_dir = env_settings().network_path
    out = os.path.join(out_dir, out_name + ".pth")
    save_network(out, ported, module, name, kwargs)
    return {"family": family, "out": out, "ckpt_keys": len(tsd),
            "constructor": f"{module}.{name}", "kwargs": kwargs}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkpoint", help="upstream .pth.tar path")
    ap.add_argument("--family", choices=sorted(REGISTRY), default=None)
    ap.add_argument("--out_dir", default=None,
                    help="override env_settings().network_path")
    ap.add_argument("--allow_unconsumed", action="store_true",
                    help="warn instead of fail on unconsumed checkpoint keys")
    args = ap.parse_args(argv)
    print(json.dumps(ingest(args.checkpoint, args.family, args.out_dir,
                            args.allow_unconsumed)))


if __name__ == "__main__":
    main()
