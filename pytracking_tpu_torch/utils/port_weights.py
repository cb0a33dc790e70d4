"""Upstream pytracking `state_dict`s -> the port's (counterpart of
pytracking_tpu/utils/port_weights.py).

Upstream's trainer saves `net.state_dict()` of its torch nets (the `net`
entry of a `.pth.tar`). The port's nets keep the JAX package's module names
(`layer3_2`, `tower0_gn`, `Conv_0`, ...), so the map from an upstream name to
the port's is a renaming of module paths. The layouts are torch's on both
sides (OIHW convolutions, (out, in) linear layers), so the values are copied,
except for:
  * the DiMP optimiser's 1x1 bin-predictor convolutions (1, bins, 1, 1),
    which the port holds as (bins,) vectors;
  * the Conv1d(k=1) layers of the box encoders and of the matcher's graph
    net (out, in, 1), which the port holds as Linear (out, in);
  * nn.MultiheadAttention's `in_proj_weight` / `in_proj_bias` (3d, ...),
    which the port splits into its query, key and value projections.
IoU-Net's LinearBlocks need no permutation: upstream and the port both
flatten the pooled RoI in (c, h, w) order (the JAX package, which flattens
NHWC, permutes twice).

Each `port_*` function is driven by the net it loads into: every key of
`net.state_dict()` is named in upstream's layout and read from the upstream
dict, so the ResNet's depth and block kind and the feature blocks' count
come from the net, where the JAX functions take them as arguments. A key the
net needs and the file lacks raises, naming both; an upstream key that no
key of the net reads stays unconsumed in the `TrackingStateDict`, for the
caller to refuse (`ingest_checkpoint` does, by name). Neither this module nor its callers
import JAX or the JAX package.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

# how an upstream value becomes the port's (None: as it is)
BINS = "bins"                # (1, bins, 1, 1) -> (bins,)
CONV1D = "conv1d"            # (out, in, 1) -> (out, in)
IN_PROJ = ("in_proj_q", "in_proj_k", "in_proj_v")   # rows [i*d, (i+1)*d) of in_proj_*

Rule = Tuple[str, Union[str, Callable[[re.Match], str]]]


class TrackingStateDict(dict):
    """An upstream state_dict (values as numpy arrays) that records the keys
    read from it, so that a file cannot lose weights silently on the way in
    (`unconsumed`)."""

    def __init__(self, state_dict):
        super().__init__({k: np.asarray(v) for k, v in state_dict.items()})
        self.consumed = set()

    def __getitem__(self, key):
        self.consumed.add(key)
        return super().__getitem__(key)

    def get(self, key, default=None):
        if key in self:
            return self[key]
        return default

    def unconsumed(self, ignore_suffixes=("num_batches_tracked",)):
        """Keys never read, but BatchNorm's batch counters and the
        backbone's ImageNet classifier (`fc.*`), which no tracker runs."""
        return {k for k in self
                if k not in self.consumed and not k.endswith(ignore_suffixes)
                and not re.search(r"(^|\.)fc\.(weight|bias)$", k)}


def _index_map(pattern: str, prefix: str, suffix: Callable[[int], str]) -> Rule:
    """A rule renaming `pattern`'s match (one integer group) to
    prefix + suffix(group)."""
    return pattern, lambda m: prefix + suffix(int(m.group(1)))


def _resnet(port: str, up: str) -> List[Rule]:
    """A torchvision ResNet (`layer{s}.{b}`, `downsample.0/1`) under `up`
    <- the port's ResNet (`layer{s}_{b}`, `downsample_conv/bn`) under `port`."""
    p = re.escape(port)
    return [(rf"^{p}layer(\d+)_(\d+)\.downsample_conv\.", rf"{up}layer\1.\2.downsample.0."),
            (rf"^{p}layer(\d+)_(\d+)\.downsample_bn\.", rf"{up}layer\1.\2.downsample.1."),
            (rf"^{p}layer(\d+)_(\d+)\.", rf"{up}layer\1.\2."),
            (rf"^{p}(conv1|bn1)\.", rf"{up}\1.")]


def _feature_blocks(port: str, up: str, keys: Iterable[str]) -> List[Rule]:
    """A feature Sequential (its residual blocks `0..n-1`, then the final
    conv as `n`) under `up` <- the port's `block{i}` and `final_conv` under
    `port`, n counted in the net's keys."""
    p = re.escape(port)
    n = len({m.group(1) for k in keys for m in [re.match(rf"^{p}block(\d+)\.", k)] if m})
    return [(rf"^{p}block(\d+)\.downsample_conv\.", rf"{up}\1.downsample.0."),
            (rf"^{p}block(\d+)\.downsample_bn\.", rf"{up}\1.downsample.1."),
            (rf"^{p}block(\d+)\.", rf"{up}\1."),
            (rf"^{p}final_conv\.", f"{up}{n}.")]


def _conv_blocks(port: str) -> List[Rule]:
    """Sequential(conv, BatchNorm, ReLU) <- the port's ConvBlock (`Conv_0`,
    `BatchNorm_0`) anywhere under `port`."""
    p = re.escape(port)
    return [(rf"^({p}.*)\.Conv_0\.", r"\1.0."), (rf"^({p}.*)\.BatchNorm_0\.", r"\1.1.")]


def _iou_net() -> List[Rule]:
    """AtomIoUNet: its LinearBlocks' `linear` / `bn` and its conv blocks."""
    return [(r"^bb_regressor\.(fc3_rt|fc4_rt)\.Dense_0\.", r"bb_regressor.\1.linear."),
            (r"^bb_regressor\.(fc3_rt|fc4_rt)\.BatchNorm_0\.", r"bb_regressor.\1.bn."),
            *_conv_blocks("bb_regressor.")]


def _dimp_classifier(up: str, keys: Iterable[str]) -> List[Rule]:
    """LinearFilter under `up` <- the port's `classifier`: the feature
    blocks, the initializer and the optimiser's scalars and bin predictors."""
    fo = f"{up}filter_optimizer."
    return [*_feature_blocks("classifier.feature_extractor.", f"{up}feature_extractor.", keys),
            (r"^classifier\.filter_optimizer\.label_map_w$", f"{fo}label_map_predictor.weight"),
            (r"^classifier\.filter_optimizer\.target_mask_w$",
             f"{fo}target_mask_predictor.0.weight"),
            (r"^classifier\.filter_optimizer\.spatial_weight_w$",
             f"{fo}spatial_weight_predictor.weight"),
            (r"^classifier\.", up)]


_DIMP_KINDS = [(r"^classifier\.filter_optimizer\.(label_map|target_mask|spatial_weight)_w$",
                BINS)]


def _label_encoder(name: str) -> List[Rule]:
    """ResidualDS16SW / its box variants: only their conv blocks rename."""
    return _conv_blocks(f"{name}.")


def _lwl_decoder() -> List[Rule]:
    """LWTLDecoder: TSE / RRB / CAB / proj per layer, named by layer."""
    d = r"^decoder\."
    return [(rf"{d}TSE_(layer\d)\.reduce0\.", r"decoder.TSE.\1.reduce.0."),
            (rf"{d}TSE_(layer\d)\.reduce1\.", r"decoder.TSE.\1.reduce.2."),
            (rf"{d}TSE_(layer\d)\.transform(\d)\.",
             lambda m: f"decoder.TSE.{m.group(1)}.transform.{2 * int(m.group(2))}."),
            (rf"{d}(RRB\d)_(layer\d)\.conv1x1\.", r"decoder.\1.\2.conv1x1."),
            (rf"{d}(RRB\d)_(layer\d)\.bb0\.", r"decoder.\1.\2.bblock.0."),
            (rf"{d}(RRB\d)_(layer\d)\.bn\.", r"decoder.\1.\2.bblock.1."),
            (rf"{d}(RRB\d)_(layer\d)\.bb1\.", r"decoder.\1.\2.bblock.3."),
            (rf"{d}CAB_(layer\d)\.att(\d)\.",
             lambda m: f"decoder.CAB.{m.group(1)}.convreluconv.{2 * int(m.group(2))}."),
            (rf"{d}proj_(layer\d)\.", r"decoder.proj.\1.0.")]


def _lwl_target_model(keys: Iterable[str]) -> List[Rule]:
    return [*_feature_blocks("target_model.feature_extractor.",
                             "target_model.feature_extractor.", keys),
            (r"^(target_model|target_model_segm)\.filter_reg$",
             r"\1.filter_optimizer.residual_module.filter_reg")]


def _transformer(prefix: str) -> List[Rule]:
    """The DETR transformer under `prefix` (upstream's name, the port's
    prefix renamed before): its layers unstacked as `encoder.{i}` /
    `decoder.{i}`, cross-attention `cross_attn`, attention projections
    query/key/value/out."""
    p = re.escape(prefix)
    return [(rf"^{p}encoder\.(\d+)\.", rf"{prefix}encoder.layers.\1."),
            (rf"^{p}decoder\.(\d+)\.", rf"{prefix}decoder.layers.\1."),
            (rf"^{p}dec_norm\.", f"{prefix}decoder.norm."),
            (rf"^({p}.*)\.cross_attn\.", r"\1.multihead_attn."),
            (rf"^({p}.*)\.(query|key|value)\.(weight|bias)$", r"\1.in_proj_\3"),
            (rf"^({p}.*)\.out\.", r"\1.out_proj.")]


_TRANSFORMER_KINDS = [(rf"\.(self_attn|cross_attn)\.{name}\.", kind)
                      for name, kind in zip(("query", "key", "value"), IN_PROJ)]


def _tomp_head(head: str) -> List[Rule]:
    """ToMP's head under `head` (upstream's name): the filter predictor's
    learned tokens, box encoder and transformer, the classifier and the
    dense box regressor's tower."""
    h = re.escape(head)
    fp = f"{head}filter_predictor."
    return [(rf"^{h}filter_predictor\.(query_embed_fg|query_embed_test)$", r"\g<0>.weight"),
            (rf"^{h}filter_predictor\.box_encoding\.lin(\d)\.",
             lambda m: f"{fp}box_encoding.{3 * int(m.group(1))}."),
            (rf"^{h}filter_predictor\.box_encoding\.bn(\d)\.",
             lambda m: f"{fp}box_encoding.{3 * int(m.group(1)) + 1}."),
            *_transformer(f"{fp}transformer."),
            (rf"^{h}bb_regressor\.tower(\d)_conv\.",
             lambda m: f"{head}bb_regressor.tower.{3 * int(m.group(1))}."),
            (rf"^{h}bb_regressor\.tower(\d)_gn\.",
             lambda m: f"{head}bb_regressor.tower.{3 * int(m.group(1)) + 1}.")]


_TOMP_KINDS = [(r"\.box_encoding\.lin\d\.weight$", CONV1D), *_TRANSFORMER_KINDS]


def _tcm_matcher() -> List[Rule]:
    """SuperGlue: keypoint encoder and graph-net MLPs by position, the
    attention's q/k/v projections as `proj.{0,1,2}`."""
    g = r"^matcher\.gnn\.layer(\d+)\."
    return [_index_map(r"^matcher\.kenc\.encoder\.lin(\d)\.", "matcher.kenc.encoder.",
                       lambda i: f"{3 * i}."),
            _index_map(r"^matcher\.kenc\.encoder\.bn(\d)\.", "matcher.kenc.encoder.",
                       lambda i: f"{3 * i + 1}."),
            (rf"{g}attn\.proj_([qkv])\.",
             lambda m: f"matcher.gnn.layers.{m.group(1)}.update.attn.proj."
                       f"{'qkv'.index(m.group(2))}."),
            (rf"{g}attn\.merge\.", r"matcher.gnn.layers.\1.update.attn.merge."),
            (rf"{g}mlp\.lin0\.", r"matcher.gnn.layers.\1.update.mlp.0."),
            (rf"{g}mlp\.bn0\.", r"matcher.gnn.layers.\1.update.mlp.1."),
            (rf"{g}mlp\.lin1\.", r"matcher.gnn.layers.\1.update.mlp.3.")]


_TCM_KINDS = [(r"^matcher\.(kenc\.encoder\.lin\d|gnn\.layer\d+\.(attn\.(proj_[qkv]|merge)"
               r"|mlp\.lin\d)|final_proj)\.weight$", CONV1D)]

_MOBILE_PARTS = {"expand_conv": "conv.0", "expand_bn": "conv.1", "depth_conv": "depth_conv.0",
                 "depth_bn": "depth_conv.1", "se.fc0": "squeeze_block.dense.0",
                 "se.fc1": "squeeze_block.dense.2", "point_conv": "point_conv.0",
                 "point_bn": "point_conv.1"}


def _mobilenet(keys: Iterable[str]) -> List[Rule]:
    """MobileNetV3-Large: a stage of one block is `layer{s}`, else
    `layer{s}.{b}`; the block's parts by position in their Sequentials."""
    blocks: Dict[str, set] = {}
    for k in keys:
        m = re.match(r"^layer(\d+)_(\d+)\.", k)
        if m:
            blocks.setdefault(m.group(1), set()).add(m.group(2))
    parts = "|".join(re.escape(p) for p in _MOBILE_PARTS)

    def block(m):
        stage = f"layer{m.group(1)}" + ("" if len(blocks[m.group(1)]) == 1 else f".{m.group(2)}")
        return f"{stage}.{_MOBILE_PARTS[m.group(3)]}."

    return [(r"^init_conv\.", "init_conv.0."), (r"^init_bn\.", "init_conv.1."),
            (rf"^layer(\d+)_(\d+)\.({parts})\.", block),
            (r"^out_conv1\.", "out_conv1.0."), (r"^out_bn1\.", "out_conv1.1.")]


class Porter:
    """The map from one family's upstream state_dict to the port's.

    `rules(keys)` gives the renaming rules for a net with these keys: each
    (pattern, replacement) is applied in turn with `re.sub` to a port key,
    giving its upstream name. `kinds` are (pattern, kind) pairs on port keys
    for the values that change layout. `aliases` maps upstream keys that
    hold a second reference to another key's tensor to that key: they are
    consumed and not used. `optional` upstream keys are consumed where
    present and not used."""

    def __init__(self, name: str, rules: Callable[[Sequence[str]], List[Rule]],
                 kinds: Sequence[Tuple[str, object]] = (), aliases: Optional[Dict] = None,
                 optional: Sequence[str] = ()):
        self.__name__ = name
        self.rules, self.kinds = rules, list(kinds)
        self.aliases, self.optional = dict(aliases or {}), tuple(optional)

    def layout(self, keys: Sequence[str]) -> Dict[str, Tuple[str, object]]:
        """{port key: (upstream key, kind)} for a net with these keys."""
        rules = self.rules(list(keys))
        out = {}
        for key in keys:
            up = key
            for pattern, repl in rules:
                up = re.sub(pattern, repl, up)
            kind = next((k for p, k in self.kinds if re.search(p, key)), None)
            out[key] = (up, kind)
        return out

    def __call__(self, state_dict, net: nn.Module) -> Dict[str, torch.Tensor]:
        """The port's state_dict for `net` from upstream's `state_dict`
        (name -> tensor or array; a TrackingStateDict keeps its record of
        the keys read). Raises, naming the keys, where the file lacks a key
        the net needs or holds it at another shape."""
        sd = state_dict if isinstance(state_dict, TrackingStateDict) \
            else TrackingStateDict(state_dict)
        expected = net.state_dict()
        out, missing, bad = {}, [], []
        for key, (up, kind) in self.layout(list(expected)).items():
            if up not in sd:
                missing.append(f"{up} (for {key})")
                continue
            arr = from_upstream(sd[up], kind, tuple(expected[key].shape))
            if tuple(arr.shape) != tuple(expected[key].shape):
                bad.append(f"{up} {tuple(sd[up].shape)} for {key} {tuple(expected[key].shape)}")
                continue
            out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
        for key in (*self.aliases, *self.optional):
            sd.get(key)
        if missing or bad:
            raise KeyError(f"{self.__name__}: upstream keys missing: {missing[:20]}; "
                           f"at other shapes: {bad[:20]}")
        return out


def from_upstream(arr: np.ndarray, kind, shape: Tuple[int, ...]) -> np.ndarray:
    """An upstream value in the port's layout (`shape`: the port's)."""
    if kind == BINS:
        return arr.reshape(-1)
    if kind == CONV1D:
        return arr[..., 0]
    if kind in IN_PROJ:
        d = shape[0]
        i = IN_PROJ.index(kind)
        return arr[i * d:(i + 1) * d]
    return arr


def to_upstream(arr: np.ndarray, kind) -> np.ndarray:
    """The port's value in upstream's layout (IN_PROJ: this projection's
    rows, for the caller to concatenate in q, k, v order)."""
    if kind == BINS:
        return arr.reshape(1, -1, 1, 1)
    if kind == CONV1D:
        return arr[..., None]
    return arr


_DIMP_STEP = "classifier.filter_optimizer.log_step_length"

# DiMP-18/50, PrDiMP-18/50, SuperDiMP and SuperDiMP-simple (reference
# ltr/models/tracking/dimpnet.py). The simple net's generic Gauss-Newton
# optimiser has no learned step length: the JAX porter reads
# `log_step_length` for every DiMP net, so the port consumes it and drops it.
port_dimpnet = Porter(
    "port_dimpnet",
    lambda keys: [*_resnet("feature_extractor.", "feature_extractor."),
                  *_dimp_classifier("classifier.", keys), *_iou_net()],
    _DIMP_KINDS, optional=(_DIMP_STEP,))

# ATOMnet (reference ltr/models/bbreg/atom.py:7): backbone and IoU-Net.
port_atomnet = Porter(
    "port_atomnet",
    lambda keys: [*_resnet("feature_extractor.", "feature_extractor."), *_iou_net()])

# KYSnet (reference ltr/models/tracking/kysnet.py:17): upstream prefixes
# backbone_feature_extractor / dimp_classifier / bb_regressor /
# predictor.predictor.
_KYS_PREDICTOR = [
    (r"^predictor\.cvproc(\d)_(\d)\.Conv_0\.", r"predictor.predictor.cost_volume_proc\1.\2.0."),
    (r"^predictor\.cvproc(\d)_(\d)\.BatchNorm_0\.",
     r"predictor.predictor.cost_volume_proc\1.\2.1."),
    (r"^predictor\.repr(\d+)\.Conv_0\.", r"predictor.predictor.representation_predictor.\1.0."),
    (r"^predictor\.response_pred\.", "predictor.predictor.response_predictor.0.0."),
    (r"^predictor\.init_hidden\.", "predictor.predictor.init_hidden_state_predictor.0.0."),
    (r"^predictor\.is_target_(\d)\.", r"predictor.predictor.is_target_predictor.\1.0."),
    (r"^predictor\.state_predictor\.", "predictor.predictor.state_predictor.")]
port_kysnet = Porter(
    "port_kysnet",
    lambda keys: [*_resnet("feature_extractor.", "backbone_feature_extractor."),
                  *_dimp_classifier("dimp_classifier.", keys), *_iou_net(), *_KYS_PREDICTOR],
    _DIMP_KINDS)


def _lwl_rules(keys):
    return [*_resnet("feature_extractor.", "feature_extractor."), *_lwl_target_model(keys),
            *_label_encoder("label_encoder"), *_lwl_decoder()]


# LWL (reference ltr/models/lwl/lwl_net.py:18), the mrcnn ResNet-50.
port_lwlnet = Porter("port_lwlnet", _lwl_rules)

# RTS (reference ltr/models/rts/rts_net.py:417): LWL's parts, the hinge
# classifier's features and initializer (its optimiser has no parameters),
# the score encoder and the fusion.
port_rtsnet = Porter(
    "port_rtsnet",
    lambda keys: [*_lwl_rules(keys),
                  *_feature_blocks("classifier.feature_extractor.",
                                   "classifier.feature_extractor.", keys),
                  *_label_encoder("clf_encoder")])

# STA (reference ltr/models/lwl/sta_net.py:99): the two target models share
# one feature block, held under target_model; box, bbox and mask encoders.
port_stanet = Porter(
    "port_stanet",
    lambda keys: [*_lwl_rules(keys), *_label_encoder("bbox_encoder"),
                  *_label_encoder("segm_encoder")])

# ToMP-50/101 (reference ltr/models/tracking/tompnet.py:13). Upstream
# registers query_embed_fg twice (filter_predictor.py:33: the decoder's
# alias of the same tensor).
_TOMP_FP = "head.filter_predictor."
port_tompnet = Porter(
    "port_tompnet",
    lambda keys: [*_resnet("feature_extractor.", "feature_extractor."),
                  (r"^head\.feature_extractor\.final_conv\.", "head.feature_extractor.0."),
                  *_tomp_head("head.")],
    _TOMP_KINDS,
    aliases={f"{_TOMP_FP}query_embed_fg_decoder.weight": f"{_TOMP_FP}query_embed_fg.weight"})

# TaMOs (reference ltr/models/tracking/tamosnet.py:13 + FPNHead): the port
# keeps the head's parts at the top level; torchvision's FPN.
port_tamosnet = Porter(
    "port_tamosnet",
    lambda keys: [*_resnet("feature_extractor.", "feature_extractor."),
                  (r"^head_feature_extractor\.final_conv\.", "head.feature_extractor.0."),
                  (r"^(filter_predictor|classifier|bb_regressor)\.", r"head.\1."),
                  (r"^fpn\.lateral(\d)\.",
                   lambda m: f"head.fpn.fpn.inner_blocks.{int(m.group(1)) - 2}."),
                  (r"^fpn\.smooth(\d)\.",
                   lambda m: f"head.fpn.fpn.layer_blocks.{int(m.group(1)) - 2}."),
                  *_tomp_head("head.")],
    _TOMP_KINDS)

# KeepTrack's target candidate matching net (reference
# ltr/models/target_candidate_matching/target_candidate_matching.py:90).
port_tcm = Porter(
    "port_tcm",
    lambda keys: [*_resnet("feature_extractor.", "feature_extractor."), *_tcm_matcher()],
    _TCM_KINDS)

# ResNet18-VGG-m1 (reference ltr/models/backbone/resnet18_vggm.py:38), a
# state_dict of the backbone alone.
port_resnet18_vggm = Porter("port_resnet18_vggm", lambda keys: _resnet("", ""))

# MobileNetV3-Large (reference ltr/models/backbone/mobilenetv3.py:134).
port_mobilenetv3 = Porter("port_mobilenetv3", _mobilenet)
