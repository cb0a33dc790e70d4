"""Parity of the port's ToMP and TaMOs training with the JAX package, on the
CPU: the GIoU loss; each net in train mode (the backbone's BatchNorms
frozen, the box encoder's training, dropout 0) through its actor, with
the loss terms, every parameter's gradient and the box encoder's running
statistics; one AdamW step of the recipe's optimiser (only the head and
layer3 train) against the JAX train step with the JAX recipe's
adam_per_module; the recipes' parameter groups against the JAX labels;
then the port alone: `run_training` on each of the four recipes for one
step with a tiny net.

Nets: ToMP with the head of `tompnet50(feature_sz=4, out_feature_dim=64,
nhead=8, num_encoder_layers=1, num_decoder_layers=1, dim_feedforward=64)`
on the tiny ResNet of tests/test_torch_tomp.py; TaMOs the tiny TaMOs of
tests/test_torch_tamos.py (box_enc 'ltrb_token', K = 3). Both built from
the JAX package's classes with dropout 0.0 (the masks cannot match JAX's
draws; tests/test_torch_transformer_train.py holds the port's dropout),
their `net.init` with random BatchNorm statistics converted by
`tompnet_from_flax` / `tamosnet_from_flax`.

Float32. Tolerances, relative to the larger of 1 and the reference's
largest magnitude: the loss and its terms 1e-5, the running statistics
1e-4; each gradient leaf within GRAD_TOL (tests/test_torch_training.py) of
its own largest magnitude, after checking that the port's own gradient
moves by less than 1e-4 of a leaf's scale when the images change by 3e-7
relative; the AdamW step as in its test.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytracking_tpu_torch.models.backbones import resnet as t_resnet
from pytracking_tpu_torch.models.classifier.features import \
    ResidualBottleneck as TResidualBottleneck
from pytracking_tpu_torch.models.loss.bbr_loss import giou, giou_loss
from pytracking_tpu_torch.models.tracking import tamosnet as t_tamosnet
from pytracking_tpu_torch.models.tracking import tompnet as t_tompnet
from pytracking_tpu_torch.models.transformer.filter_predictor import \
    FilterPredictor as TFilterPredictor
from pytracking_tpu_torch.models.transformer.got_filter_predictor import \
    GOTFilterPredictor as TGOT
from pytracking_tpu_torch.models.transformer.heads import (
    DenseBoxRegressor as TDenseBoxRegressor, Head as THead,
    LinearFilterClassifier as TLinearFilterClassifier)
from pytracking_tpu_torch.models.transformer.transformer import \
    Transformer as TTransformer
from pytracking_tpu_torch.parallel.mesh import make_train_step as t_make_train_step
from pytracking_tpu_torch.training import optim as t_optim
from pytracking_tpu_torch.training.actors.tracking import TaMOsActor, ToMPActor
from pytracking_tpu_torch.training.processing import _encode_ltrb
from pytracking_tpu_torch.training.processing_utils import gaussian_label_function
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.utils.convert_weights import tamosnet_from_flax, tompnet_from_flax

from test_torch_dimp import _perturb_batch_stats
from test_torch_lwl_ops import one_thread  # noqa: F401 (autouse: one CPU thread)
from test_torch_training import GRAD_TOL, _close, _np, to_torch
from test_torch_training import real_tensorboardx  # noqa: F401 (autouse)

SZ = 64                    # crops: a 4x4 grid at stride 16, 8x8 at stride 8
F_LO, F_HI = SZ // 16, SZ // 8
S = 4                      # sequences per batch
K = 3                      # TaMOs object slots
D_TOMP, D_TAMOS = 64, 32
LABEL_SIGMA = 0.05         # Settings: output_sigma_factor / search_area_factor
# The batches, one whose gradients are continuous at rounding scale (the
# gradient tests check that first). GIoU's min / max / clips and LBHinge's
# threshold give the tiny nets' gradients kinks that float32 rounding can
# put on either side, on both sides (tests/test_torch_training.py).
TOMP_SEED = 0
TAMOS_SEED = 0


def _boxes_and_frames(rng, n):
    """n * S textured 64x64 frames (NHWC, 0-255), a bright square of 18-28
    px in each; boxes (n, S, 4)."""
    ims, boxes = [], []
    for _ in range(n * S):
        im = rng.rand(SZ, SZ, 3).astype(np.float32) * 60
        w, h = rng.randint(18, 29, 2)
        x, y = rng.randint(4, SZ - 4 - w), rng.randint(4, SZ - 4 - h)
        im[y:y + h, x:x + w] = 190.0 + rng.rand(h, w, 3) * 60
        ims.append(im)
        boxes.append([float(x), float(y), float(w), float(h)])
    return (np.stack(ims).reshape(n, S, SZ, SZ, 3),
            np.asarray(boxes, np.float32).reshape(n, S, 4))


def _label(box, f):
    return gaussian_label_function(np.asarray(box)[None], LABEL_SIGMA, 1, f, SZ)[0]


def make_tomp_batch(seed):
    """ToMPProcessing's layout for 2 train and 1 test frame of S sequences:
    Gaussian labels (h, w) and dense LTRB maps (h, w, 4) at stride 16."""
    rng = np.random.RandomState(seed)
    train_images, train_anno = _boxes_and_frames(rng, 2)
    test_images, test_anno = _boxes_and_frames(rng, 1)
    out = {"train_images": train_images, "test_images": test_images}
    for s, anno in (("train", train_anno), ("test", test_anno)):
        flat = anno.reshape(-1, 4)
        out[s + "_label"] = np.stack([_label(b, F_LO) for b in flat]).reshape(
            anno.shape[:2] + (F_LO, F_LO)).astype(np.float32)
        out[s + "_ltrb_target"] = np.stack([_encode_ltrb(b, SZ, 16) for b in flat]).reshape(
            anno.shape[:2] + (F_LO, F_LO, 4)).astype(np.float32)
    return out


def make_tamos_batch(seed):
    """TaMOsProcessing's layout for 1 train and 1 test frame of S sequences,
    K slots: sequence s has objects in slots 0..min(s, K - 1) (the later
    sequences all three, the first one slot 0 alone), each a square of
    its own; train side slot-first at stride 16, test side slot-last at
    stride 8 with the sample regions."""
    rng = np.random.RandomState(seed)
    out = {}
    for s, n_frames in (("train", 1), ("test", 1)):
        images, anno = _boxes_and_frames(rng, n_frames)
        others = [_boxes_and_frames(rng, n_frames)[1] for _ in range(K - 1)]
        f, stride = (F_LO, 16) if s == "train" else (F_HI, 8)
        lbl = np.zeros((n_frames, S, K, f, f), np.float32)
        ltrb = np.zeros((n_frames, S, K, f, f, 4), np.float32)
        region = np.zeros((n_frames, S, K, f, f), np.float32)
        for i in range(n_frames):
            for j in range(S):
                for k in range(min(j, K - 1) + 1):
                    box = (anno if k == 0 else others[k - 1])[i, j]
                    x, y, w, h = box
                    if k > 0:                         # paint the other objects too
                        images[i, j, int(y):int(y + h), int(x):int(x + w)] = 120.0 + 40 * k
                    lbl[i, j, k] = _label(box, f)
                    ltrb[i, j, k] = _encode_ltrb(box, SZ, stride)
                    cs = (np.arange(f) + 0.5) * stride
                    region[i, j, k] = ((cs[:, None] >= y) & (cs[:, None] <= y + h)
                                       & (cs[None, :] >= x) & (cs[None, :] <= x + w))
        out[s + "_images"] = images
        if s == "train":
            out["train_label"], out["train_ltrb_target"] = lbl, ltrb
        else:
            out["test_label"] = np.moveaxis(lbl, 2, -1).copy()
            out["test_ltrb_target"] = np.moveaxis(ltrb, 2, -2).copy()
            out["test_sample_region"] = np.moveaxis(region, 2, -1).copy()
    return out


# ---------------------------------------------------------------- nets

def jax_tomp():
    from pytracking_tpu.models.backbones.resnet import ResNet
    from pytracking_tpu.models.classifier.features import ResidualBottleneck
    from pytracking_tpu.models.tracking.tompnet import ToMPnet
    from pytracking_tpu.models.transformer.filter_predictor import FilterPredictor
    from pytracking_tpu.models.transformer.heads import (DenseBoxRegressor, Head,
                                                         LinearFilterClassifier)
    from pytracking_tpu.models.transformer.transformer import Transformer

    d = D_TOMP
    backbone = ResNet(block="bottleneck", layers=(1, 1, 1, 1), output_layers=("layer3",),
                      base_width=16)
    head_fe = ResidualBottleneck(feature_dim=32, num_blocks=0, l2norm=True, final_conv=True,
                                 norm_scale=math.sqrt(1.0 / (d * 16)), out_dim=d)
    transformer = Transformer(d_model=d, nhead=8, num_encoder_layers=1, num_decoder_layers=1,
                              dim_feedforward=64, dropout=0.0)
    head = Head(filter_predictor=FilterPredictor(transformer, feature_sz=F_LO),
                feature_extractor=head_fe, classifier=LinearFilterClassifier(num_channels=d),
                bb_regressor=DenseBoxRegressor(num_channels=d))
    return ToMPnet(feature_extractor=backbone, head=head, head_layer="layer3",
                   freeze_backbone_bn=True)


def torch_tomp():
    d = D_TOMP
    backbone = t_resnet.ResNet(layers=(1, 1, 1, 1), output_layers=("layer3",), base_width=16)
    head_fe = TResidualBottleneck(in_dim=256, out_dim=d, norm_scale=math.sqrt(1.0 / (d * 16)))
    transformer = TTransformer(d_model=d, nhead=8, num_encoder_layers=1, num_decoder_layers=1,
                               dim_feedforward=64, dropout=0.0)
    head = THead(filter_predictor=TFilterPredictor(transformer, feature_sz=F_LO),
                 feature_extractor=head_fe, classifier=TLinearFilterClassifier(d),
                 bb_regressor=TDenseBoxRegressor(d))
    return t_tompnet.ToMPnet(feature_extractor=backbone, head=head, freeze_backbone_bn=True)


def jax_tamos():
    from pytracking_tpu.models.backbones.resnet import ResNet
    from pytracking_tpu.models.classifier.features import ResidualBottleneck
    from pytracking_tpu.models.tracking.tamosnet import FPN, TaMOsNet
    from pytracking_tpu.models.transformer.got_filter_predictor import GOTFilterPredictor
    from pytracking_tpu.models.transformer.heads import (DenseBoxRegressor,
                                                         LinearFilterClassifier)
    from pytracking_tpu.models.transformer.transformer import Transformer

    d = D_TAMOS
    backbone = ResNet(block="bottleneck", layers=(1, 1, 1, 1),
                      output_layers=("layer2", "layer3"), base_width=8)
    head_fe = ResidualBottleneck(feature_dim=16, num_blocks=0, l2norm=True, final_conv=True,
                                 norm_scale=math.sqrt(1 / d), out_dim=d)
    transformer = Transformer(d_model=d, nhead=4, num_encoder_layers=2, num_decoder_layers=2,
                              dim_feedforward=64, dropout=0.0)
    fp = GOTFilterPredictor(transformer, feature_sz=F_LO, num_tokens=K, box_enc="ltrb_token")
    return TaMOsNet(feature_extractor=backbone, head_feature_extractor=head_fe,
                    filter_predictor=fp, classifier=LinearFilterClassifier(num_channels=d),
                    bb_regressor=DenseBoxRegressor(num_channels=d), fpn=FPN(output_dim=d),
                    freeze_backbone_bn=True)


def torch_tamos():
    d = D_TAMOS
    backbone = t_resnet.ResNet(layers=(1, 1, 1, 1), output_layers=("layer2", "layer3"),
                               base_width=8)
    head_fe = TResidualBottleneck(in_dim=128, out_dim=d, norm_scale=math.sqrt(1 / d))
    transformer = TTransformer(d_model=d, nhead=4, num_encoder_layers=2, num_decoder_layers=2,
                               dim_feedforward=64, dropout=0.0)
    fp = TGOT(transformer, feature_sz=F_LO, num_tokens=K, box_enc="ltrb_token")
    return t_tamosnet.TaMOsNet(
        feature_extractor=backbone, head_feature_extractor=head_fe, filter_predictor=fp,
        classifier=TLinearFilterClassifier(d), bb_regressor=TDenseBoxRegressor(d),
        fpn=t_tamosnet.FPN(d, 64, d), freeze_backbone_bn=True)


KINDS = {
    # jax net, torch net, converter, batch, seed, init inputs, JAX actor, port actor,
    # JAX recipe's learning rates, the port recipe's module
    "tomp": dict(jax=jax_tomp, torch=torch_tomp, convert=tompnet_from_flax,
                 batch=make_tomp_batch, seed=TOMP_SEED, actor="make_tomp_actor",
                 port_actor=ToMPActor, recipe=("tomp", "tomp50"),
                 jax_lrs={"head": 1e-4, "feature_extractor/layer3_": 2e-5}),
    "tamos": dict(jax=jax_tamos, torch=torch_tamos, convert=tamosnet_from_flax,
                  batch=make_tamos_batch, seed=TAMOS_SEED, actor="make_tamos_actor",
                  port_actor=TaMOsActor, recipe=("tamos", "tamos_resnet50"),
                  jax_lrs={"head_feature_extractor": 1e-4, "filter_predictor": 1e-4,
                           "classifier": 1e-4, "bb_regressor": 1e-4, "fpn": 1e-4,
                           "feature_extractor/layer3_": 2e-5}),
}


def _init_args(kind):
    z = jnp.zeros((1, 1, SZ, SZ, 3))
    if kind == "tomp":
        return z, z, jnp.zeros((1, 1, F_LO, F_LO)), jnp.zeros((1, 1, F_LO, F_LO, 4))
    return z, z, jnp.zeros((1, 1, K, F_LO, F_LO)), jnp.zeros((1, 1, K, F_LO, F_LO, 4))


def _pair(kind):
    """(jax net, flax variables as numpy, a function making the torch net
    with the same weights, in train mode). ToMP's box regressor's last layer
    is damped so that the random net's boxes stay near the targets' size."""
    spec = KINDS[kind]
    jnet = spec["jax"]()
    variables = jax.jit(lambda k: jnet.init(k, *_init_args(kind), train=False))(
        jax.random.PRNGKey(1))
    variables = _perturb_batch_stats(jax.tree_util.tree_map(np.array, dict(variables)), 5)
    variables["params"] = jax.tree_util.tree_map(np.array, variables["params"])
    bbreg = (variables["params"]["head"] if kind == "tomp" else
             variables["params"])["bb_regressor"]["bbreg_layer"]
    bbreg["kernel"] = bbreg["kernel"] * 0.05
    bbreg["bias"] = (bbreg["bias"] + np.log(0.3)).astype(np.float32)

    def make_tnet():
        tnet = spec["torch"]()
        tnet.load_state_dict(spec["convert"](variables, tnet))
        return tnet.train()

    return jnet, variables, make_tnet


@pytest.fixture(scope="module", params=sorted(KINDS))
def run(request):
    """For one kind: the pair, and the JAX side on its batch: the actor's
    loss, stats, new batch stats and gradients (one jit of value_and_grad)."""
    kind = request.param
    jnet, variables, make_tnet = _pair(kind)
    from pytracking_tpu.training.actors import tracking as j_actors

    actor = getattr(j_actors, KINDS[kind]["actor"])(jnet)
    batch = {k: jnp.asarray(v) for k, v in KINDS[kind]["batch"](KINDS[kind]["seed"]).items()}
    (loss, (stats, new_bs)), grads = jax.jit(jax.value_and_grad(actor, has_aux=True))(
        variables["params"], variables["batch_stats"], batch)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"kind": kind, "jnet": jnet, "variables": variables, "make_tnet": make_tnet,
            "actor": actor, "loss": float(loss), "stats": {k: float(v) for k, v in stats.items()},
            "batch_stats": as_np(new_bs), "grads": as_np(grads)}


# ---------------------------------------------------------------- GIoU

@pytest.mark.parametrize("masked", [False, True])
def test_giou_and_loss_match_jax(masked):
    """Values and gradients of giou / giou_loss on random LTRB boxes, some
    overlapping, some disjoint (a negative intersection width clipped at
    0), some degenerate (zero area: the 1e-7 floors); the masked mean with
    an empty mask too (denominator 1)."""
    from pytracking_tpu.models.loss import bbr_loss as j_bbr

    rng = np.random.RandomState(3)
    pred = (rng.rand(6, 5, 4) * 2).astype(np.float32)
    target = (rng.rand(6, 5, 4) * 2 - 0.5).astype(np.float32)
    pred[0, 0] = target[0, 0] = 0.0
    target[1] = -pred[1][..., [2, 3, 0, 1]] - 0.1          # disjoint: no intersection
    mask = (rng.rand(6, 5) > 0.4) if masked else None
    g_ref, iou_ref = j_bbr.giou(jnp.asarray(pred), jnp.asarray(target))
    g, iou = giou(torch.from_numpy(pred), torch.from_numpy(target))
    _close(_np(g), g_ref, 1e-6)
    _close(_np(iou), iou_ref, 1e-6)
    jm = None if mask is None else jnp.asarray(mask)
    ref, ref_grad = jax.value_and_grad(lambda p: j_bbr.giou_loss(p, jnp.asarray(target), jm))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    loss = giou_loss(p, torch.from_numpy(target), None if mask is None else torch.from_numpy(mask))
    loss.backward()
    _close(loss.item(), float(ref), 1e-6)
    _close(_np(p.grad), np.asarray(ref_grad), 1e-6)
    if masked:
        empty = np.zeros((6, 5), bool)
        _close(giou_loss(torch.from_numpy(pred), torch.from_numpy(target),
                         torch.from_numpy(empty)).item(),
               float(j_bbr.giou_loss(jnp.asarray(pred), jnp.asarray(target),
                                     jnp.asarray(empty))), 1e-6)


# ---------------------------------------------------------------- actors

def _running_stats(state):
    return {k: v for k, v in state.items() if k.endswith(("running_mean", "running_var"))}


def test_actor_loss_terms_and_running_statistics_match_jax(run):
    """The port's actor in train mode against the JAX actor (train=True,
    mutable batch_stats): the loss, each stat under the JAX names, the box
    encoder's running statistics moved as flax moves them, and the
    backbone's BatchNorm statistics (frozen) bit for bit unchanged on both
    sides."""
    kind = run["kind"]
    tnet = run["make_tnet"]()
    start = {k: v.clone() for k, v in _running_stats(tnet.state_dict()).items()}
    loss, stats = KINDS[kind]["port_actor"](tnet)(to_torch(KINDS[kind]["batch"](
        KINDS[kind]["seed"])))
    assert sorted(stats) == sorted(run["stats"])
    assert np.isfinite(loss.item())
    _close(loss.item(), run["loss"], 1e-5)
    for k, v in stats.items():
        _close(v.item(), run["stats"][k], 1e-5)
    moved = KINDS[kind]["convert"]({"params": run["variables"]["params"],
                                    "batch_stats": run["batch_stats"]}, tnet)
    box_enc = 0
    for k, v in _running_stats(tnet.state_dict()).items():
        _close(_np(v), moved[k].numpy(), 1e-4)
        if k.startswith("feature_extractor."):
            assert torch.equal(v, start[k]) and torch.equal(moved[k], start[k]), k
        else:
            assert "box_encoding" in k and not torch.equal(v, start[k]), k
            box_enc += 1
    assert box_enc == 4


def exact_zero(name, kind):
    """Whether a leaf's gradient is exactly 0 by construction, rounding
    alone making it otherwise (on both sides, with either sign): an
    attention key's bias (it shifts all of a query's logits alike, which
    the softmax cancels), a bias before a train-mode BatchNorm (the box
    encoder's lin0 / lin1), the first decoder layer's self-attention value
    weight (its input, the targets, starts at 0), and the decoder
    self-attention's query and key projections where the softmax's weights
    cannot matter: in layer 0, whose values are all alike, and with ToMP's
    single query in every layer (a softmax over one key)."""
    if name.endswith(("key.bias", "lin0.bias", "lin1.bias",
                      "decoder.0.self_attn.value.weight")):
        return True
    m = re.search(r"decoder\.(\d+)\.self_attn\.(query|key)\.", name)
    return m is not None and (kind == "tomp" or m.group(1) == "0")


def _zero_scale(name, ref):
    """The gradient scale an exact_zero leaf is held to: the largest of its
    attention block's leaves for an attention projection's, its layer's
    weight's for another bias."""
    m = re.search(r"^(.*self_attn)\.(query|key|value)\.", name)
    if m:
        scale = max(np.abs(v.numpy()).max() for k, v in ref.items()
                    if k.startswith(m.group(1) + "."))
    else:
        scale = np.abs(ref[name.rsplit(".", 1)[0] + ".weight"].numpy()).max()
    assert scale > 0, name
    return scale


def _grads(make_tnet, batch, kind):
    tnet = make_tnet()
    KINDS[kind]["port_actor"](tnet)(batch)[0].backward()
    return {n: p.grad for n, p in tnet.named_parameters() if p.grad is not None}


def test_gradients_match_jax(run):
    """Every parameter's .grad (all train here; the recipe's freezing is the
    optimiser's) against jax.value_and_grad of the JAX actor, through the
    converter, within GRAD_TOL of the leaf's scale, after checking that
    the port's own gradient is steady under a 3e-7 relative change of the
    images. A leaf the loss does not reach (TaMOs's FPN smooth3, ResNet's
    layer4) has no .grad and a zero JAX gradient; a leaf whose gradient is
    exactly 0 (exact_zero) is held, on both sides, to GRAD_TOL of its
    layer's weight gradient."""
    kind, make_tnet = run["kind"], run["make_tnet"]
    batch = to_torch(KINDS[kind]["batch"](KINDS[kind]["seed"]))
    g0 = _grads(make_tnet, batch, kind)
    gen = torch.Generator().manual_seed(0)
    moved = dict(batch)
    for k in ("train_images", "test_images"):
        moved[k] = batch[k] * (1 + 3e-7 * torch.randn(batch[k].shape, generator=gen))
    g1 = _grads(make_tnet, moved, kind)
    steady = {n: float((g1[n] - g0[n]).abs().max() / g0[n].abs().max()) for n in g0
              if not exact_zero(n, kind)}
    assert max(steady.values()) < 1e-4, max(steady.items(), key=lambda kv: kv[1])

    ref = KINDS[kind]["convert"]({"params": run["grads"],
                                  "batch_stats": run["variables"]["batch_stats"]})
    worst, unreached = {}, []
    for name, g in g0.items():
        r = ref[name].numpy()
        if exact_zero(name, kind):
            worst[name] = max(np.abs(_np(g)).max(), np.abs(r).max()) / _zero_scale(name, ref)
            continue
        if not r.any():                        # a zero input (the first decoder layer's)
            assert not _np(g).any(), name
            continue
        worst[name] = np.abs(_np(g) - r).max() / np.abs(r).max()
    for name, _ in make_tnet().named_parameters():
        if name not in g0:
            assert not ref[name].numpy().any(), name
            unreached.append(name)
    bad = {k: v for k, v in worst.items() if v > GRAD_TOL}
    assert not bad, bad
    assert all(n.startswith(("feature_extractor.layer4", "fpn.smooth3")) for n in unreached), \
        unreached
    assert len([n for n in worst if "transformer" in n]) > 20
    assert len([n for n in worst if n.startswith("feature_extractor.layer3")]) > 5


def test_adamw_step_matches_jax_train_step(run):
    """One step of the port's make_train_step with the recipe's optimiser
    (AdamW, weight decay 1e-4; the head at 1e-4, the backbone's layer3 at
    2e-5, every other parameter frozen) against the JAX make_train_step
    with the JAX recipe's adam_per_module: the loss (1e-5 relative), the
    running statistics after it (1e-4), the frozen leaves bit for bit
    unchanged on both sides (weight decay included; out of autograd on the
    port's), every trained leaf moved, and each trained element's movement
    within 1% of its group's lr of the JAX one where the gradient is at
    least 1% of its leaf's scale; the zero-gradient biases and the leaves
    the loss does not reach (which weight decay alone moves, on both
    sides) within 1% of lr everywhere."""
    from pytracking_tpu.parallel.mesh import make_train_step
    from pytracking_tpu.training.optim import adam_per_module

    kind, jnet, variables = run["kind"], run["jnet"], run["variables"]
    spec = KINDS[kind]
    recipe = __import__(f"pytracking_tpu_torch.training.train_settings.{spec['recipe'][0]}."
                        f"{spec['recipe'][1]}", fromlist=["x"])
    batch = spec["batch"](spec["seed"])
    jopt = adam_per_module(2e-4, spec["jax_lrs"], steps_per_epoch=1, milestones=(150, 250),
                           gamma=0.2, weight_decay=1e-4, freeze_unlisted=True)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    bs = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    params, bs, _, jloss, _ = make_train_step(run["actor"], jopt)(
        params, bs, jopt.init(params), {k: jnp.asarray(v) for k, v in batch.items()})

    tnet = run["make_tnet"]()
    optimizer, scheduler = t_optim.adam_per_module(
        tnet, recipe.BASE_LR, recipe.MODULE_LRS, steps_per_epoch=1,
        milestones=recipe.MILESTONES, weight_decay=recipe.WEIGHT_DECAY,
        freeze_unlisted=recipe.FREEZE_UNLISTED)
    lrs = {id(p): g["lr"] for g in optimizer.param_groups for p in g["params"]}
    tloss, _ = t_make_train_step(spec["port_actor"](tnet), optimizer, scheduler)(
        to_torch(batch))
    _close(tloss, float(jloss), 1e-5)

    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    start = spec["convert"](variables, tnet)
    ref = spec["convert"]({"params": as_np(params), "batch_stats": as_np(bs)}, tnet)
    grads = spec["convert"]({"params": run["grads"], "batch_stats": variables["batch_stats"]})
    params_t = dict(tnet.named_parameters())
    n_trained = 0
    for k, v in tnet.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _close(_np(v), ref[k].numpy(), 1e-4)
            continue
        moved, ref_moved = _np(v) - start[k].numpy(), ref[k].numpy() - start[k].numpy()
        lr = lrs.get(id(params_t[k]))
        if lr is None:
            assert not params_t[k].requires_grad, k
            assert not moved.any() and not ref_moved.any(), k
            continue
        n_trained += 1
        g = np.abs(grads[k].numpy())
        if exact_zero(k, kind):
            # rounding's sign: Adam moves it by up to lr either way
            assert max(np.abs(moved).max(), np.abs(ref_moved).max()) <= 1.01 * lr, k
            continue
        if not g.any():
            # not reached: weight decay alone, lr * 1e-4 of the value, rounds away
            assert not moved.any() and not ref_moved.any(), k
            continue
        assert moved.any() and ref_moved.any(), k
        err = np.abs(moved - ref_moved) / lr
        assert err[g >= 0.01 * g.max()].max() <= 1e-2, (k, err.max())
    assert n_trained > 20


# ---------------------------------------------------------------- parameter groups

def _label_codes(params, prefixes):
    """The JAX recipe's label of every leaf (pytracking_tpu.training.optim
    ._label_tree) as a constant array of the leaf's shape: the label's
    index in `prefixes` + 1, 0 for '__base__'."""
    from pytracking_tpu.training.optim import _label_tree

    labels = _label_tree(params, sorted(prefixes, key=len, reverse=True))
    codes = {"__base__": 0.0, **{p: float(i + 1) for i, p in enumerate(prefixes)}}
    return jax.tree_util.tree_map(lambda leaf, lab: np.full(np.shape(leaf), codes[lab],
                                                            np.float32), params, labels)




@pytest.mark.parametrize("kind", ["tomp", "tamos", "tamos_swin"])
def test_parameter_groups_match_jax_labels(kind):
    """Which parameters each port recipe trains, and at which rate, against
    the JAX recipe's optax labels, leaf by leaf through the converter:
    ToMP's 'head' takes the head and nothing else (no module whose name
    only begins with 'head'); TaMOs-SwinBase's prefixes name no Swin
    parameter, so its whole backbone is frozen."""
    recipe_of = {"tomp": ("tomp", "tomp50"), "tamos": ("tamos", "tamos_resnet50"),
                 "tamos_swin": ("tamos", "tamos_swin_base")}
    module, name = recipe_of[kind]
    recipe = __import__(f"pytracking_tpu_torch.training.train_settings.{module}.{name}",
                        fromlist=["x"])
    jax_lrs = KINDS["tomp" if kind == "tomp" else "tamos"]["jax_lrs"]
    if kind == "tamos_swin":
        from tests.test_torch_swin import jax_tiny_tamos_swin, torch_tiny_tamos_swin

        jnet, tnet = jax_tiny_tamos_swin(), torch_tiny_tamos_swin()
        args = _init_args("tamos")
    else:
        jnet, tnet = KINDS[kind]["jax"](), KINDS[kind]["torch"]()
        args = _init_args(kind)
    shapes = jax.eval_shape(lambda k: jnet.init(k, *args, train=False), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    prefixes = list(jax_lrs)
    codes = tamosnet_from_flax({"params": _label_codes(params, prefixes)}) \
        if kind != "tomp" else tompnet_from_flax({"params": _label_codes(params, prefixes)})
    optimizer, _ = t_optim.adam_per_module(tnet, recipe.BASE_LR, recipe.MODULE_LRS,
                                           steps_per_epoch=1, milestones=recipe.MILESTONES,
                                           weight_decay=recipe.WEIGHT_DECAY,
                                           freeze_unlisted=recipe.FREEZE_UNLISTED)
    lrs = {id(p): g["lr"] for g in optimizer.param_groups for p in g["params"]}
    seen = set()
    for n, p in tnet.named_parameters():
        code = codes[n].unique()
        assert code.numel() == 1, n
        label = "__base__" if code.item() == 0 else prefixes[int(code.item()) - 1]
        want = None if label == "__base__" else jax_lrs[label]
        assert lrs.get(id(p)) == want, (n, label, lrs.get(id(p)))
        assert p.requires_grad == (want is not None), n
        seen.add(label)
    assert all(g["weight_decay"] == 1e-4 for g in optimizer.param_groups)
    if kind == "tamos_swin":
        assert not any(lrs.get(id(p)) for n, p in tnet.named_parameters()
                       if n.startswith("feature_extractor."))
        assert "feature_extractor/layer3_" not in seen
    else:
        assert seen == set(prefixes) | {"__base__"}
    assert t_optim.module_label("head_feature_extractor.conv.weight", ["head"]) is None


# ---------------------------------------------------------------- the recipes

def _tiny_recipe_net(kind):
    if kind == "tomp":
        net = torch_tomp()
    elif kind == "tamos":
        net = torch_tamos()
    else:
        from tests.test_torch_swin import torch_tiny_tamos_swin
        net = torch_tiny_tamos_swin()
    t_tamosnet.init_weights(net, torch.Generator().manual_seed(0))
    return net.eval()


@pytest.mark.parametrize("module,name", [("tomp", "tomp50"), ("tomp", "tomp101"),
                                         ("tamos", "tamos_resnet50"),
                                         ("tamos", "tamos_swin_base")])
def test_run_training_recipes(module, name, tmp_path, monkeypatch):
    """run_training(module, name) on a tiny net and the CPU, 64x64 crops, one
    step of 2 sequences from the recipe's own pipeline, dropout on (the
    transformer's 0.1 default): a checkpoint, a finite loss, every
    parameter in the recipe's groups with a nonzero gradient moved (the
    encoder's attention projections among them) and the others not (the
    first decoder layer's self-attention sees zero targets; weight decay
    alone rounds away), every other parameter and every backbone running
    statistic bit for bit unchanged, the box encoder's running statistics
    moved."""
    from pytracking_tpu_torch.run_training import run_training

    monkeypatch.setenv("PYTRACKING_TPU_TORCH_WORKSPACE", str(tmp_path))
    kind = "tomp" if module == "tomp" else ("tamos_swin" if "swin" in name else "tamos")
    net = _tiny_recipe_net(kind)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    kwargs = {} if module == "tomp" else {"output_sz": SZ}
    trainer = run_training(module, name, settings=Settings(output_sz=SZ, feature_sz=F_LO,
                                                           batch_size=2, num_workers=1,
                                                           print_interval=1000),
                           max_epochs=1, samples_per_epoch=2, net=net, device="cpu", **kwargs)
    assert (tmp_path / "checkpoints" / module / name / "ep0001.ckpt").exists()
    assert len(trainer.step_log) == 1 and trainer.restarts == 0
    assert np.isfinite(trainer.step_log[0]["loss"])
    assert "Loss/giou" in trainer.stats["train"]
    params = dict(trainer.net.named_parameters())
    trained = {n for n, p in params.items() if p.requires_grad}
    assert trained and all(g["weight_decay"] == 1e-4 for g in trainer.optimizer.param_groups)
    for k, v in trainer.net.state_dict().items():
        if k in trained:
            reached = params[k].grad is not None and bool(params[k].grad.any())
            assert torch.equal(v, start[k]) != reached, k
            if re.search(r"encoder\.\d+\.self_attn\.(query|key|value)\.weight$", k):
                assert reached, k
        elif "box_encoding.bn" in k and k.endswith(("running_mean", "running_var")):
            assert not torch.equal(v, start[k]), k
        else:
            assert torch.equal(v, start[k]), k
    if kind == "tamos_swin":
        assert not any(n.startswith("feature_extractor.") for n in trained)
    else:
        assert any(n.startswith("feature_extractor.layer3_") for n in trained)
        assert not any(n.startswith("feature_extractor.layer2_") for n in trained)
