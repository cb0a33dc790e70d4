"""Parity of the port's LWL and RTS training with the JAX package, on the
CPU: the Lovász hinge and the balanced BCE; the LWL net in train mode
through its actor at refinement 0 and 2, the box-init net through its
actor, and RTS through its actor, each with the loss terms, the running
statistics and every parameter's gradient; RTS on two sequences in eval
mode against one JAX run per sequence (the JAX training forward decodes
sequence 0 only); one Adam step of each recipe's optimiser against the
JAX train step with the JAX recipe's adam_per_module, and the recipes'
parameter groups against the JAX labels; then the port alone:
`run_training` on each of the four recipes for one step with a tiny net.

Nets: the tiny LWL and box-init LWL of tests/test_torch_lwl_ops.py, and a
tiny RTS whose classifier runs on the stride-16 grid (the JAX training
forward places its fallback labels on that grid); weights from the JAX
`init` with random BatchNorm statistics, converted with
`utils/convert_weights`. Batches: two sequences of textured 64x64 frames,
a bright square in each with its mask.

Float32. Tolerances, relative to the larger of 1 and the reference's
largest magnitude: the loss and its terms 1e-5, the running statistics
1e-4; each gradient leaf within GRAD_TOL (tests/test_torch_training.py) of
its own largest magnitude, after checking that the port's own gradient
moves by less than 1e-4 of a leaf's scale when the images change by 3e-7
relative (STEADY_EPS, STEADY_TOL). The Lovász hinge's gradient depends on
how tied errors are ordered: both packages keep exactly tied errors in
pixel order, but errors within rounding of each other may sort either way
on either side, so the loss's own gradient is held on logits without ties
(continuous random values), and the nets' on batches where the port's
gradient is steady (BATCH_SEEDS): the tiny nets' ReLUs put most batches'
gradients on a kink at the packages' forward difference (3e-6 relative).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytracking_tpu_torch.models.classifier import features as t_features
from pytracking_tpu_torch.models.classifier.initializer import \
    FilterInitializerLinear as TFilterInitializerLinear
from pytracking_tpu_torch.models.classifier.linear_filter import LinearFilter as TLinearFilter
from pytracking_tpu_torch.models.classifier.residual_modules import \
    GNSteepestDescentHinge as TGNSteepestDescentHinge
from pytracking_tpu_torch.models.loss.segmentation import (balanced_bce, lovasz_hinge,
                                                           lovasz_seg_loss)
from pytracking_tpu_torch.models.lwl import decoder as t_decoder
from pytracking_tpu_torch.models.lwl import label_encoder as t_label_encoder
from pytracking_tpu_torch.models.lwl import linear_filter as t_linear_filter
from pytracking_tpu_torch.models.lwl import lwl_net as t_lwl_net
from pytracking_tpu_torch.models.rts import rts_net as t_rts_net
from pytracking_tpu_torch.parallel.mesh import make_train_step as t_make_train_step
from pytracking_tpu_torch.training import optim as t_optim
from pytracking_tpu_torch.training.actors.tracking import LWLActor, LWLBoxActor, RTSActor
from pytracking_tpu_torch.training.processing_utils import gaussian_label_function
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.utils import convert_weights as cw

from test_torch_lwl_ops import (D, HINGE_KW, K, LAYERS, TINY_FT, _finish, _jax_backbone,
                                _torch_backbone, _torch_lwl_parts, one_thread,  # noqa: F401
                                tiny_boxnet_pair, tiny_lwl_pair)
from test_torch_training import GRAD_TOL, _close, _np, to_torch

SZ = 64                    # crops: a 4x4 grid at stride 16
LABEL_SIGMA = 0.05         # Settings: output_sigma_factor / search_area_factor
BATCH_SEEDS = {"lwl0": 0, "lwl2": 16, "box": 4, "rts": 8}
# The gradient tests first check that the port's own gradient is steady
# under a relative change of the images this large: about the two
# packages' forward difference in train mode (3e-6 of the backbone
# features' scale), ten times the 3e-7 of tests/test_torch_training.py.
STEADY_EPS = 3e-6
STEADY_TOL = 2e-4


def _frames(rng, n, S):
    """n * S textured SZxSZ frames (NHWC, 0-255), a bright square of 18-28
    px in each: (frames, masks (n, S, SZ, SZ), boxes (n, S, 4))."""
    ims, masks, boxes = [], [], []
    for _ in range(n * S):
        im = rng.rand(SZ, SZ, 3).astype(np.float32) * 60
        m = np.zeros((SZ, SZ), np.float32)
        w, h = rng.randint(18, 29, 2)
        x, y = rng.randint(4, SZ - 4 - w), rng.randint(4, SZ - 4 - h)
        im[y:y + h, x:x + w] = 190.0 + rng.rand(h, w, 3) * 60
        m[y:y + h, x:x + w] = 1.0
        ims.append(im)
        masks.append(m)
        boxes.append([float(x), float(y), float(w), float(h)])
    return (np.stack(ims).reshape(n, S, SZ, SZ, 3), np.stack(masks).reshape(n, S, SZ, SZ),
            np.asarray(boxes, np.float32).reshape(n, S, 4))


def make_batch(seed, n_train=1, n_test=3, S=2):
    """LWLProcessing's layout for n_train train and n_test test frames of S
    sequences, with RTSProcessing's Gaussian test labels on the stride-16
    grid (kernel 4: 5x5)."""
    rng = np.random.RandomState(seed)
    tr_im, tr_m, tr_b = _frames(rng, n_train, S)
    te_im, te_m, te_b = _frames(rng, n_test, S)
    label = np.stack([gaussian_label_function(b[None], LABEL_SIGMA, 4, SZ // 16, SZ)[0]
                      for b in te_b.reshape(-1, 4)]).reshape(n_test, S, SZ // 16 + 1, -1)
    return {"train_images": tr_im, "test_images": te_im, "train_masks": tr_m,
            "test_masks": te_m, "train_anno": tr_b, "test_label": label.astype(np.float32)}


# ---------------------------------------------------------------- nets

@functools.lru_cache(maxsize=None)
def tiny_rts16_pair(seed=0):
    """The tiny RTS of tests/test_torch_lwl_ops.py with its classification
    feature at stride 16 (a 4x4 grid on a 64x64 crop, 5x5 scores)."""
    from pytracking_tpu.models.classifier.features import ResidualBottleneck
    from pytracking_tpu.models.classifier.initializer import FilterInitializerLinear
    from pytracking_tpu.models.classifier.linear_filter import LinearFilter
    from pytracking_tpu.models.classifier.residual_modules import GNSteepestDescentHinge
    from pytracking_tpu.models.lwl.decoder import LWTLDecoder
    from pytracking_tpu.models.lwl.label_encoder import ResidualDS16SW
    from pytracking_tpu.models.lwl.linear_filter import LWLLinearFilter
    from pytracking_tpu.models.rts.rts_net import LearnersFusion, ResidualDS16SWClf, RTSNet

    backbone, tm_feat = _jax_backbone()
    norm_scale = math.sqrt(1 / (D * 16))
    classifier = LinearFilter(
        filter_size=4,
        filter_initializer=FilterInitializerLinear(filter_size=4, filter_norm=False,
                                                   feature_dim=D),
        filter_optimizer=GNSteepestDescentHinge(**HINGE_KW),
        feature_extractor=ResidualBottleneck(feature_dim=8, num_blocks=0, l2norm=True,
                                             final_conv=True, norm_scale=norm_scale,
                                             out_dim=D, final_stride=1))
    jnet = RTSNet(feature_extractor=backbone,
                  target_model=LWLLinearFilter(filter_size=3, num_filters=K, feature_dim=D,
                                               num_iter=2, feature_extractor=tm_feat),
                  decoder=LWTLDecoder(in_channels=K, out_channels=8, ft_layers=LAYERS),
                  label_encoder=ResidualDS16SW(layer_dims=(4, 8, 16, K)), classifier=classifier,
                  clf_encoder=ResidualDS16SWClf(layer_dims=(4, 8, 16, K)),
                  fusion_module=LearnersFusion(fusion_type="concat", out_channels=K))
    im, m = jnp.zeros((1, 1, SZ, SZ, 3)), jnp.zeros((1, 1, SZ, SZ))
    tb = jnp.array([[[20.0, 20.0, 24.0, 24.0]]])
    v = jax.jit(lambda k: jnet.init(k, im, im, m, tb, num_refinement_iter=0, train=False))(
        jax.random.PRNGKey(seed))
    return (jnet,) + _finish(v, torch_rts(final_stride=1), cw.rtsnet_from_flax, seed)


def torch_rts(final_stride):
    """The port's tiny RTS (classification feature at stride 16 * final_stride)."""
    tback, ttm = _torch_backbone()
    tclf = TLinearFilter(
        TFilterInitializerLinear(filter_size=4, feature_dim=D),
        TGNSteepestDescentHinge(**HINGE_KW),
        t_features.ResidualBottleneck(in_dim=32, out_dim=D, norm_scale=math.sqrt(1 / (D * 16)),
                                      feature_dim=8, num_blocks=0, final_conv=True,
                                      final_stride=final_stride))
    return t_rts_net.RTSNet(tback, t_linear_filter.LWLLinearFilter(3, K, D, 2, 0.01, ttm),
                            t_decoder.LWTLDecoder(K, 8, TINY_FT),
                            t_label_encoder.ResidualDS16SW((4, 8, 16, K)), tclf,
                            t_rts_net.ResidualDS16SWClf((4, 8, 16, K)),
                            t_rts_net.LearnersFusion("concat", K, K))


def torch_lwl():
    return t_lwl_net.LWTLNet(*_torch_lwl_parts())


def torch_boxnet():
    return t_lwl_net.LWTLBoxNet(*_torch_lwl_parts(), box_label_encoder=(
        t_label_encoder.ResidualDS16FeatSWBox((4, 8, 16, 16, K), feat_dim=D, use_bn=True)))


KINDS = {
    # JAX pair, a torch net of the same layout, converter, the JAX actor,
    # the port's actor, recipe (module, name)
    "lwl0": dict(pair=tiny_lwl_pair, torch=torch_lwl, convert=cw.lwtlnet_from_flax,
                 jax_actor=lambda a, n: a.make_lwl_actor(n, num_refinement_iter=0),
                 actor=functools.partial(LWLActor, num_refinement_iter=0),
                 recipe=("lwl", "lwl_stage1")),
    "lwl2": dict(pair=tiny_lwl_pair, torch=torch_lwl, convert=cw.lwtlnet_from_flax,
                 jax_actor=lambda a, n: a.make_lwl_actor(n, num_refinement_iter=2),
                 actor=functools.partial(LWLActor, num_refinement_iter=2),
                 recipe=("lwl", "lwl_stage2")),
    "box": dict(pair=tiny_boxnet_pair, torch=torch_boxnet, convert=cw.lwtlboxnet_from_flax,
                jax_actor=lambda a, n: a.make_lwl_box_actor(n), actor=LWLBoxActor,
                recipe=("lwl", "lwl_boxinit")),
    "rts": dict(pair=tiny_rts16_pair, torch=lambda: torch_rts(1), convert=cw.rtsnet_from_flax,
                jax_actor=lambda a, n: a.make_rts_actor(n), actor=RTSActor,
                recipe=("rts", "rts50")),
}
# The JAX recipes' learning rates (pytracking_tpu/training/train_settings)
JAX_RECIPES = {
    ("lwl", "lwl_stage1"): dict(base=2e-4, lrs={"target_model/feature_extractor": 2e-5,
                                                "target_model": 1e-4, "decoder": 1e-4,
                                                "label_encoder": 2e-4},
                                schedule=dict(milestones=(40,))),
    ("lwl", "lwl_boxinit"): dict(base=2e-4, lrs={"box_label_encoder": 1e-3},
                                 schedule=dict(step_size=20)),
    ("rts", "rts50"): dict(base=4e-5, lrs={"feature_extractor/layer2_": 4e-5,
                                           "feature_extractor/layer3_": 4e-5,
                                           "feature_extractor/layer4_": 4e-5,
                                           "target_model": 8e-5, "label_encoder": 8e-5,
                                           "decoder": 8e-5, "clf_encoder": 2e-4,
                                           "fusion_module": 2e-4, "classifier": 2e-4},
                           schedule=dict(milestones=(25, 115, 160))),
}
JAX_RECIPES[("lwl", "lwl_stage2")] = JAX_RECIPES[("lwl", "lwl_stage1")]


def _recipe(module, name):
    return __import__(f"pytracking_tpu_torch.training.train_settings.{module}.{name}",
                      fromlist=["x"])


def _batch(kind, seed=None):
    """The kind's batch: two sequences (RTS one: the JAX training forward
    takes no more), three test frames (box-init one)."""
    return make_batch(BATCH_SEEDS[kind] if seed is None else seed,
                      n_test=1 if kind == "box" else 3, S=1 if kind == "rts" else 2)


@functools.lru_cache(maxsize=None)
def pair(kind):
    """(JAX net, its variables) of a kind: the tiny pair's, with every bias
    moved by 0.1 x a normal draw. The initial biases are 0, so a ReLU whose
    input vector is 0 (a dead position of the layer before) would sit on
    its kink, where rounding decides the gradient."""
    jnet, variables, _ = KINDS[kind]["pair"]()
    rng = np.random.RandomState(3)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (v + 0.1 * rng.randn(*v.shape)).astype(np.float32) if k == "bias" else v
                for k, v in tree.items()}

    return jnet, {"params": walk(variables["params"]), "batch_stats": variables["batch_stats"]}


def _make_tnet(kind):
    """A fresh port net with the pair's weights, in train mode."""
    spec = KINDS[kind]
    _, variables = pair(kind)
    tnet = spec["torch"]()
    tnet.load_state_dict(spec["convert"](variables, tnet))
    return tnet.train()


@pytest.fixture(scope="module", params=sorted(KINDS))
def run(request):
    """For one kind: the JAX actor in train mode on its batch: the loss,
    stats, new batch stats and gradients (one jit of value_and_grad)."""
    from pytracking_tpu.training.actors import tracking as j_actors

    kind = request.param
    jnet, variables = pair(kind)
    actor = KINDS[kind]["jax_actor"](j_actors, jnet)
    batch = {k: jnp.asarray(v) for k, v in _batch(kind).items()}
    (loss, (stats, new_bs)), grads = jax.jit(jax.value_and_grad(actor, has_aux=True))(
        variables["params"], variables["batch_stats"], batch)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"kind": kind, "jnet": jnet, "variables": variables, "actor": actor,
            "loss": float(loss), "stats": {k: float(v) for k, v in stats.items()},
            "batch_stats": as_np(new_bs), "grads": as_np(grads)}


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("shape", [(6, 16, 16), (2, 3, 8, 12)])
def test_lovasz_and_balanced_bce_match_jax(shape):
    """lovasz_seg_loss, lovasz_hinge on one flat image and balanced_bce on
    continuous random logits (no ties) and random masks, one of them empty
    and one full: values and gradients."""
    from pytracking_tpu.models.loss import segmentation as j_seg

    rng = np.random.RandomState(4)
    logits = (rng.randn(*shape) * 2).astype(np.float32)
    labels = (rng.rand(*shape) > 0.6).astype(np.float32)
    labels.reshape(-1, shape[-2] * shape[-1])[0] = 0.0
    labels.reshape(-1, shape[-2] * shape[-1])[1] = 1.0
    jl, jlab = jnp.asarray(logits), jnp.asarray(labels)
    for t_fn, j_fn in ((lovasz_seg_loss, j_seg.lovasz_seg_loss),
                       (balanced_bce, j_seg.balanced_bce)):
        ref, ref_grad = jax.value_and_grad(lambda x: j_fn(x, jlab))(jl)
        x = torch.from_numpy(logits).requires_grad_(True)
        loss = t_fn(x, torch.from_numpy(labels))
        loss.backward()
        _close(loss.item(), float(ref), 1e-6)
        _close(_np(x.grad), np.asarray(ref_grad), 1e-6)
    flat, flat_lab = logits.reshape(-1)[:64], labels.reshape(-1)[:64]
    _close(lovasz_hinge(torch.from_numpy(flat), torch.from_numpy(flat_lab)).item(),
           float(j_seg.lovasz_hinge(jnp.asarray(flat), jnp.asarray(flat_lab))), 1e-6)


# ---------------------------------------------------------------- actors

def _running_stats(state):
    return {k: v for k, v in state.items() if k.endswith(("running_mean", "running_var"))}


def test_actor_loss_terms_and_running_statistics_match_jax(run):
    """The port's actor in train mode against the JAX actor (train=True,
    mutable batch_stats): the loss, each stat under the JAX names, and every
    running statistic moved as flax moves it (RTS's score encoder, in eval
    mode on both sides, unchanged)."""
    kind = run["kind"]
    tnet = _make_tnet(kind)
    start = {k: v.clone() for k, v in _running_stats(tnet.state_dict()).items()}
    loss, stats = KINDS[kind]["actor"](tnet)(to_torch(_batch(kind)))
    assert sorted(stats) == sorted(run["stats"])
    assert np.isfinite(loss.item())
    _close(loss.item(), run["loss"], 1e-5)
    for k, v in stats.items():
        _close(v.item(), run["stats"][k], 1e-5)
    moved = KINDS[kind]["convert"]({"params": run["variables"]["params"],
                                    "batch_stats": run["batch_stats"]}, tnet)
    n_moved = 0
    for k, v in _running_stats(tnet.state_dict()).items():
        _close(_np(v), moved[k].numpy(), 1e-4)
        unused = k.startswith("clf_encoder.") or (kind == "box"
                                                   and k.startswith("label_encoder."))
        assert torch.equal(v, start[k]) == unused, k
        n_moved += not unused
    assert n_moved > 20


def exact_zero(name):
    """Whether a leaf's gradient is exactly 0 by construction, rounding
    alone making it otherwise (on both sides, with either sign): the bias
    of a convolution before a train-mode BatchNorm (RTS's score encoder
    runs its BatchNorms in eval mode)."""
    return name.endswith(("Conv_0.bias", ".bb0.bias")) and not name.startswith("clf_encoder.")


def _grads(kind, batch):
    tnet = _make_tnet(kind)
    KINDS[kind]["actor"](tnet)(batch)[0].backward()
    return {n: p.grad for n, p in tnet.named_parameters() if p.grad is not None}


def test_gradients_match_jax(run):
    """Every parameter's .grad against jax.value_and_grad of the JAX actor,
    through the converter, within GRAD_TOL of the leaf's scale, after
    checking that the port's own gradient is steady under a 3e-7 relative
    change of the images. A leaf the loss does not reach (a sample-weight
    head whose output is dropped, the box-init net's unused mask encoder
    and filter regulariser) has no .grad and a zero JAX gradient; a leaf
    whose gradient is exactly 0 (exact_zero) is held, on both sides, to
    GRAD_TOL of its layer's weight gradient."""
    kind = run["kind"]
    batch = to_torch(_batch(kind))
    g0 = _grads(kind, batch)
    gen = torch.Generator().manual_seed(0)
    moved = dict(batch)
    for k in ("train_images", "test_images"):
        moved[k] = batch[k] * (1 + STEADY_EPS * torch.randn(batch[k].shape, generator=gen))
    g1 = _grads(kind, moved)
    steady = {n: float((g1[n] - g0[n]).abs().max() / g0[n].abs().max()) for n in g0
              if not exact_zero(n)}
    assert max(steady.values()) < STEADY_TOL, max(steady.items(), key=lambda kv: kv[1])

    ref = KINDS[kind]["convert"]({"params": run["grads"],
                                  "batch_stats": run["variables"]["batch_stats"]})
    worst, unreached = {}, []
    for name, g in g0.items():
        r = ref[name].numpy()
        if exact_zero(name):
            scale = np.abs(ref[name.rsplit(".", 1)[0] + ".weight"].numpy()).max()
            worst[name] = max(np.abs(_np(g)).max(), np.abs(r).max()) / scale
            continue
        worst[name] = np.abs(_np(g) - r).max() / np.abs(r).max()
    for name, _ in _make_tnet(kind).named_parameters():
        if name not in g0:
            assert not ref[name].numpy().any(), name
            unreached.append(name)
    bad = {k: v for k, v in worst.items() if v > GRAD_TOL}
    assert not bad, bad
    allowed = ("feature_extractor.layer4",) if kind != "box" else ()
    allowed += ("samp_w_pred",) if kind in ("box", "rts") else ()
    for n in unreached:
        assert n.startswith(allowed) or ".samp_w_pred." in n and (
            kind == "box" and n.startswith("box_label_encoder.")
            or kind == "rts" and n.startswith("clf_encoder.")) or kind == "box" and (
            n.startswith("label_encoder.") or n == "target_model.filter_reg"), n
    assert len(worst) > 40


def test_rts_decodes_every_sequence():
    """RTS on S = 2 sequences in eval mode against one JAX run per sequence
    (eval-mode BatchNorm makes them independent): each sequence's masks and
    classifier scores, and the loss, the mean of the per-sequence losses.
    The JAX training forward encodes sequence 0's scores and returns its
    masks alone, so a port that did the same fails here."""
    from pytracking_tpu.training.actors import tracking as j_actors

    jnet, variables = pair("rts")
    batch = make_batch(1, S=2)
    tnet = _make_tnet("rts").eval()
    with torch.no_grad():
        masks, scores = tnet(*(to_torch(batch)[k] for k in ("train_images", "test_images",
                                                            "train_masks", "train_anno")))
        loss = RTSActor(tnet)(to_torch(batch))[0]
    apply = jax.jit(lambda b: jnet.apply(variables, b["train_images"], b["test_images"],
                                         b["train_masks"], b["train_anno"], train=False))
    actor = jax.jit(j_actors.make_rts_actor(jnet, train=False), static_argnums=())
    losses = []
    for s in range(2):
        one = {k: jnp.asarray(v[:, s:s + 1]) for k, v in batch.items()}
        ref_masks, ref_scores = apply(one)
        _close(_np(masks[:, s]), np.asarray(ref_masks)[:, 0], 1e-5)
        _close(_np(scores[:, s, 0]), np.asarray(ref_scores)[:, 0, ..., 0], 1e-5)
        losses.append(float(actor(variables["params"], variables["batch_stats"], one)[0]))
    _close(loss.item(), np.mean(losses), 1e-5)
    assert abs(losses[0] - losses[1]) > 1e-3 * abs(losses[0])


# ---------------------------------------------------------------- Adam

def test_adam_step_matches_jax_train_step(run):
    """One step of the port's make_train_step with the recipe's optimiser
    (its per-module learning rates, the rest frozen) against the JAX train
    step's update with the JAX recipe's adam_per_module: the loss (1e-5
    relative), the running statistics after it (1e-4), the frozen leaves
    bit for bit unchanged on both sides (out of autograd on the port's),
    every trained leaf with a gradient moved, each trained element's
    movement within 1% of its group's lr of the JAX one where the gradient
    is at least 1% of its leaf's scale, the zero-gradient biases by at most
    lr, and the unreached leaves not moved on either side."""
    from pytracking_tpu.training.optim import adam_per_module

    kind, variables = run["kind"], run["variables"]
    spec = KINDS[kind]
    recipe, jr = _recipe(*spec["recipe"]), JAX_RECIPES[spec["recipe"]]
    batch = _batch(kind)
    jopt = adam_per_module(jr["base"], jr["lrs"], steps_per_epoch=1, gamma=0.2,
                           freeze_unlisted=True, **jr["schedule"])
    # the JAX train step's update (pytracking_tpu/parallel/mesh.make_train_step)
    # on the fixture's value_and_grad
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    updates, _ = jopt.update(jax.tree_util.tree_map(jnp.asarray, run["grads"]),
                             jopt.init(params), params)
    params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    bs, jloss = run["batch_stats"], run["loss"]

    tnet = _make_tnet(kind)
    optimizer, scheduler = t_optim.adam_per_module(
        tnet, recipe.BASE_LR, recipe.MODULE_LRS, steps_per_epoch=1,
        milestones=getattr(recipe, "MILESTONES", None),
        step_size=getattr(recipe, "STEP_SIZE", 15), freeze_unlisted=recipe.FREEZE_UNLISTED)
    lrs = {id(p): g["lr"] for g in optimizer.param_groups for p in g["params"]}
    tloss, _ = t_make_train_step(spec["actor"](tnet), optimizer, scheduler)(to_torch(batch))
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
        if exact_zero(k):
            assert max(np.abs(moved).max(), np.abs(ref_moved).max()) <= 1.01 * lr, k
            continue
        if not g.any():
            assert not moved.any() and not ref_moved.any(), k
            continue
        assert moved.any() and ref_moved.any(), k
        err = np.abs(moved - ref_moved) / lr
        assert err[g >= 0.01 * g.max()].max() <= 1e-2, (k, err.max())
    assert n_trained >= (5 if kind == "box" else 20)


def _label_codes(params, prefixes):
    """The JAX recipe's label of every leaf (pytracking_tpu.training.optim
    ._label_tree) as a constant array of the leaf's shape: the label's
    index in `prefixes` + 1, 0 for '__base__'."""
    from pytracking_tpu.training.optim import _label_tree

    labels = _label_tree(params, sorted(prefixes, key=len, reverse=True))
    codes = {"__base__": 0.0, **{p: float(i + 1) for i, p in enumerate(prefixes)}}
    return jax.tree_util.tree_map(lambda leaf, lab: np.full(np.shape(leaf), codes[lab],
                                                            np.float32), params, labels)


@pytest.mark.parametrize("kind", ["lwl0", "lwl2", "box", "rts"])
def test_parameter_groups_match_jax_labels(kind):
    """Which parameters each port recipe trains, and at which rate, against
    the JAX recipe's optax labels, leaf by leaf through the converter: LWL's
    'target_model' takes the regulariser and 'target_model.feature_extractor'
    the feature block, RTS's backbone trains from layer2 on, the box-init
    recipe trains the box label encoder alone."""
    spec = KINDS[kind]
    recipe, jr = _recipe(*spec["recipe"]), JAX_RECIPES[spec["recipe"]]
    _, variables = pair(kind)
    prefixes = list(jr["lrs"])
    codes = spec["convert"]({"params": _label_codes(variables["params"], prefixes)})
    tnet = spec["torch"]()
    optimizer, _ = t_optim.adam_per_module(tnet, recipe.BASE_LR, recipe.MODULE_LRS,
                                           steps_per_epoch=1,
                                           milestones=getattr(recipe, "MILESTONES", None),
                                           freeze_unlisted=recipe.FREEZE_UNLISTED)
    lrs = {id(p): g["lr"] for g in optimizer.param_groups for p in g["params"]}
    seen = set()
    for n, p in tnet.named_parameters():
        code = codes[n].unique()
        assert code.numel() == 1, n
        label = "__base__" if code.item() == 0 else prefixes[int(code.item()) - 1]
        want = None if label == "__base__" else jr["lrs"][label]
        assert lrs.get(id(p)) == want, (n, label, lrs.get(id(p)))
        assert p.requires_grad == (want is not None), n
        seen.add(label)
    assert seen == set(prefixes) | {"__base__"}
    assert recipe.BASE_LR == jr["base"]


# ---------------------------------------------------------------- the recipes

def _tiny_recipe_net(module, name):
    net = {"lwl_stage1": torch_lwl, "lwl_stage2": torch_lwl, "lwl_boxinit": torch_boxnet,
           "rts50": lambda: torch_rts(2)}[name]()
    t_lwl_net.init_weights(net, torch.Generator().manual_seed(0))
    return net.eval()


@pytest.mark.parametrize("module,name", [("lwl", "lwl_stage1"), ("lwl", "lwl_stage2"),
                                         ("lwl", "lwl_boxinit"), ("rts", "rts50")])
def test_run_training_recipes(module, name, tmp_path, monkeypatch):
    """run_training(module, name) on a tiny net and the CPU, 64x64 crops, one
    step of 2 sequences from the recipe's own pipeline (RTS's classifier at
    stride 32, its labels on that grid): a checkpoint, a finite loss, every
    parameter in the recipe's groups with a nonzero gradient moved and no
    other, every backbone weight bit for bit unchanged and the backbone's
    BatchNorm running statistics moved (train mode under frozen weights),
    and those of RTS's score encoder (eval mode) and of the box-init net's
    mask encoder (not run) unchanged."""
    from pytracking_tpu_torch.run_training import run_training

    monkeypatch.setenv("PYTRACKING_TPU_TORCH_WORKSPACE", str(tmp_path))
    net = _tiny_recipe_net(module, name)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    trainer = run_training(module, name, settings=Settings(batch_size=2, num_workers=1,
                                                           print_interval=1000),
                           max_epochs=1, samples_per_epoch=2, net=net, device="cpu",
                           output_sz=SZ)
    assert (tmp_path / "checkpoints" / module / name / "ep0001.ckpt").exists()
    assert len(trainer.step_log) == 1 and trainer.restarts == 0
    assert np.isfinite(trainer.step_log[0]["loss"])
    params = dict(trainer.net.named_parameters())
    trained = {n for n, p in params.items() if p.requires_grad}
    assert trained
    for k, v in trainer.net.state_dict().items():
        if k in trained:
            reached = params[k].grad is not None and bool(params[k].grad.any())
            assert torch.equal(v, start[k]) != reached, k
        elif k.endswith(("running_mean", "running_var")):
            # the score encoder's BatchNorms run in eval mode; the box-init
            # net does not run the mask encoder
            assert torch.equal(v, start[k]) == (k.startswith("clf_encoder.") or (
                name == "lwl_boxinit" and k.startswith("label_encoder."))), k
        else:
            assert torch.equal(v, start[k]), k
