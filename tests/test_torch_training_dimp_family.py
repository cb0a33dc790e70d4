"""Parity of the port's training of the DiMP family with the JAX package, on
the CPU: the KL losses, PrDiMP's Newton optimiser and the generic
Gauss-Newton descent with their iterates and losses, then for three tiny
nets in train mode (PrDiMP's KL/Newton net, DiMP's net under the KL actor
as SuperDiMP trains it, DiMP-simple's generic Gauss-Newton net) the
training forward, `KLDiMPActor`'s loss terms and every parameter's gradient
against `jax.value_and_grad` of `make_kldimp_actor`; then the port alone:
`run_training` on each DiMP-family recipe for one step with a tiny net.

Weights: the tiny nets of tests/test_torch_dimp_family_ops.py (the JAX
`net.init` with random BatchNorm statistics, converted with
`dimpnet_from_flax`); gradients map through the same converter. Float32.
Tolerances: the losses 1e-6 relative; the optimisers' iterates and losses
1e-4 of the larger of 1 and the reference's largest magnitude; the
forward's scores and IoU scores 1e-4 of that scale; the actor's loss terms
1e-5 of that scale (bb_ce, a difference of a logsumexp and a mean, is
~0.2 here); each gradient leaf 1e-3 of its own largest magnitude, on
textured images, after checking that the port's own gradient moves by less
than 1e-4 of a leaf's scale when the images change by 3e-7 relative
(tests/test_torch_training.py explains why the tiny nets need that).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytracking_tpu_torch.models.classifier import optimizer as t_optimizer
from pytracking_tpu_torch.models.classifier.optimizer import initial_label_map_w
from pytracking_tpu_torch.models.loss import kl_regression as t_kl
from pytracking_tpu_torch.models.meta.steepestdescent import \
    gn_steepest_descent as t_gn_steepest_descent
from pytracking_tpu_torch.training.actors.tracking import KLDiMPActor
from pytracking_tpu_torch.training.processing_utils import gaussian_label_function
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.utils.convert_weights import dimpnet_from_flax

from test_torch_dimp_family_ops import (NEWTON_KW, _filt, _filter_problem, _nchw, _t,
                                        jax_tiny_net, perturb_batch_stats, torch_tiny_net)
from test_torch_lwl_ops import one_thread  # noqa: F401 (autouse: one CPU thread)
from test_torch_training import GRAD_TOL, _close, _np, to_torch
from test_torch_training import real_tensorboardx  # noqa: F401 (autouse)

SZ = 64                        # crops: 4x4 layer3 features, 5x5 score maps
# The net-level batch per tiny net. The tiny nets' gradients jump where
# float32 rounding moves a ReLU input across 0 (tests/test_torch_training.py),
# on both sides: on make_kl_batch seeds 0-11 and 33, a random 3e-7 relative
# change of the images moves JAX's own gradient by 8e-4 to 0.15 of a leaf's
# scale and the port's by as much, and JAX and the port differ by that
# much. The jumps sit mostly in the IoU-Net's modulation branch, whose
# train-mode BatchNorm normalises over the 4 sequences. A parity test of
# gradients needs a batch where the gradient is continuous at rounding
# scale: seed 23, and `test_gradients_match_jax` checks that first.
BATCH_SEEDS = {"prdimp50": 23, "superdimp": 23, "simple": 23}
NUM_PROPOSALS = 8


def _rel(a, b, rtol):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=0.0)


# ---------------------------------------------------------------- losses

def _loss_inputs(seed, shape=(3, 2, 16)):
    rng = np.random.RandomState(seed)
    scores = (rng.randn(*shape) * 3).astype(np.float32)
    density = (rng.rand(*shape) * 4 + 0.05).astype(np.float32)
    gt = np.zeros(shape, np.float32)
    gt[..., 0] = 1.0
    return scores, density, gt


@pytest.mark.parametrize("eps", [0.0, 1e-3])
@pytest.mark.parametrize("mc_dim", [-1, 1])
def test_kl_and_ml_regression_match_jax(mc_dim, eps):
    from pytracking_tpu.models.loss.kl_regression import kl_regression, ml_regression

    shape = (3, 16, 2) if mc_dim == 1 else (3, 2, 16)
    for seed in range(3):
        scores, density, gt = _loss_inputs(seed, shape)
        if mc_dim == 1:
            gt = np.moveaxis(np.moveaxis(gt, 1, -1), -1, 1)
            gt[:] = 0.0
            gt[:, 0] = 1.0
        for j_fn, t_fn in ((kl_regression, t_kl.kl_regression),
                           (ml_regression, t_kl.ml_regression)):
            ref = j_fn(jnp.asarray(scores), jnp.asarray(density), jnp.asarray(gt),
                       mc_dim=mc_dim, eps=eps)
            got = t_fn(_t(scores), _t(density), _t(gt), mc_dim=mc_dim, eps=eps)
            _rel(got.item(), float(ref), 1e-6)


@pytest.mark.parametrize("grid", [(5, 5), (18, 18), (23, 23)])
def test_kl_regression_grid_matches_jax(grid):
    """On DiMP's, PrDiMP-50's and SuperDiMP's score grids, peaked scores
    (a logsumexp far from 0) included."""
    from pytracking_tpu.models.loss.kl_regression import kl_regression_grid

    rng = np.random.RandomState(len(grid) + grid[0])
    for scale in (1.0, 40.0):
        scores = (rng.randn(3, 2, *grid) * scale).astype(np.float32)
        bb = np.concatenate([rng.rand(6, 2) * grid[0] * 10 + 30, rng.rand(6, 2) * 20 + 20], -1)
        dens = gaussian_label_function(bb, 0.05, 4, grid[0] - 1, (grid[0] - 1) * 16,
                                       density=True).reshape(3, 2, *grid)
        for grid_scale in (1.0, 0.5):
            ref = kl_regression_grid(jnp.asarray(scores), jnp.asarray(dens),
                                     grid_scale=grid_scale)
            got = t_kl.kl_regression_grid(_t(scores), _t(dens), grid_scale=grid_scale)
            _rel(got.item(), float(ref), 1e-6)


# ---------------------------------------------------------------- optimisers

@pytest.mark.parametrize("case", ["tracking", "softmax_reg"])
def test_newton_iterates_and_losses_match_jax(case):
    """PrDiMPSteepestDescentNewton with 5 steps and compute_losses: every
    iterate (the filter after each step, not the initial one) and every
    loss (each step's before its update, and the final filter's), from
    perturbed learned parameters; the default return is the triple's
    weights bit for bit."""
    from pytracking_tpu.models.classifier.optimizer import PrDiMPSteepestDescentNewton

    kw = dict(NEWTON_KW, num_iter=5, softmax_reg=-2.0 if case == "softmax_reg" else None)
    feat, w0, bb, sw = _filter_problem(3)
    jm = PrDiMPSteepestDescentNewton(**kw)
    params = {"log_step_length": np.array([-0.2], np.float32),
              "filter_reg": np.array([0.3], np.float32)}
    jw, jiters, jlosses = jm.apply({"params": params}, jnp.asarray(w0), jnp.asarray(feat),
                                   jnp.asarray(bb), sample_weight=jnp.asarray(sw),
                                   compute_losses=True)
    tm = t_optimizer.PrDiMPSteepestDescentNewton(**kw)
    tm.load_state_dict({k: _t(v) for k, v in params.items()})
    args = (_t(_filt(w0)), _nchw(feat), _t(bb))
    w, iters, losses = tm(*args, sample_weight=_t(sw), return_iterates=True,
                          compute_losses=True)
    assert iters.shape[0] == 5 and losses.shape == (6,)
    _close(_np(iters), np.stack([_filt(x) for x in np.asarray(jiters)]), 1e-4)
    _close(_np(losses), jlosses, 1e-4)
    assert torch.equal(w, iters[-1])
    with torch.no_grad():
        plain = tm(*args, sample_weight=_t(sw))
        _, _, none = tm(*args, sample_weight=_t(sw), return_iterates=True)
    assert torch.equal(plain, w) and none.numel() == 0


def test_gn_steepest_descent_iterates_and_losses_match_jax():
    """The generic Gauss-Newton descent's iterates and losses (the mean
    squared residual over every leaf), a toy residual of two leaves."""
    from pytracking_tpu.models.meta.steepestdescent import gn_steepest_descent

    rng = np.random.RandomState(6)
    A = rng.randn(5, 3, 4).astype(np.float32)
    y = rng.randn(5, 3).astype(np.float32)
    x0 = rng.randn(3, 4).astype(np.float32) * 0.3
    ref = gn_steepest_descent(
        lambda x: {"data": jnp.tanh(jnp.einsum("rsd,sd->rs", A, x)) - y, "reg": 0.1 * x[None]},
        jnp.asarray(x0), 4, residual_batch_dim=1, steplength_reg=0.2, compute_losses=True)
    got = t_gn_steepest_descent(
        lambda x: {"data": torch.tanh(torch.einsum("rsd,sd->rs", _t(A), x)) - _t(y),
                   "reg": 0.1 * x[None]},
        _t(x0), 4, residual_batch_dim=1, steplength_reg=0.2, return_iterates=True,
        compute_losses=True)
    for g, r in zip(got, ref):
        _close(_np(g), r, 1e-4)
    assert got[1].shape == (4, 3, 4) and got[2].shape == (5,)


# ---------------------------------------------------------------- the nets

def make_kl_batch(seed, sz=SZ, S=4, n_train=3, n_test=2, P=NUM_PROPOSALS):
    """A frame-major numpy batch with PrDiMP's targets, images NHWC in
    0-255: bright textured 24x24 squares on a dark texture (no flat region:
    tests/test_torch_training.make_batch says why), proposal 0 the test box
    and the others around it, proposal densities random in [0.05, 4.05],
    gt_density 1 for proposal 0, label densities of the test boxes at sigma
    1/4 of the feature grid."""
    rng = np.random.RandomState(seed)

    def frames(n):
        ims, boxes = [], []
        for _ in range(n * S):
            im = rng.rand(sz, sz, 3).astype(np.float32) * 60
            x, y = rng.randint(8, sz - 32, 2)
            im[y:y + 24, x:x + 24] = 190.0 + rng.rand(24, 24, 3) * 60
            ims.append(im)
            boxes.append([float(x), float(y), 24.0, 24.0])
        return (np.stack(ims).reshape(n, S, sz, sz, 3),
                np.asarray(boxes, np.float32).reshape(n, S, 4))

    train_images, train_anno = frames(n_train)
    test_images, test_anno = frames(n_test)
    proposals = test_anno[:, :, None] + rng.randn(n_test, S, P, 4).astype(np.float32) \
        * np.array([3, 3, 2, 2], np.float32)
    proposals[:, :, 0] = test_anno
    gt = np.zeros((n_test, S, P), np.float32)
    gt[..., 0] = 1.0
    dens = gaussian_label_function(test_anno.reshape(-1, 4), 0.25, 4, sz // 16, sz, density=True)
    return {"train_images": train_images, "test_images": test_images,
            "train_anno": train_anno, "test_proposals": proposals.astype(np.float32),
            "proposal_density": (rng.rand(n_test, S, P) * 4 + 0.05).astype(np.float32),
            "gt_density": gt,
            "test_label_density": dens.reshape((n_test, S) + dens.shape[1:])}


_PAIRS = {}


def pair(kind):
    """(jax net, flax variables as numpy, a function making the torch net
    with the same weights, in train mode), built once per kind."""
    if kind not in _PAIRS:
        jnet = jax_tiny_net(kind)
        im = jnp.zeros((1, 1, SZ, SZ, 3))
        bb = jnp.array([[[20.0, 20.0, 24.0, 24.0]]])
        variables = jax.jit(lambda k: jnet.init(k, im, im, bb, bb[:, :, None], train=False))(
            jax.random.PRNGKey(1))
        variables = perturb_batch_stats(jax.tree_util.tree_map(np.asarray, dict(variables)), 4)

        def make_tnet():
            tnet = torch_tiny_net(kind)
            tnet.load_state_dict(dimpnet_from_flax(variables, tnet))
            return tnet.train()

        _PAIRS[kind] = (jnet, variables, make_tnet)
    return _PAIRS[kind]


_JAX_RUNS = {}


def jax_run(kind):
    """The JAX side on make_kl_batch(BATCH_SEEDS[kind]): the train-mode
    forward with its new batch stats, and make_kldimp_actor's loss, stats
    and gradients, in one jit."""
    if kind not in _JAX_RUNS:
        from pytracking_tpu.training.actors.tracking import make_kldimp_actor

        jnet, variables, _ = pair(kind)
        batch = {k: jnp.asarray(v) for k, v in make_kl_batch(BATCH_SEEDS[kind]).items()}
        bs = variables["batch_stats"]
        actor = make_kldimp_actor(jnet)

        @jax.jit
        def run(params):
            (scores, bb_scores), mutated = jnet.apply(
                {"params": params, "batch_stats": bs}, batch["train_images"],
                batch["test_images"], batch["train_anno"], batch["test_proposals"], train=True,
                mutable=["batch_stats"])
            (loss, (stats, _)), grads = jax.value_and_grad(actor, has_aux=True)(params, bs,
                                                                                 batch)
            return scores, bb_scores, mutated["batch_stats"], loss, stats, grads

        out = jax.tree_util.tree_map(np.asarray, run(variables["params"]))
        _JAX_RUNS[kind] = dict(zip(("scores", "bb_scores", "batch_stats", "loss", "stats",
                                    "grads"), out))
    return _JAX_RUNS[kind]


KINDS = sorted(BATCH_SEEDS)


@pytest.mark.parametrize("kind", KINDS)
def test_train_forward_and_actor_match_jax(kind):
    """DiMPnet.forward in train mode against net.apply(train=True,
    mutable=['batch_stats']): the scores of every iterate, the IoU-Net's
    scores and the running statistics after it (layer4's left out: the
    port's ResNet does not run it); then KLDiMPActor's loss terms against
    make_kldimp_actor's."""
    _, variables, make_tnet = pair(kind)
    ref = jax_run(kind)
    batch = to_torch(make_kl_batch(BATCH_SEEDS[kind]))
    tnet = make_tnet()
    scores, bb_scores = tnet(*(batch[k] for k in ("train_images", "test_images", "train_anno",
                                                  "test_proposals")))
    assert scores.shape == (3, 2, 4, 1, 5, 5)          # (iterates, Ntest, S, 1, h, w)
    _close(np.moveaxis(_np(scores), 3, -1), ref["scores"], 1e-4)
    _close(_np(bb_scores), ref["bb_scores"], 1e-4)
    moved = dimpnet_from_flax({"params": variables["params"],
                               "batch_stats": ref["batch_stats"]}, tnet)
    for k, v in tnet.state_dict().items():
        if k.endswith(("_mean", "_var")) and not k.startswith("feature_extractor.layer4"):
            _close(_np(v), moved[k].numpy(), 1e-4)

    loss, stats = KLDiMPActor(make_tnet())(batch)
    assert sorted(stats) == sorted(ref["stats"])
    _close(loss.item(), ref["loss"], 1e-5)
    for k, v in stats.items():
        _close(v.item(), ref["stats"][k], 1e-5)


def _grads(make_tnet, batch):
    tnet = make_tnet()
    KLDiMPActor(tnet)(batch)[0].backward()
    return {n: p.grad for n, p in tnet.named_parameters()
            if p.grad is not None and not n.endswith(("Conv_0.bias", "Dense_0.bias"))}


def _rounding_jump(make_tnet, batch):
    """How far the port's own gradient moves (the largest change over the
    leaves, relative to each leaf's scale) when the images change by a
    random 3e-7 relative."""
    g0 = _grads(make_tnet, batch)
    gen = torch.Generator().manual_seed(0)
    moved = dict(batch)
    for k in ("train_images", "test_images"):
        moved[k] = batch[k] * (1 + 3e-7 * torch.randn(batch[k].shape, generator=gen))
    g1 = _grads(make_tnet, moved)
    return max(float((g1[n] - g0[n]).abs().max() / g0[n].abs().max()) for n in g0)


@pytest.mark.parametrize("kind", KINDS)
def test_gradients_match_jax(kind):
    """Every parameter's .grad under KLDiMPActor against jax.value_and_grad
    of make_kldimp_actor, mapped through dimpnet_from_flax: within GRAD_TOL
    of the leaf's largest magnitude, the optimiser's own parameters (step
    length, regulariser, label / mask / weight maps) among them, through
    the unrolled steps. A bias that a train-mode BatchNorm follows has an
    exact gradient of 0: both sides hold rounding there, each within
    GRAD_TOL of the layer's weight gradient."""
    _, variables, make_tnet = pair(kind)
    ref = dimpnet_from_flax({"params": jax_run(kind)["grads"],
                             "batch_stats": variables["batch_stats"]})
    batch = to_torch(make_kl_batch(BATCH_SEEDS[kind]))
    assert _rounding_jump(make_tnet, batch) < 1e-4
    tnet = make_tnet()
    KLDiMPActor(tnet)(batch)[0].backward()
    modules = dict(tnet.named_modules())
    worst, optimiser = {}, []
    for name, p in tnet.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else _np(p.grad)
        r = ref[name].numpy()
        block, layer, leaf = name.rsplit(".", 2)
        if leaf == "bias" and layer in ("Conv_0", "Dense_0") \
                and getattr(modules[block], "BatchNorm_0", None) is not None:
            scale = np.abs(ref[f"{block}.{layer}.weight"].numpy()).max()
            worst[name] = max(np.abs(g).max(), np.abs(r).max()) / scale
            continue
        scale = np.abs(r).max()
        if scale == 0:
            assert np.abs(g).max() == 0, name
            continue
        worst[name] = np.abs(g - r).max() / scale
        if name.startswith("classifier.filter_optimizer."):
            optimiser.append(name)
    bad = {k: v for k, v in worst.items() if v > GRAD_TOL}
    assert not bad, bad
    assert len(worst) > 50
    assert len(optimiser) >= (2 if kind == "prdimp50" else 4), optimiser


# ---------------------------------------------------------------- the recipes

def test_builders_take_the_recipes_keywords(monkeypatch):
    """The recipes' net keywords reach the optimisers: SuperDiMP's label
    sigma is output_sigma_factor / search_area_factor * feature_sz = 0.25 /
    6 x 22 cells, not the fixed 0.9, and PrDiMP's 0.25 / 5 x 18; a score
    activation the port does not implement raises ValueError, a keyword a
    builder does not take TypeError."""
    from pytracking_tpu_torch.models.tracking import dimpnet as t_dimpnet
    from pytracking_tpu_torch.training.train_settings.dimp import (dimp18, prdimp18, prdimp50,
                                                                    super_dimp,
                                                                    super_dimp_simple)

    # the optimiser alone: no backbone, no net
    monkeypatch.setattr(t_dimpnet.backbones, "resnet50", lambda **kw: None)
    monkeypatch.setattr(t_dimpnet.backbones, "resnet18", lambda **kw: None)
    monkeypatch.setattr(t_dimpnet, "_dimpnet", lambda backbone, clf_fe, opt, *a, **kw: opt)
    opt = {}
    for name, mod in (("super_dimp", super_dimp), ("super_dimp_simple", super_dimp_simple),
                      ("prdimp50", prdimp50), ("prdimp18", prdimp18), ("dimp18", dimp18)):
        settings = Settings()
        if name.startswith("super"):
            super_dimp.operating_point(settings)
        opt[name] = mod.make_net(settings, device="cpu")
    d = torch.arange(100, dtype=torch.float32) * 0.1
    for name, sigma in (("super_dimp", 0.25 / 6 * 22), ("super_dimp_simple", 0.25 / 6 * 22),
                        ("dimp18", 0.25 / 5 * 18)):
        torch.testing.assert_close(opt[name].label_map_w.detach(), initial_label_map_w(d, sigma),
                                   rtol=0, atol=0)
        assert opt[name].num_iter == 5
    assert isinstance(opt["super_dimp"], t_optimizer.DiMPSteepestDescentGN)
    assert abs(opt["super_dimp"].log_step_length.item() - np.log(0.9)) < 1e-7
    assert abs(opt["super_dimp"].filter_reg.item() - 0.1) < 1e-7
    assert opt["prdimp50"].gauss_sigma == opt["prdimp18"].gauss_sigma == 0.25 / 5 * 18
    with pytest.raises(ValueError, match="relu"):
        t_dimpnet.dimpnet50(device="cpu", score_act="bentpar")
    with pytest.raises(TypeError):
        t_dimpnet.klcedimpnet50(device="cpu", score_act="relu")


def _seeded_tiny_net(kind):
    from pytracking_tpu_torch.models.tracking.dimpnet import init_weights

    return init_weights(torch_tiny_net(kind), torch.Generator().manual_seed(0))


# recipe: (the tiny net kind it trains here, a stats key of its objective)
RECIPES = {"dimp18": ("dimp18", "Loss/iou"), "prdimp18": ("prdimp18", "Loss/bb_ce"),
           "prdimp50": ("prdimp50", "Loss/bb_ce"), "super_dimp": ("superdimp", "Loss/bb_ce"),
           "super_dimp_simple": ("simple", "Loss/bb_ce")}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_run_training_dimp_family_recipes(name, tmp_path, monkeypatch):
    """run_training('dimp', name) on a tiny net of the recipe's kind and the
    CPU, one step of 2 sequences (64x64 crops; SuperDiMP's recipes set their
    own 352x352 operating point): a checkpoint, a finite loss of the
    recipe's objective (DiMP's or the KL one), every parameter the loss
    reaches moved."""
    from pytracking_tpu_torch.run_training import run_training

    kind, key = RECIPES[name]
    monkeypatch.setenv("PYTRACKING_TPU_TORCH_WORKSPACE", str(tmp_path))
    net = _seeded_tiny_net(kind)
    start = {n: p.detach().clone() for n, p in net.named_parameters()}
    settings = Settings(output_sz=64, feature_sz=4, batch_size=2, num_workers=1,
                        print_interval=1000)
    trainer = run_training("dimp", name, settings=settings, max_epochs=1, samples_per_epoch=2,
                           net=net, device="cpu")
    assert (tmp_path / "checkpoints" / "dimp" / name / "ep0001.ckpt").exists()
    assert len(trainer.step_log) == 1 and trainer.restarts == 0
    assert np.isfinite(trainer.step_log[0]["loss"]) and key in trainer.stats["train"]
    assert settings.output_sz == (352 if name.startswith("super") else 64)
    still = {n for n, p in trainer.net.named_parameters() if torch.equal(p, start[n])}
    assert not {n for n in still if not n.startswith("feature_extractor.layer4")}, sorted(still)
