"""Parity of the port's DiMP training path with the JAX package, on the CPU.

BatchNorm in train mode against flax's; DiMP's steepest descent with its
iterates and losses; the training forward of the tiny DiMP of
tests/test_torch_dimp.py (the net of tests/test_dimp_tracker.py) in train
mode, its actor, every parameter's gradient, and two Adam steps; the
per-module Adam and its schedule against optax; then the port alone: the
loss halves on a fixed batch in 25 steps, the trainer's checkpoints,
fail-safe restart and resume, and `run_training`.

Weights: the JAX `net.init` with random BatchNorm statistics, converted
with `dimpnet_from_flax`; gradients go through the same converter (its maps
are linear). Float32. Tolerances, each relative to the larger of 1 and the
reference's largest magnitude unless said otherwise: BatchNorm outputs
1e-5, running statistics 1e-6; optimiser iterates and losses 1e-5; the
forward's scores, IoU predictions and new running statistics 1e-4; the
actor's loss and stats 1e-4; each gradient leaf 1e-3 of its own largest
magnitude (`GRAD_TOL`); learning rates and per-module Adam
trajectories 1e-6 relative; the Adam steps as in their test.

The net-level batches hold 4 sequences: in train mode the IoU-Net's
modulation branch normalises over the sequences alone, and with 2 of them
a 1e-7 relative change of the images moves the IoU predictions by 2e-4 of
their scale (with 4, by 6e-6).

The port's ResNet runs no stage after its last output, so layer4's running
statistics stay put in train mode, where flax's ResNet runs layer4 and
moves them; DiMP never reads them (the test checks both sides of that).
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytracking_tpu_torch.models.classifier.optimizer import \
    DiMPSteepestDescentGN as TDiMPSteepestDescentGN
from pytracking_tpu_torch.models.layers.blocks import BatchNorm
from pytracking_tpu_torch.models.tracking.dimpnet import init_weights
from pytracking_tpu_torch.parallel.mesh import make_train_step as t_make_train_step
from pytracking_tpu_torch.training import optim as t_optim
from pytracking_tpu_torch.training.actors.tracking import DiMPActor
from pytracking_tpu_torch.training.processing_utils import gaussian_label_function
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.trainer import LTRTrainer
from pytracking_tpu_torch.utils.convert_weights import dimpnet_from_flax

from test_torch_dimp import _perturb_batch_stats, jax_tiny_dimpnet, torch_tiny_dimpnet
from test_torch_lwl_ops import one_thread  # noqa: F401 (autouse: one CPU thread)


@pytest.fixture(autouse=True)
def real_tensorboardx(monkeypatch):
    """The trainer's scalar writer is tensorboardX's where it imports.
    tests/refshim.py installs an empty `tensorboardX` (SummaryWriter =
    object) in the worker that runs a file importing it; a training test
    scheduled after such a file in the same worker would hand that stub to
    the trainer. Drop the stub, so that the import finds the installed
    package or fails as it would without one."""
    tb = sys.modules.get("tensorboardX")
    if tb is not None and getattr(tb, "__file__", None) is None:
        monkeypatch.delitem(sys.modules, "tensorboardX")


GRAD_TOL = 1e-3
SZ = 64                        # crops: 4x4 layer3 features, 5x5 score maps
# The net-level batch. The tiny net's gradient jumps where float32
# rounding moves a ReLU input across 0 (one activation of a 4x4 map is a
# large share of a leaf's gradient): a random 3e-7 relative change of the
# images moves the port's own gradient by 2e-3 to 8e-2 of a leaf's scale on
# seeds 0-4 and 6-7 of make_batch, by 6e-5 on seed 5, and the JAX
# gradients differ from the port's by as much as that. A parity test of
# gradients needs a batch where the gradient is continuous at rounding
# scale: seed 5, and `test_gradients_match_jax` checks that first.
BATCH_SEED = 5


def _close(a, b, atol):
    """|a - b| <= atol * max(1, max |b|)."""
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(np.asarray(a, np.float64), b,
                               atol=atol * max(1.0, np.abs(b).max()), rtol=0.0)


def _np(t):
    return t.detach().numpy()


def make_batch(seed, sz=SZ, S=4, n_train=2, n_test=2, P=4, label_sigma=0.05):
    """A frame-major numpy batch, images NHWC in 0-255: bright textured
    24x24 squares on a dark texture, proposals around the test boxes,
    random IoU targets in [-1, 1], Gaussian labels of the test boxes.

    No region is flat: on a flat square many pre-activations are equal, so
    a ReLU kink that float32 rounding puts on either side flips them all
    at once. There a uniform 1e-6 rescale of the images moves the port's
    own image gradient by 1.7% of its scale on one frame, and the JAX
    gradients differ from the port's by up to 10% on a backbone leaf."""
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
    label = gaussian_label_function(test_anno.reshape(-1, 4), label_sigma, 4, sz // 16, sz)
    return {"train_images": train_images, "test_images": test_images,
            "train_anno": train_anno, "test_proposals": proposals.astype(np.float32),
            "proposal_iou": (rng.rand(n_test, S, P) * 2 - 1).astype(np.float32),
            "test_label": label.reshape((n_test, S) + label.shape[1:])}


def to_torch(batch):
    """numpy batch -> the port's: tensors, images NCHW."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(v, -1, 2) if k.endswith("images") else v)) for k, v in batch.items()}


def jax_actor(jnet):
    from pytracking_tpu.training.actors.tracking import make_dimp_actor

    return make_dimp_actor(jnet, hinge_threshold=0.05, train=True)


@pytest.fixture(scope="module")
def pair():
    """(jax net, flax variables as numpy, a function making the torch net
    with the same weights, in train mode)."""
    jnet = jax_tiny_dimpnet()
    im = jnp.zeros((1, 1, SZ, SZ, 3))
    bb = jnp.array([[[20.0, 20.0, 24.0, 24.0]]])
    variables = jax.jit(lambda k: jnet.init(k, im, im, bb, bb[:, :, None], train=False))(
        jax.random.PRNGKey(0))
    variables = _perturb_batch_stats(jax.tree_util.tree_map(np.asarray, dict(variables)), 3)

    def make_tnet():
        tnet = torch_tiny_dimpnet()
        tnet.load_state_dict(dimpnet_from_flax(variables, tnet))
        return tnet.train()

    return jnet, variables, make_tnet


@pytest.fixture(scope="module")
def jax_run(pair):
    """The JAX side on make_batch(BATCH_SEED): the train-mode forward with its new
    batch stats, and the actor's loss, stats and gradients (one jit each)."""
    jnet, variables, _ = pair
    batch = {k: jnp.asarray(v) for k, v in make_batch(BATCH_SEED).items()}
    bs = variables["batch_stats"]

    @jax.jit
    def forward(params):
        return jnet.apply({"params": params, "batch_stats": bs}, batch["train_images"],
                          batch["test_images"], batch["train_anno"], batch["test_proposals"],
                          train=True, mutable=["batch_stats"])

    (scores, iou), mutated = forward(variables["params"])
    (loss, (stats, _)), grads = jax.jit(jax.value_and_grad(jax_actor(jnet), has_aux=True))(
        variables["params"], bs, batch)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"scores": np.asarray(scores), "iou": np.asarray(iou),
            "batch_stats": as_np(mutated["batch_stats"]), "loss": float(loss),
            "stats": {k: float(v) for k, v in stats.items()}, "grads": as_np(grads)}


# ---------------------------------------------------------------- BatchNorm

BN_CASES = {
    # (shape with the feature axis last, feature axis in the port, mean, std)
    "nchw": ((6, 5, 5, 8), 1, 0.0, 1.0),
    "tokens": ((4, 7, 16), -1, 0.5, 2.0),
    # a mean of 4 standard deviations: E[x²] - E[x]² cancels 17 to 1. Far
    # larger means leave float32 rounding that depends on the summation
    # order, which XLA's and PyTorch's reductions do not share.
    "large_mean": ((3, 4, 4, 8), 1, 4.0, 1.0),
}


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batchnorm_train_mode_matches_flax(case):
    import flax.linen as nn

    shape, dim, mean, std = BN_CASES[case]
    rng = np.random.RandomState(len(case))
    x = (rng.randn(*shape) * std + mean).astype(np.float32)
    c = shape[-1]
    scale, bias = rng.rand(c).astype(np.float32) + 0.5, rng.randn(c).astype(np.float32)
    ra_mean, ra_var = rng.randn(c).astype(np.float32), rng.rand(c).astype(np.float32) + 0.5

    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    y, mutated = bn.apply({"params": {"scale": scale, "bias": bias},
                           "batch_stats": {"mean": ra_mean, "var": ra_var}},
                          jnp.asarray(x), mutable=["batch_stats"])

    m = BatchNorm(c, dim=dim).train()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(ra_mean))
        m.running_var.copy_(torch.from_numpy(ra_var))
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy() if dim == 1 else x)
    out = m(xt)
    got = np.moveaxis(_np(out), 1, -1) if dim == 1 else _np(out)
    _close(got, y, 1e-5)
    _close(_np(m.running_mean), mutated["batch_stats"]["mean"], 1e-6)
    _close(_np(m.running_var), mutated["batch_stats"]["var"], 1e-6)
    # the biased variance: the unbiased one moves the running variance by
    # 0.1 * var / (n - 1), far outside 1e-6 here
    n = x.size // c
    unbiased = 0.9 * ra_var + 0.1 * x.reshape(-1, c).var(0, ddof=1)
    assert np.abs(_np(m.running_var) - unbiased).max() > 0.1 * x.reshape(-1, c).var(0).min() / n


def test_inference_paths_unchanged():
    """The default returns of the optimiser and of get_filter are the
    triple's weights bit for bit, and BatchNorm's eval path gives the same
    bits before and after a train-mode forward once the running statistics
    that forward moved are put back."""
    torch.manual_seed(0)
    opt = TDiMPSteepestDescentGN(num_iter=3, init_step_length=0.9, init_filter_reg=0.1,
                                 init_gauss_sigma=0.9, num_dist_bins=10, bin_displacement=0.5,
                                 mask_init_factor=3.0)
    w0 = torch.randn(2, 1, 8, 4, 4)
    feat = torch.randn(3, 2, 8, 6, 6)
    bb = torch.tensor([[[30.0, 30.0, 24.0, 24.0]] * 2] * 3)
    with torch.no_grad():
        plain = opt(w0, feat, bb)
        triple = opt(w0, feat, bb, return_iterates=True, compute_losses=True)
        assert torch.equal(plain, triple[0]) and torch.equal(plain, triple[1][-1])

    net = torch_tiny_dimpnet()
    init_weights(net, torch.Generator().manual_seed(0))
    f = torch.randn(2, 2, 256, 6, 6)
    with torch.no_grad():
        clf = net.classifier
        plain = clf.get_filter(clf.extract_classification_feat(f), bb[:2])
        triple = clf.get_filter(clf.extract_classification_feat(f), bb[:2],
                                return_iterates=True)
        assert torch.equal(plain, triple[0]) and triple[2].numel() == 0

    bn = BatchNorm(8).eval()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_()
        bn.running_mean.normal_()
        bn.running_var.uniform_(0.5, 1.5)
    x = torch.randn(4, 8, 5, 5)
    before = bn(x)
    saved = copy.deepcopy(bn.state_dict())
    bn.train()(x * 3 + 1)
    assert not torch.equal(bn.running_mean, saved["running_mean"])
    bn.load_state_dict(saved)
    assert torch.equal(bn.eval()(x), before)


# ---------------------------------------------------------------- optimiser

def test_optimizer_iterates_and_losses_match_jax():
    """DiMPSteepestDescentGN with 5 steps and compute_losses: every
    iterate (5) and every loss (6), from perturbed learned parameters."""
    from pytracking_tpu.models.classifier.optimizer import DiMPSteepestDescentGN

    kw = dict(num_iter=5, feat_stride=16, init_step_length=0.9, init_filter_reg=0.1,
              init_gauss_sigma=0.9, num_dist_bins=10, bin_displacement=0.5,
              mask_init_factor=3.0)
    rng = np.random.RandomState(0)
    N, S, C, H, W = 3, 2, 8, 6, 6
    w0 = rng.randn(S, 4, 4, C, 1).astype(np.float32) * 0.1
    feat = rng.randn(N, S, H, W, C).astype(np.float32)
    bb = (rng.rand(N, S, 4) * 20 + np.array([20, 20, 20, 20])).astype(np.float32)
    jopt = DiMPSteepestDescentGN(**kw)
    params = jax.tree_util.tree_map(np.asarray, jopt.init(
        jax.random.PRNGKey(0), jnp.asarray(w0), jnp.asarray(feat), jnp.asarray(bb))["params"])
    params = {k: (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
              if k.endswith("_w") else v for k, v in params.items()}
    jw, jiters, jlosses = jopt.apply({"params": params}, jnp.asarray(w0), jnp.asarray(feat),
                                     jnp.asarray(bb), compute_losses=True)

    topt = TDiMPSteepestDescentGN(**kw)
    topt.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    w, iters, losses = topt(torch.from_numpy(np.moveaxis(w0, (3, 4), (2, 1)).copy()),
                            torch.from_numpy(np.moveaxis(feat, -1, 2).copy()),
                            torch.from_numpy(bb), return_iterates=True, compute_losses=True)
    assert iters.shape[0] == 5 and losses.shape == (6,)
    _close(np.transpose(_np(iters), (0, 1, 4, 5, 3, 2)), jiters, 1e-5)   # (it, S, fh, fw, C, 1)
    _close(_np(losses), jlosses, 1e-5)
    assert torch.equal(w, iters[-1])


# ---------------------------------------------------------------- the net

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def test_train_forward_matches_jax(pair, jax_run):
    """DiMPnet.forward in train mode against net.apply(train=True,
    mutable=['batch_stats']): the scores of every iterate, the IoU
    predictions and the running statistics after the forward (the
    backbone's moved twice, by the train images and then the test images)."""
    jnet, variables, make_tnet = pair
    tnet = make_tnet()
    before = {k: v.clone() for k, v in tnet.state_dict().items() if k.endswith(("_mean", "_var"))}
    scores, iou = tnet(*(to_torch(make_batch(BATCH_SEED))[k] for k in
                         ("train_images", "test_images", "train_anno", "test_proposals")))
    assert scores.shape == (3, 2, 4, 1, 5, 5)
    _close(np.moveaxis(_np(scores), 3, -1), jax_run["scores"], 1e-4)
    _close(_np(iou), jax_run["iou"], 1e-4)

    ref = dimpnet_from_flax({"params": variables["params"],
                             "batch_stats": jax_run["batch_stats"]}, tnet)
    sd = tnet.state_dict()
    moved = 0
    for k, v in before.items():
        if k.startswith("feature_extractor.layer4"):
            # not run by the port: unchanged there, moved by flax
            assert torch.equal(sd[k], v)
            assert not np.array_equal(ref[k].numpy(), v.numpy())
            continue
        _close(_np(sd[k]), ref[k].numpy(), 1e-4)
        moved += not torch.equal(sd[k], v)
    assert moved == len([k for k in before if not k.startswith("feature_extractor.layer4")])


def test_actor_matches_jax(pair, jax_run):
    """DiMPActor against make_dimp_actor: the loss and the four stats."""
    _, _, make_tnet = pair
    loss, stats = DiMPActor(make_tnet(), hinge_threshold=0.05)(
        to_torch(make_batch(BATCH_SEED)))
    assert sorted(stats) == sorted(jax_run["stats"])
    _close(loss.item(), jax_run["loss"], 1e-4)
    for k, v in stats.items():
        _close(v.item(), jax_run["stats"][k], 1e-4)


def _grads(make_tnet, batch):
    tnet = make_tnet()
    DiMPActor(tnet, hinge_threshold=0.05)(batch)[0].backward()
    return {n: p.grad for n, p in tnet.named_parameters()
            if p.grad is not None and not n.endswith(("Conv_0.bias", "Dense_0.bias"))}


def _rounding_jump(make_tnet, batch, trials=2):
    """How far the port's own gradient moves (the largest change over the
    leaves, relative to each leaf's scale; biases of BatchNorm'd layers
    left out) when the images change by a random 3e-7 relative."""
    g0 = _grads(make_tnet, batch)
    gen = torch.Generator().manual_seed(0)
    worst = 0.0
    for _ in range(trials):
        moved = dict(batch)
        for k in ("train_images", "test_images"):
            moved[k] = batch[k] * (1 + 3e-7 * torch.randn(batch[k].shape, generator=gen))
        g1 = _grads(make_tnet, moved)
        worst = max([worst] + [float((g1[n] - g0[n]).abs().max() / g0[n].abs().max())
                               for n in g0])
    return worst


def test_gradients_match_jax(pair, jax_run):
    """Every parameter's .grad against jax.value_and_grad of the actor,
    mapped through dimpnet_from_flax: within GRAD_TOL of the leaf's largest
    magnitude (a parameter the loss does not reach, as layer4's, has no
    .grad and a zero JAX gradient). The bias of a convolution or dense
    layer that a train-mode BatchNorm follows has an exact gradient of 0
    (the batch mean takes it out): both sides hold rounding noise there,
    each within GRAD_TOL of the layer's weight gradient."""
    _, variables, make_tnet = pair
    batch = to_torch(make_batch(BATCH_SEED))
    assert _rounding_jump(make_tnet, batch) < 1e-4
    tnet = make_tnet()
    loss, _ = DiMPActor(tnet, hinge_threshold=0.05)(batch)
    loss.backward()
    ref = dimpnet_from_flax({"params": jax_run["grads"],
                             "batch_stats": variables["batch_stats"]}, tnet)
    worst = {}
    modules = dict(tnet.named_modules())
    for name, p in tnet.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else _np(p.grad)
        r = ref[name].numpy()
        block, layer, leaf = name.rsplit(".", 2)
        if leaf == "bias" and layer in ("Conv_0", "Dense_0") \
                and getattr(modules[block], "BatchNorm_0", None) is not None:
            weight_scale = np.abs(ref[f"{block}.{layer}.weight"].numpy()).max()
            worst[name] = max(np.abs(g).max(), np.abs(r).max()) / weight_scale
            continue
        scale = np.abs(r).max()
        if scale == 0:
            assert np.abs(g).max() == 0, name
            continue
        worst[name] = np.abs(g - r).max() / scale
    bad = {k: v for k, v in worst.items() if v > GRAD_TOL}
    assert not bad, bad
    assert len(worst) > 50


def test_two_adam_steps_match_jax_train_step(pair, jax_run):
    """Two steps of the port's make_train_step with torch.optim.Adam(1e-4)
    against the JAX make_train_step with optax.adam(1e-4), on one batch:
    each step's loss (1e-4 relative) and the running statistics after it
    (1e-4); each parameter's movement after step 1 within 1e-6 (1% of the
    step) where the gradient is at least 1% of its leaf's scale, and after
    step 2 within 2e-6 for 99% of all the parameters' elements (all but
    0.074% measured). Adam moves
    every element by about lr * sign(g), so where g is within rounding of
    0 (the biases that a train-mode BatchNorm follows: exactly 0) rounding
    picks the direction; those biases are only held to Adam's reach. After
    step 1 the two nets differ there by up to 2e-4, and the tiny net's ReLU
    kinks (BATCH_SEED) make step 2's gradient differ at a few elements."""
    from pytracking_tpu.parallel.mesh import make_train_step

    jnet, variables, make_tnet = pair
    grads = dimpnet_from_flax({"params": jax_run["grads"],
                               "batch_stats": variables["batch_stats"]})
    batch = make_batch(BATCH_SEED)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = make_train_step(jax_actor(jnet), optax.adam(1e-4))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    bs = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    opt_state = optax.adam(1e-4).init(params)

    tnet = make_tnet()
    tstep = t_make_train_step(DiMPActor(tnet, hinge_threshold=0.05),
                              torch.optim.Adam(tnet.parameters(), lr=1e-4))
    tbatch = to_torch(batch)
    start = dimpnet_from_flax(variables, tnet)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    modules = dict(tnet.named_modules())

    def zero_grad_bias(k):
        block, layer, leaf = k.rsplit(".", 2)
        return leaf == "bias" and layer in ("Conv_0", "Dense_0") \
            and getattr(modules[block], "BatchNorm_0", None) is not None

    for i in range(2):
        params, bs, opt_state, jloss, _ = step(params, bs, opt_state, jbatch)
        tloss, _ = tstep(tbatch)
        np.testing.assert_allclose(tloss, float(jloss), rtol=1e-4)
        ref = dimpnet_from_flax({"params": as_np(params), "batch_stats": as_np(bs)}, tnet)
        n_all = n_off = 0
        for k, v in tnet.state_dict().items():
            if k.endswith(("_mean", "_var")):
                if not k.startswith("feature_extractor.layer4"):   # not run by the port
                    _close(_np(v), ref[k].numpy(), 1e-4)
                continue
            moved, ref_moved = _np(v) - start[k].numpy(), ref[k].numpy() - start[k].numpy()
            if zero_grad_bias(k):
                assert max(np.abs(moved).max(), np.abs(ref_moved).max()) <= 1.1e-4 * (i + 1), k
                continue
            err = np.abs(moved - ref_moved)
            if i == 0:
                g = np.abs(grads[k].numpy())
                assert err[g >= 0.01 * g.max()].max(initial=0) <= 1e-6, k
            n_all += err.size
            n_off += int((err > 2e-6).sum())
        if i == 1:
            assert n_off <= 0.01 * n_all, (n_off, n_all)


# ---------------------------------------------------------------- optimiser

class _Tree(torch.nn.Module):
    """Modules named as tests/test_optim.py's parameter tree."""

    def __init__(self, values):
        super().__init__()
        for path, v in values.items():
            mod = self
            *parents, leaf = path.split(".")
            for name in parents:
                if not hasattr(mod, name):
                    mod.add_module(name, torch.nn.Module())
                mod = getattr(mod, name)
            mod.register_parameter(leaf, torch.nn.Parameter(torch.from_numpy(v.copy())))


PATHS = ("classifier.filter_optimizer.w", "classifier.filter_initializer.w",
         "feature_extractor.layer3_0.w", "feature_extractor.layer4_0.w", "bb_regressor.w")
OPTIM_CASES = {
    "per_module_step_lr": dict(module_lrs={"classifier/filter_optimizer": 5e-4,
                                           "feature_extractor/layer3_": 2e-5},
                               step_size=2),
    "freeze_unlisted": dict(module_lrs={"classifier": 1e-4}, freeze_unlisted=True,
                            step_size=2),
    "milestones_adamw": dict(module_lrs={"bb_regressor": 3e-4}, milestones=(1, 3),
                             weight_decay=1e-2),
}


@pytest.mark.parametrize("case", sorted(OPTIM_CASES))
def test_adam_per_module_matches_optax(case):
    """adam_per_module against the JAX one (optax.multi_transform): 8 steps
    of 2 per epoch with the same random gradients, every parameter's
    trajectory within 1e-6 relative; the decay falls at step_size *
    steps_per_epoch optimiser steps (or the milestones' epochs), and an
    unlisted module under freeze_unlisted never moves."""
    from pytracking_tpu.training.optim import adam_per_module as j_adam_per_module

    kw = dict(OPTIM_CASES[case])
    module_lrs = kw.pop("module_lrs")
    rng = np.random.RandomState(0)
    values = {p: rng.randn(4).astype(np.float32) for p in PATHS}
    grads = [{p: rng.randn(4).astype(np.float32) for p in PATHS} for _ in range(8)]

    def nest(flat):
        out = {}
        for path, v in flat.items():
            d = out
            *parents, leaf = path.split(".")
            for name in parents:
                d = d.setdefault(name, {})
            d[leaf] = jnp.asarray(v)
        return out

    jopt = j_adam_per_module(2e-4, module_lrs, steps_per_epoch=2, gamma=0.2, **kw)
    jparams = nest(values)
    state = jopt.init(jparams)
    net = _Tree(values)
    topt, sched = t_optim.adam_per_module(net, 2e-4, {k.replace("/", "."): v for k, v in
                                                      module_lrs.items()},
                                          steps_per_epoch=2, gamma=0.2, **kw)
    tparams = dict(net.named_parameters())
    for g in grads:
        updates, state = jopt.update(nest(g), state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        for p, t in tparams.items():
            t.grad = torch.from_numpy(g[p].copy())
        topt.step()
        sched.step()
        flat = _flat(jax.tree_util.tree_map(np.asarray, jparams))
        for p, t in tparams.items():
            np.testing.assert_allclose(_np(t), flat[p], rtol=1e-6, atol=1e-9, err_msg=p)
    if kw.get("freeze_unlisted"):
        for p in PATHS:
            if not p.startswith("classifier"):
                assert np.array_equal(_np(tparams[p]), values[p]), p


def test_step_lr_schedule_matches_optax():
    """step_lr / multi_step_lr against the JAX package's schedules, step by step."""
    from pytracking_tpu.training import optim as j_optim

    pairs = ((t_optim.step_lr(1e-3, 10, 15, 0.2), j_optim.step_lr(1e-3, 10, 15, 0.2)),
             (t_optim.multi_step_lr(1e-3, 10, (5, 8), 0.2),
              j_optim.multi_step_lr(1e-3, 10, (5, 8), 0.2)))
    for t_sched, j_sched in pairs:
        for step in (0, 49, 50, 51, 79, 80, 149, 150, 299, 300, 301):
            np.testing.assert_allclose(t_sched(step), float(j_sched(step)), rtol=1e-6)
    assert t_optim.module_label("feature_extractor.layer3_0.conv1.weight",
                                ["feature_extractor", "feature_extractor.layer3_"]) \
        == "feature_extractor.layer3_"
    assert t_optim.module_label("classifier.feature_extractor.final_conv.weight",
                                ["feature_extractor", "classifier/feature_extractor"]) \
        == "classifier/feature_extractor"
    assert t_optim.module_label("bb_regressor.iou_predictor.weight", ["classifier"]) is None


# ---------------------------------------------------------------- the port alone

def _fixed_batches(n, sz=96, seed=0):
    """The convergence test's batches (tests/test_training_convergence.py):
    bright 24x24 squares on a dark texture, one train and one test frame
    of 2 sequences, the test box as the one proposal with IoU target 1."""
    rng = np.random.RandomState(seed)
    batches = []
    for _ in range(n):
        trains, tests, tr_bb, te_bb = [], [], [], []
        for _ in range(2):
            for dst, bbs in ((trains, tr_bb), (tests, te_bb)):
                im = rng.rand(sz, sz, 3).astype(np.float32) * 60
                x, y = rng.randint(20, sz - 40, 2)
                im[y:y + 24, x:x + 24] = 220.0
                dst.append(im)
                bbs.append([float(x), float(y), 24.0, 24.0])
        te = np.asarray(te_bb, np.float32)
        label = gaussian_label_function(te, 0.25 / 5, 4, sz // 16, sz)
        batches.append({"train_images": np.stack(trains)[None], "test_images": np.stack(tests)[None],
                        "train_anno": np.asarray(tr_bb, np.float32)[None],
                        "test_proposals": te[None, :, None], "proposal_iou": np.ones((1, 2, 1),
                                                                                     np.float32),
                        "test_label": label[None]})
    return batches


def _seeded_tiny_net():
    net = torch_tiny_dimpnet()
    return init_weights(net, torch.Generator().manual_seed(0))


def test_train_step_converges():
    """The twin of tests/test_training_convergence.py: 25 Adam(1e-3) steps
    of the train step on one fixed batch, the net in train mode: the loss
    halves."""
    net = _seeded_tiny_net().train()
    step = t_make_train_step(DiMPActor(net), torch.optim.Adam(net.parameters(), lr=1e-3))
    batch = to_torch(_fixed_batches(1)[0])
    losses = [step(batch)[0] for _ in range(25)]
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.5 * losses[0], f"no convergence: {losses[0]:.4f} -> {losses[-1]:.4f}"


class _FixedLoader:
    """The same batches every epoch (tests/test_resume_determinism.py);
    `fail_at` raises in that epoch's first batch, once."""

    def __init__(self, batches, fail_at=None):
        self.batches, self.fail_at = batches, fail_at
        self.name, self.training, self.epoch_interval = "train", True, 1
        self.epoch = 0

    def __iter__(self):
        self.epoch += 1
        if self.epoch == self.fail_at:
            self.fail_at = None
            raise RuntimeError("injected failure")
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def _trainer(ckpt_dir, loader):
    net = _seeded_tiny_net()
    optimizer, scheduler = t_optim.adam_per_module(net, 1e-3, {"classifier": 2e-3},
                                                   steps_per_epoch=len(loader), step_size=2)
    return LTRTrainer(DiMPActor(net), [loader], optimizer, Settings(), str(ckpt_dir),
                      scheduler=scheduler, device="cpu", print_interval=1000)


def test_trainer_checkpoints_restart_and_resume(tmp_path):
    """Atomic checkpoints that round-trip (weights_only) and `load_latest`;
    the fail-safe restart after a failure in epoch 2, counted; and a run
    stopped after epoch 1 and resumed by a new trainer ends with the
    parameters, optimiser and scheduler state of the run not stopped."""
    batches = _fixed_batches(2, sz=64, seed=1)
    full = _trainer(tmp_path / "full", _FixedLoader(batches))
    full.train(3, load_latest=True, fail_safe=False)
    assert sorted(os.listdir(tmp_path / "full")) == ["ep0001.ckpt", "ep0002.ckpt",
                                                     "ep0003.ckpt", "tensorboard"]
    state = torch.load(tmp_path / "full" / "ep0003.ckpt", weights_only=True)
    assert sorted(state) == ["epoch", "net", "optimizer", "scheduler"] and state["epoch"] == 3
    for k, v in full.net.state_dict().items():
        assert torch.equal(state["net"][k], v), k

    _trainer(tmp_path / "resume", _FixedLoader(batches)).train(1, load_latest=True,
                                                                fail_safe=False)
    resumed = _trainer(tmp_path / "resume", _FixedLoader(batches))
    resumed.train(3, load_latest=True, fail_safe=False)
    assert resumed.loaded_checkpoint.endswith("ep0001.ckpt") and resumed.restarts == 0
    assert sorted({r["epoch"] for r in resumed.step_log}) == [2, 3]
    for k, v in full.net.state_dict().items():
        torch.testing.assert_close(resumed.net.state_dict()[k], v, rtol=1e-6, atol=1e-7)
    assert resumed.scheduler.state_dict()["last_epoch"] == full.scheduler.state_dict()[
        "last_epoch"] == 6
    assert resumed.optimizer.param_groups[0]["lr"] == full.optimizer.param_groups[0]["lr"]

    failing = _trainer(tmp_path / "failsafe", _FixedLoader(batches, fail_at=2))
    failing.train(3, load_latest=False, fail_safe=True)
    assert failing.restarts == 1 and failing.loaded_checkpoint.endswith("ep0001.ckpt")
    assert [r["epoch"] for r in failing.step_log] == [1, 1, 2, 2, 3, 3]
    assert os.path.exists(tmp_path / "failsafe" / "ep0003.ckpt")
    assert not [f for f in os.listdir(tmp_path / "failsafe") if f.endswith(".tmp")]
    with pytest.raises(RuntimeError, match="injected"):
        _trainer(tmp_path / "strict", _FixedLoader(batches, fail_at=1)).train(
            2, fail_safe=False)


def test_run_training_entry_point(tmp_path, monkeypatch):
    """run_training('dimp', 'dimp50') on the tiny net and the CPU, at a
    64x64 crop, 8 samples of the synthetic dataset: writes ep0001.ckpt under
    PYTRACKING_TPU_TORCH_WORKSPACE, and a second call resumes from it and
    trains epoch 2 only."""
    from pytracking_tpu_torch.run_training import run_training

    monkeypatch.setenv("PYTRACKING_TPU_TORCH_WORKSPACE", str(tmp_path))

    def settings():
        return Settings(output_sz=64, feature_sz=4, batch_size=2, num_workers=2,
                        print_interval=1000)

    trainer = run_training("dimp", "dimp50", settings=settings(), max_epochs=1,
                           samples_per_epoch=8, net=_seeded_tiny_net(), device="cpu")
    ckpt = tmp_path / "checkpoints" / "dimp" / "dimp50" / "ep0001.ckpt"
    assert ckpt.exists() and trainer.restarts == 0
    assert len(trainer.step_log) == 4 and np.isfinite([r["loss"] for r in trainer.step_log]).all()
    again = run_training("dimp", "dimp50", settings=settings(), max_epochs=2,
                         samples_per_epoch=8, net=_seeded_tiny_net(), device="cpu")
    assert again.loaded_checkpoint == str(ckpt)
    assert [r["epoch"] for r in again.step_log] == [2] * 4
    assert (tmp_path / "checkpoints" / "dimp" / "dimp50" / "ep0002.ckpt").exists()
