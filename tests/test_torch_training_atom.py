"""Parity of the port's ATOM training with the JAX package, on the CPU: the
tiny ATOM of tests/test_torch_atom.py (its JAX `net.init` with random
BatchNorm statistics, converted by `atomnet_from_flax`) in train mode, its
training forward, both ATOM actors (the IoU predictions' squared error, and
the prob-ML recipe's KL regression) with every parameter's gradient, and
two Adam steps of the recipe's optimiser (only the IoU-Net trains) against
the JAX train step; then the port alone: `run_training` on each ATOM
recipe for one step with a tiny net.

Float32. Tolerances: the IoU predictions and the running statistics 1e-4 of
the larger of 1 and the reference's largest magnitude, the loss 1e-5 of
that scale, each gradient leaf 1e-3 of its own largest magnitude after
checking that the port's own gradient moves by less than 1e-4 of a leaf's
scale when the images change by 3e-7 relative; the Adam steps as in their
test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytracking_tpu_torch.models.backbones import resnet as t_resnet
from pytracking_tpu_torch.models.bbreg.iou_net import AtomIoUNet as TAtomIoUNet
from pytracking_tpu_torch.models.tracking import atomnet as t_atomnet
from pytracking_tpu_torch.models.tracking.dimpnet import init_weights
from pytracking_tpu_torch.parallel.mesh import make_train_step as t_make_train_step
from pytracking_tpu_torch.training import optim as t_optim
from pytracking_tpu_torch.training.actors.tracking import ATOMActor
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.training.train_settings.bbreg.atom_prob_ml import ATOMBBKLActor
from pytracking_tpu_torch.utils.convert_weights import atomnet_from_flax

from test_torch_dimp import _perturb_batch_stats
from test_torch_lwl_ops import one_thread  # noqa: F401 (autouse: one CPU thread)
from test_torch_training import GRAD_TOL, _close, _np, to_torch

SZ = 64
# The batch: 8 sequences, one whose gradient is continuous at rounding
# scale (the gradient test checks that first). The tiny net's gradient
# jumps where float32 rounding moves a ReLU input across 0, on both sides
# (tests/test_torch_training.py): with 4 sequences the IoU-Net's
# train-mode BatchNorm over the sequences' modulation vectors puts such a
# jump of 1e-3 to 1e-1 of a leaf's scale on every seed tried (0-29), with 8
# on 17 of 30. Which kink a compile lands on depends on XLA's fusion, so
# the JAX gradients come from one jit of each actor's value_and_grad.
BATCH_SEED = 0
ACTORS = ("iou", "bbkl")


def make_atom_batch(seed, sz=SZ, S=8, P=16):
    """One train and one test frame of S sequences, images NHWC in 0-255:
    bright textured 24x24 squares on a dark texture; proposal 0 the test
    box and the others around it, with random IoU targets in [-1, 1] (ATOM)
    and random densities (prob-ML: gt_density 1 for proposal 0)."""
    rng = np.random.RandomState(seed)

    def frames():
        ims, boxes = [], []
        for _ in range(S):
            im = rng.rand(sz, sz, 3).astype(np.float32) * 60
            x, y = rng.randint(8, sz - 32, 2)
            im[y:y + 24, x:x + 24] = 190.0 + rng.rand(24, 24, 3) * 60
            ims.append(im)
            boxes.append([float(x), float(y), 24.0, 24.0])
        return np.stack(ims)[None], np.asarray(boxes, np.float32)[None]

    train_images, train_anno = frames()
    test_images, test_anno = frames()
    proposals = test_anno[:, :, None] + rng.randn(1, S, P, 4).astype(np.float32) \
        * np.array([3, 3, 2, 2], np.float32)
    proposals[:, :, 0] = test_anno
    gt = np.zeros((1, S, P), np.float32)
    gt[..., 0] = 1.0
    return {"train_images": train_images, "test_images": test_images,
            "train_anno": train_anno, "test_proposals": proposals.astype(np.float32),
            "proposal_iou": (rng.rand(1, S, P) * 2 - 1).astype(np.float32),
            "proposal_density": (rng.rand(1, S, P) * 4 + 0.05).astype(np.float32),
            "gt_density": gt}


def torch_tiny_atomnet():
    return t_atomnet.ATOMnet(
        t_resnet.ResNet(layers=(1, 1, 1, 1), output_layers=("layer2", "layer3"),
                        base_width=16, block="basic"),
        TAtomIoUNet(input_dim=(32, 64), pred_input_dim=(32, 32), pred_inter_dim=(32, 32)))


@pytest.fixture(scope="module")
def pair():
    """(jax net, flax variables as numpy, a function making the torch net
    with the same weights, in train mode)."""
    from tests.test_atom_tracker import tiny_atomnet

    jnet = tiny_atomnet()
    im = jnp.zeros((1, 1, SZ, SZ, 3))
    bb = jnp.array([[[20.0, 20.0, 24.0, 24.0]]])
    variables = jax.jit(lambda k: jnet.init(k, im, im, bb, bb[:, :, None], train=False))(
        jax.random.PRNGKey(2))
    variables = _perturb_batch_stats(jax.tree_util.tree_map(np.asarray, dict(variables)), 6)

    def make_tnet():
        tnet = torch_tiny_atomnet()
        tnet.load_state_dict(atomnet_from_flax(variables, tnet))
        return tnet.train()

    return jnet, variables, make_tnet


def jax_actor(jnet, kind):
    from pytracking_tpu.training.actors.tracking import make_atom_actor
    from pytracking_tpu.training.train_settings.bbreg.atom_prob_ml import make_atom_bbkl_actor

    return make_atom_actor(jnet) if kind == "iou" else make_atom_bbkl_actor(jnet)


def port_actor(net, kind):
    return ATOMActor(net) if kind == "iou" else ATOMBBKLActor(net)


@pytest.fixture(scope="module")
def jax_run(pair):
    """The JAX side on make_atom_batch(BATCH_SEED): the train-mode forward
    with its new batch stats (one jit), and each actor's loss, stats and
    gradients (one jit of value_and_grad each)."""
    jnet, variables, _ = pair
    batch = {k: jnp.asarray(v) for k, v in make_atom_batch(BATCH_SEED).items()}
    bs = variables["batch_stats"]
    iou, mutated = jax.jit(lambda p: jnet.apply(
        {"params": p, "batch_stats": bs}, batch["train_images"], batch["test_images"],
        batch["train_anno"], batch["test_proposals"], train=True,
        mutable=["batch_stats"]))(variables["params"])
    out = {}
    for kind in ACTORS:
        (loss, (stats, _)), grads = jax.jit(jax.value_and_grad(jax_actor(jnet, kind),
                                                               has_aux=True))(
            variables["params"], bs, batch)
        out[kind] = (loss, stats, grads)
    return jax.tree_util.tree_map(np.asarray, (iou, mutated["batch_stats"], out))


def test_train_forward_and_actors_match_jax(pair, jax_run):
    """ATOMnet.forward in train mode against net.apply(train=True,
    mutable=['batch_stats']): the IoU predictions (Ntest, S, P) and the
    running statistics after it (the backbone's moved by the train image,
    then the test image; layer4's left out: the port's ResNet does not run
    it); then both actors' losses and stats."""
    _, variables, make_tnet = pair
    iou_ref, bs_ref, actors = jax_run
    batch = to_torch(make_atom_batch(BATCH_SEED))
    tnet = make_tnet()
    before = {k: v.clone() for k, v in tnet.state_dict().items() if k.endswith(("_mean", "_var"))}
    iou = tnet(*(batch[k] for k in ("train_images", "test_images", "train_anno",
                                    "test_proposals")))
    assert iou.shape == (1, 8, 16)
    _close(_np(iou), iou_ref, 1e-4)
    moved = atomnet_from_flax({"params": variables["params"], "batch_stats": bs_ref}, tnet)
    n = 0
    for k, v in tnet.state_dict().items():
        if k.endswith(("_mean", "_var")) and not k.startswith("feature_extractor.layer4"):
            _close(_np(v), moved[k].numpy(), 1e-4)
            n += not torch.equal(v, before[k])
    assert n == len([k for k in before if not k.startswith("feature_extractor.layer4")])

    for kind in ACTORS:
        loss, stats = port_actor(make_tnet(), kind)(batch)
        ref_loss, ref_stats, _ = actors[kind]
        assert sorted(stats) == sorted(ref_stats)
        _close(loss.item(), ref_loss, 1e-5)
        for k, v in stats.items():
            _close(v.item(), ref_stats[k], 1e-5)


def _grads(make_tnet, batch, kind):
    tnet = make_tnet()
    port_actor(tnet, kind)(batch)[0].backward()
    return {n: p.grad for n, p in tnet.named_parameters()
            if p.grad is not None and not n.endswith(("Conv_0.bias", "Dense_0.bias"))}


@pytest.mark.parametrize("kind", ACTORS)
def test_gradients_match_jax(pair, jax_run, kind):
    """Every parameter's .grad (the backbone's too: the net is not frozen
    here) against jax.value_and_grad of the JAX actor, through
    atomnet_from_flax, within GRAD_TOL of the leaf's scale; a bias that a
    train-mode BatchNorm follows has an exact gradient of 0, both sides
    within GRAD_TOL of the layer's weight gradient."""
    _, variables, make_tnet = pair
    ref = atomnet_from_flax({"params": jax_run[2][kind][2],
                             "batch_stats": variables["batch_stats"]})
    batch = to_torch(make_atom_batch(BATCH_SEED))
    g0 = _grads(make_tnet, batch, kind)
    gen = torch.Generator().manual_seed(0)
    moved = dict(batch)
    for k in ("train_images", "test_images"):
        moved[k] = batch[k] * (1 + 3e-7 * torch.randn(batch[k].shape, generator=gen))
    g1 = _grads(make_tnet, moved, kind)
    assert max(float((g1[n] - g0[n]).abs().max() / g0[n].abs().max()) for n in g0) < 1e-4

    tnet = make_tnet()
    port_actor(tnet, kind)(batch)[0].backward()
    modules = dict(tnet.named_modules())
    worst = {}
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
    bad = {k: v for k, v in worst.items() if v > GRAD_TOL}
    assert not bad, bad
    assert len([n for n in worst if n.startswith("bb_regressor.")]) > 20
    assert len([n for n in worst if n.startswith("feature_extractor.")]) > 20


def test_two_adam_steps_match_jax_train_step(pair, jax_run):
    """Two steps of the port's make_train_step with the recipe's optimiser
    (Adam 1e-3 on bb_regressor, the rest frozen) against the JAX
    make_train_step with the JAX recipe's adam_per_module(freeze_unlisted),
    on one batch: each step's loss (1e-4 relative), the running statistics
    after it (1e-4, the frozen backbone's BatchNorm moving as in the JAX
    actor's train mode), the frozen leaves bit for bit unchanged on both
    sides (and out of autograd on the port's), and each IoU-Net parameter's
    movement after step 1 within 1e-5 (1% of the step) where the gradient
    is at least 1% of its leaf's scale, after step 2 within 2e-5 for 99% of
    the elements. Adam moves an element by about lr * sign(g), so where g
    is within rounding of 0 (the biases a train-mode BatchNorm follows:
    exactly 0) rounding picks the direction; those are held to Adam's
    reach."""
    from pytracking_tpu.parallel.mesh import make_train_step
    from pytracking_tpu.training.optim import adam_per_module

    jnet, variables, make_tnet = pair
    batch = make_atom_batch(BATCH_SEED)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jopt = adam_per_module(1e-3, {"bb_regressor": 1e-3}, steps_per_epoch=1, step_size=15,
                           gamma=0.2, freeze_unlisted=True)
    step = make_train_step(jax_actor(jnet, "iou"), jopt)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    bs = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    opt_state = jopt.init(params)

    tnet = make_tnet()
    optimizer, scheduler = t_optim.adam_per_module(tnet, 1e-3, {"bb_regressor": 1e-3},
                                                   steps_per_epoch=1, step_size=15, gamma=0.2,
                                                   freeze_unlisted=True)
    assert all(p.requires_grad == n.startswith("bb_regressor.")
               for n, p in tnet.named_parameters())
    tstep = t_make_train_step(ATOMActor(tnet), optimizer, scheduler)
    tbatch = to_torch(batch)
    start = atomnet_from_flax(variables, tnet)
    grads = atomnet_from_flax({"params": jax_run[2]["iou"][2],
                               "batch_stats": variables["batch_stats"]})
    modules = dict(tnet.named_modules())
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)

    def zero_grad_bias(k):
        block, layer, leaf = k.rsplit(".", 2)
        return leaf == "bias" and layer in ("Conv_0", "Dense_0") \
            and getattr(modules[block], "BatchNorm_0", None) is not None

    biases = {}                     # the zero-gradient biases each side ran step 2 with
    for i in range(2):
        params, bs, opt_state, jloss, _ = step(params, bs, opt_state, jbatch)
        tloss, _ = tstep(tbatch)
        np.testing.assert_allclose(tloss, float(jloss), rtol=1e-4)
        ref = atomnet_from_flax({"params": as_np(params), "batch_stats": as_np(bs)}, tnet)
        n_all = n_off = 0
        for k, v in tnet.state_dict().items():
            if k.endswith(("_mean", "_var")):
                if k.startswith("feature_extractor.layer4"):
                    continue
                got, want = _np(v), ref[k].numpy()
                bias = k.replace("BatchNorm_0.running_mean", "Conv_0.bias")
                bias = bias if bias in biases else k.replace("BatchNorm_0.running_mean",
                                                             "Dense_0.bias")
                if i == 1 and bias in biases:
                    # the batch mean holds the preceding bias, which rounding
                    # moved by up to 2 lr apart on the two sides in step 1
                    got, want = got - 0.1 * biases[bias][0], want - 0.1 * biases[bias][1]
                _close(got, want, 1e-4)
                continue
            if i == 0 and zero_grad_bias(k):
                biases[k] = (_np(v).copy(), ref[k].numpy())
            moved, ref_moved = _np(v) - start[k].numpy(), ref[k].numpy() - start[k].numpy()
            if not k.startswith("bb_regressor."):
                assert not moved.any() and not ref_moved.any(), k
                continue
            if zero_grad_bias(k):
                assert max(np.abs(moved).max(), np.abs(ref_moved).max()) <= 1.1e-3 * (i + 1), k
                continue
            err = np.abs(moved - ref_moved)
            if i == 0:
                g = np.abs(grads[k].numpy())
                assert err[g >= 0.01 * g.max()].max(initial=0) <= 1e-5, k
            n_all += err.size
            n_off += int((err > 2e-5).sum())
        if i == 1:
            assert n_off <= 0.01 * n_all, (n_off, n_all)


# ---------------------------------------------------------------- the recipes

def _seeded_tiny_atomnet():
    return init_weights(torch_tiny_atomnet(), torch.Generator().manual_seed(0)).eval()


@pytest.mark.parametrize("name", ["atom", "atom_paper", "atom_prob_ml", "atom_gmm_sampl"])
def test_run_training_atom_recipes(name, tmp_path, monkeypatch):
    """run_training('bbreg', name) on the tiny net and the CPU, 64x64 crops,
    one step of 2 sequences: a checkpoint, a finite loss of the recipe's
    objective, every IoU-Net parameter moved, the backbone's weights bit
    for bit unchanged (and out of autograd), its BatchNorm running
    statistics moved."""
    from pytracking_tpu_torch.run_training import run_training

    monkeypatch.setenv("PYTRACKING_TPU_TORCH_WORKSPACE", str(tmp_path))
    net = _seeded_tiny_atomnet()
    start = {k: v.clone() for k, v in net.state_dict().items()}
    trainer = run_training("bbreg", name, settings=Settings(output_sz=64, feature_sz=4,
                                                            batch_size=2, num_workers=1,
                                                            print_interval=1000),
                           max_epochs=1, samples_per_epoch=2, net=net, device="cpu")
    assert (tmp_path / "checkpoints" / "bbreg" / name / "ep0001.ckpt").exists()
    assert len(trainer.step_log) == 1 and trainer.restarts == 0
    assert np.isfinite(trainer.step_log[0]["loss"])
    stats = trainer.stats["train"]
    assert ("Loss/bb_ce" in stats) == (name in ("atom_prob_ml", "atom_gmm_sampl"))
    for k, v in trainer.net.state_dict().items():
        if k.startswith("bb_regressor.") and not k.endswith(("_mean", "_var", "tracked")):
            assert not torch.equal(v, start[k]), k
        elif k.startswith("feature_extractor.layer4"):
            assert torch.equal(v, start[k]), k
        elif k.endswith(("_mean", "_var")):
            assert not torch.equal(v, start[k]), k
        else:
            assert torch.equal(v, start[k]), k
    assert not any(p.requires_grad for n, p in trainer.net.named_parameters()
                   if not n.startswith("bb_regressor."))
