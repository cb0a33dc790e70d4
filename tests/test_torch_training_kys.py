"""Parity of the port's KYS training with the JAX package, on the CPU: the
score jitter on the cases of tests/test_round3_fidelity.py plus a map
without a target; the KYS actor in train mode and in eval mode (jitter
off) against `make_kys_actor`: the loss terms, the accuracy and every
predictor gradient, and in train mode no running statistic moved; the JAX
recipe's wiring (19x19 labels on an 18x18 motion grid) raising where the
port's recipe makes labels of the feature grid; and `run_training kys kys`
on a tiny net.

Net: the tiny KYS of tests/test_training_actors_extra.py:18 (bottleneck
ResNet of one block per stage at base width 8, 32-channel classification
features, a 4x4 filter with 2 steepest-descent steps over 10 distance bins,
a 4-channel-state predictor with one 8-channel representation conv,
displacements up to 2 cells), with the filter initialiser unnormalised as
in `kysnet_res50` (the port implements that one); weights from the JAX
`init` (the DiMP forward's merged with the predictor's, as the JAX recipe
merges them), random BatchNorm statistics and every bias moved off 0,
converted with `kysnet_from_flax`. Batches: 2 sequences of 1 train and 5
test textured 64x64 frames (4x4 features), a bright square in each, its
Gaussian label on the 4x4 grid; sequence 1's frame 3 absent (label 0,
test_valid_image 0).

Float32. Tolerances, relative to the larger of 1 and the reference's
largest magnitude: the loss terms and the accuracy 1e-5; each predictor
gradient leaf within GRAD_TOL (tests/test_torch_training.py) of its own
largest magnitude, after checking that the port's own gradient moves by
less than STEADY_TOL of a leaf's scale when the images change by 3e-7
relative; the biases whose gradient is exactly 0 (a constant added under a
softmax) within GRAD_TOL of their block's gradient scale.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytracking_tpu_torch.models.backbones import resnet as t_resnet
from pytracking_tpu_torch.models.bbreg.iou_net import AtomIoUNet as TAtomIoUNet
from pytracking_tpu_torch.models.classifier import features as t_features
from pytracking_tpu_torch.models.classifier.initializer import \
    FilterInitializerLinear as TFilterInitializerLinear
from pytracking_tpu_torch.models.classifier.linear_filter import LinearFilter as TLinearFilter
from pytracking_tpu_torch.models.classifier.optimizer import \
    DiMPSteepestDescentGN as TDiMPSteepestDescentGN
from pytracking_tpu_torch.models.kys import response_predictor as t_rp
from pytracking_tpu_torch.models.kys.score_jitter import DiMPScoreJittering as TJitter
from pytracking_tpu_torch.models.tracking import kysnet as t_kysnet
from pytracking_tpu_torch.models.tracking.dimpnet import init_weights
from pytracking_tpu_torch.training.actors.tracking import KYSActor
from pytracking_tpu_torch.training.processing_utils import gaussian_label_function
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.utils.convert_weights import kysnet_from_flax

from test_torch_lwl_ops import one_thread  # noqa: F401
from test_torch_training import GRAD_TOL, _close, _np, to_torch

SZ = 64                    # crops: a 4x4 grid at stride 16
D = 32                     # classification feature channels
OPT_KW = dict(num_iter=2, feat_stride=16, num_dist_bins=10, bin_displacement=0.5)
PRED_KW = dict(state_dim=4, representation_predictor_dims=(8,), conf_measure="entropy",
               dimp_thresh=0.05)
MAX_DISP = 2
LABEL_SIGMA = 0.05         # Settings: output_sigma_factor / search_area_factor
# The tiny predictor's gradient jumps where rounding moves a ReLU input or a
# score across the 0.05 threshold: under a 3e-7 relative change of the
# images it moves by 2e-4 to 2.4e-3 of a leaf's scale on make_batch seeds 0,
# 1, 3 and 5 (train mode), by 1.8e-5 at most on seed 11 (both modes).
BATCH_SEED = 11
STEADY_EPS = 3e-7
STEADY_TOL = 1e-4


def jax_tiny_kys():
    from pytracking_tpu.models.backbones.resnet import ResNet
    from pytracking_tpu.models.bbreg.iou_net import AtomIoUNet
    from pytracking_tpu.models.classifier.features import ResidualBottleneck
    from pytracking_tpu.models.classifier.initializer import FilterInitializerLinear
    from pytracking_tpu.models.classifier.linear_filter import LinearFilter
    from pytracking_tpu.models.classifier.optimizer import DiMPSteepestDescentGN
    from pytracking_tpu.models.kys.response_predictor import ResponsePredictor
    from pytracking_tpu.models.tracking.kysnet import KYSNet

    classifier = LinearFilter(
        filter_size=4,
        filter_initializer=FilterInitializerLinear(filter_size=4, feature_dim=D,
                                                   filter_norm=False),
        filter_optimizer=DiMPSteepestDescentGN(**OPT_KW),
        feature_extractor=ResidualBottleneck(feature_dim=16, num_blocks=0, l2norm=True,
                                             final_conv=True,
                                             norm_scale=math.sqrt(1 / (D * 16)), out_dim=D))
    return KYSNet(feature_extractor=ResNet(block="bottleneck", layers=(1, 1, 1, 1),
                                           output_layers=("layer2", "layer3"), base_width=8),
                  classifier=classifier,
                  bb_regressor=AtomIoUNet(input_dim=(64, 128), pred_input_dim=(16, 16),
                                          pred_inter_dim=(16, 16)),
                  classification_layer="layer3", bb_regressor_layer=("layer2", "layer3"),
                  predictor=ResponsePredictor(**PRED_KW), max_displacement=MAX_DISP)


def torch_tiny_kys():
    classifier = TLinearFilter(
        TFilterInitializerLinear(filter_size=4, feature_dim=D),
        TDiMPSteepestDescentGN(**OPT_KW),
        t_features.ResidualBottleneck(in_dim=128, out_dim=D, norm_scale=math.sqrt(1 / (D * 16)),
                                      feature_dim=16, num_blocks=0, final_conv=True))
    return t_kysnet.KYSNet(t_resnet.ResNet(layers=(1, 1, 1, 1), base_width=8), classifier,
                           TAtomIoUNet(input_dim=(64, 128), pred_input_dim=(16, 16),
                                       pred_inter_dim=(16, 16)),
                           t_rp.ResponsePredictor(**PRED_KW), max_displacement=MAX_DISP)


@functools.lru_cache(maxsize=None)
def pair():
    """(JAX net, its variables as numpy): the DiMP forward's init merged
    with the predictor's, random BatchNorm statistics, every bias moved by
    0.1 x a normal draw (a ReLU whose input vector is 0 at bias 0 sits on
    its kink)."""
    jnet = jax_tiny_kys()
    im = jnp.zeros((1, 2, SZ, SZ, 3))
    bb = jnp.tile(jnp.array([[[20.0, 20.0, 24.0, 24.0]]]), (1, 2, 1))
    h = SZ // 16
    mf, ds = jnp.zeros((2, h, h, D)), jnp.zeros((2, h, h, 1))

    @jax.jit
    def init(k0, k1):
        return (jnet.init(k0, im, im, bb, bb[:, :, None], train=False),
                jnet.init(k1, mf, mf, None, ds, ds,
                          method=lambda m, a, b, c, e, f: m.predict_response(a, b, c, e,
                                                                             init_label=f)))

    v_main, v_pred = init(jax.random.PRNGKey(0), jax.random.PRNGKey(1))
    variables = jax.tree_util.tree_map(np.asarray, {
        "params": {**v_main["params"], **v_pred["params"]},
        "batch_stats": {**v_main["batch_stats"], **v_pred["batch_stats"]}})
    rng = np.random.RandomState(3)

    def walk(tree, stats=False):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, stats)
            elif stats:
                out[k] = (np.abs(rng.randn(*v.shape)) + 0.5 if k == "var"
                          else 0.1 * rng.randn(*v.shape)).astype(np.float32)
            else:
                out[k] = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32) \
                    if k == "bias" else v
        return out

    return jnet, {"params": walk(variables["params"]),
                  "batch_stats": walk(variables["batch_stats"], stats=True)}


def make_tnet(train=True):
    """The port's net with the pair's weights, the predictor alone
    trainable (the recipe's freezing)."""
    _, variables = pair()
    tnet = torch_tiny_kys()
    tnet.load_state_dict(kysnet_from_flax(variables, tnet))
    for n, p in tnet.named_parameters():
        p.requires_grad_(n.startswith("predictor."))
    return tnet.train(train)


def make_batch(seed, n_train=1, n_test=5, S=2, label_sz=SZ // 16, end_pad=False):
    """A frame-major numpy batch: textured frames with a bright 18-28 px
    square, its box, Gaussian labels on a label_sz grid (one cell more with
    end_pad), sequence 1's test frame 3 absent."""
    rng = np.random.RandomState(seed)
    n = n_train + n_test
    ims = rng.rand(n, S, SZ, SZ, 3).astype(np.float32) * 60
    boxes = np.zeros((n, S, 4), np.float32)
    for i in range(n):
        for s in range(S):
            w, h = rng.randint(18, 29, 2)
            x, y = rng.randint(4, SZ - 4 - w), rng.randint(4, SZ - 4 - h)
            ims[i, s, y:y + h, x:x + w] = 190.0 + rng.rand(h, w, 3) * 60
            boxes[i, s] = [x, y, w, h]
    labels = np.stack([gaussian_label_function(b[None], LABEL_SIGMA, 4, label_sz, SZ,
                                               end_pad_if_even=end_pad)[0]
                       for b in boxes[n_train:].reshape(-1, 4)])
    labels = labels.reshape((n_test, S) + labels.shape[-2:]).astype(np.float32)
    valid = np.ones((n_test, S), np.int8)
    valid[3, 1] = 0
    labels[3, 1] = 0.0
    return {"train_images": ims[:n_train], "train_anno": boxes[:n_train],
            "test_images": ims[n_train:], "test_label": labels, "test_valid_image": valid,
            "jitter_seed": np.arange(S, dtype=np.int32)}


def exact_zero(name):
    """Whether a predictor leaf's gradient is exactly 0 by construction,
    rounding alone making it otherwise (on both sides, with either sign):
    the biases of the last conv block of each cost-volume stage, which add
    a constant to every entry of a softmax."""
    return name.startswith(("predictor.cvproc1_1.", "predictor.cvproc2_1.")) \
        and name.endswith(".bias")


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items() if k != "jitter_seed"}


@pytest.fixture(scope="module", params=[True, False], ids=["train", "eval"])
def run(request):
    """The JAX actor (jitter off) in train or eval mode on make_batch(BATCH_SEED):
    loss, stats and gradients (one jit of value_and_grad)."""
    from pytracking_tpu.training.actors.tracking import make_kys_actor

    jnet, variables = pair()
    actor = make_kys_actor(jnet, train=request.param)
    (loss, (stats, bs)), grads = jax.jit(jax.value_and_grad(actor, has_aux=True))(
        variables["params"], variables["batch_stats"], _jax_batch(make_batch(BATCH_SEED)))
    return {"train": request.param, "loss": float(loss),
            "stats": {k: float(v) for k, v in stats.items()},
            "grads": jax.tree_util.tree_map(np.asarray, grads)}


def _predictor_grads(train, batch):
    tnet = make_tnet(train)
    loss, stats = KYSActor(tnet)(batch)
    loss.backward()
    return tnet, loss, stats, {n: p.grad for n, p in tnet.named_parameters()
                               if p.grad is not None}


# ---------------------------------------------------------------- the actor

def test_actor_matches_jax(run):
    """The port's actor against the JAX actor: the loss and each stat under
    the JAX names; in train mode (batch statistics in the backbone) every
    running statistic of the net and every parameter bit for bit as
    before."""
    tnet = make_tnet(run["train"])
    start = {k: v.clone() for k, v in tnet.state_dict().items()}
    loss, stats = KYSActor(tnet)(to_torch(make_batch(BATCH_SEED)))
    assert sorted(stats) == sorted(run["stats"])
    _close(loss.item(), run["loss"], 1e-5)
    for k, v in stats.items():
        _close(v.item(), run["stats"][k], 1e-5)
    for k, v in tnet.state_dict().items():
        assert torch.equal(v, start[k]), k


def test_predictor_gradients_match_jax(run):
    """Every predictor parameter's .grad against jax.value_and_grad of the
    JAX actor, through the converter, within GRAD_TOL of the leaf's scale,
    after checking that the port's own gradient is steady under a 3e-7
    relative change of the images; no parameter outside the predictor gets
    a gradient."""
    batch = to_torch(make_batch(BATCH_SEED))
    tnet, _, _, g0 = _predictor_grads(run["train"], batch)
    gen = torch.Generator().manual_seed(0)
    moved = dict(batch)
    for k in ("train_images", "test_images"):
        moved[k] = batch[k] * (1 + STEADY_EPS * torch.randn(batch[k].shape, generator=gen))
    _, _, _, g1 = _predictor_grads(run["train"], moved)
    steady = {n: float((g1[n] - g0[n]).abs().max() / g0[n].abs().max()) for n in g0
              if not exact_zero(n)}
    assert max(steady.values()) < STEADY_TOL, max(steady.items(), key=lambda kv: kv[1])

    _, variables = pair()
    ref = kysnet_from_flax({"params": run["grads"], "batch_stats": variables["batch_stats"]})
    predictor = [n for n, _ in tnet.named_parameters() if n.startswith("predictor.")]
    assert set(g0) <= set(predictor)
    worst = {}
    for name in predictor:
        r = ref[name].numpy()
        if name not in g0:
            assert not r.any(), name
            continue
        if exact_zero(name):
            block = name.rsplit(".", 2)[0]
            scale = max(np.abs(ref[k].numpy()).max() for k in ref if k.startswith(block + "."))
            worst[name] = max(np.abs(_np(g0[name])).max(), np.abs(r).max()) / scale
            continue
        worst[name] = np.abs(_np(g0[name]) - r).max() / np.abs(r).max()
    bad = {k: v for k, v in worst.items() if v > GRAD_TOL}
    assert not bad, bad
    assert len(worst) >= 14


def test_actor_refuses_a_trainable_appearance_model():
    """The actor runs the appearance model without autograd, so a trainable
    parameter outside the predictor would get no gradient: it raises."""
    tnet = make_tnet()
    tnet.classifier.filter_optimizer.log_step_length.requires_grad_(True)
    with pytest.raises(ValueError, match="predictor alone"):
        KYSActor(tnet)(to_torch(make_batch(BATCH_SEED)))


def test_actor_takes_the_loaders_layout_of_valid_frames():
    """The loader collates each sample's test_valid_image vector (T,) to (1,
    S, T): the actor reads it as the frame-major (T, S), with the same
    loss."""
    batch = to_torch(make_batch(BATCH_SEED))
    tnet = make_tnet()
    ref = KYSActor(tnet)(batch)[0]
    collated = dict(batch, test_valid_image=batch["test_valid_image"].t()[None])
    assert torch.equal(KYSActor(tnet)(collated)[0], ref)
    no_valid = {k: v for k, v in batch.items() if k != "test_valid_image"}
    assert not torch.equal(KYSActor(tnet)(no_valid)[0], ref)


def test_jax_recipe_labels_break_the_jax_actor():
    """The JAX recipe's label parameters leave end_pad_if_even at True: with
    a 4x4 filter the labels are one cell larger than the motion grid (19x19
    on 18x18 at full size; 5x5 on 4x4 here), and the JAX actor, which cuts
    the scores to the labels, cannot carry such a label's state (it
    raises). The port's recipe makes labels of the feature grid, on which
    the port's actor runs."""
    from pytracking_tpu.training.actors.tracking import make_kys_actor
    from pytracking_tpu.training.processing_utils import \
        gaussian_label_function as j_gaussian_label_function
    from pytracking_tpu_torch.training.train_settings.kys import kys

    h = SZ // 16
    j_params = {"feature_sz": h, "sigma_factor": LABEL_SIGMA, "kernel_sz": 4}
    j_label = j_gaussian_label_function(np.array([[20.0, 20.0, 24.0, 24.0]], np.float32),
                                        j_params["sigma_factor"], j_params["kernel_sz"],
                                        j_params["feature_sz"], SZ)
    assert j_label.shape == (1, h + 1, h + 1)
    jnet, variables = pair()
    actor = make_kys_actor(jnet, train=True)
    with pytest.raises((TypeError, ValueError), match="reshape"):
        jax.jit(actor)(variables["params"], variables["batch_stats"],
                       _jax_batch(make_batch(BATCH_SEED, label_sz=h, end_pad=True)))

    settings = Settings(output_sz=SZ, feature_sz=h)
    p = kys.make_sampler(settings, samples_per_epoch=1, seed=0).processing.label_function_params
    label = gaussian_label_function(np.array([[20.0, 20.0, 24.0, 24.0]], np.float32),
                                    p["sigma_factor"], p["kernel_sz"], p["feature_sz"], SZ,
                                    end_pad_if_even=p["end_pad_if_even"])
    assert label.shape == (1, h, h)
    loss, _ = KYSActor(make_tnet())(to_torch(make_batch(BATCH_SEED)))
    assert np.isfinite(loss.item())


# ---------------------------------------------------------------- the jitter

def _score_label(seed, n=3, h=8, w=8):
    rng = np.random.RandomState(seed)
    score = rng.rand(n, 1, h, w).astype(np.float32)
    label = np.zeros((n, 1, h, w), np.float32)
    label[:, 0, 2, 2] = 1.0
    return score, label


def test_score_jittering_identity_when_disabled():
    score, label = _score_label(0)
    out = TJitter()(torch.from_numpy(score), torch.from_numpy(label),
                    torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(out.numpy(), score)


def test_score_jittering_enhances_the_distractor_peak():
    """Exactly the background's peak cell is rewritten, into [0.8, 1.3]
    times the target's peak; the same generator seed draws the same map."""
    score, label = _score_label(1)
    fn = TJitter(p_distractor=1.0, distractor_ratio=0.01, max_distractor_enhance_factor=1.3,
                 min_distractor_enhance_factor=0.8)
    out = fn(torch.from_numpy(score), torch.from_numpy(label),
             torch.Generator().manual_seed(3)).numpy()
    again = fn(torch.from_numpy(score), torch.from_numpy(label),
               torch.Generator().manual_seed(3)).numpy()
    np.testing.assert_array_equal(out, again)
    for i in range(score.shape[0]):
        neg = score[i] * (label[i] < 1e-4)
        tmax = (score[i] * (label[i] > 0.2)).max()
        flat_id = int(neg.reshape(-1).argmax())
        changed = (out[i] != score[i]).reshape(-1)
        assert changed.sum() == 1 and changed[flat_id]
        v = out[i].reshape(-1)[flat_id]
        assert 0.8 * tmax - 1e-6 <= v <= 1.3 * tmax + 1e-6


def test_score_jittering_zeroes_the_map():
    score, label = _score_label(2)
    out = TJitter(p_zero=1.0)(torch.from_numpy(score), torch.from_numpy(label),
                              torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(out.numpy(), 0.0)


def test_score_jittering_of_a_map_without_target_matches_jax():
    """Maps whose labels are all 0 (an absent target) have a target peak of
    0. With positive scores the background's peak over 0 is inf, so the
    distractor branch takes it and writes 0 (0 to 0 times the peak); an
    all-zero map gives 0 / 0, NaN, which takes no branch but the zeroing.
    Both sides agree exactly: no draw reaches these values."""
    from pytracking_tpu.models.kys.score_jitter import DiMPScoreJittering as JJitter

    score, _ = _score_label(4, n=2)
    score[1] = 0.0
    label = np.zeros_like(score)
    for kw in (dict(p_distractor=1.0, distractor_ratio=0.01, min_distractor_enhance_factor=0.8,
                    max_distractor_enhance_factor=1.3),
               dict(p_distractor=1.0, distractor_ratio=0.01, p_zero=1.0)):
        got = TJitter(**kw)(torch.from_numpy(score), torch.from_numpy(label),
                            torch.Generator().manual_seed(0)).numpy()
        ref = np.asarray(JJitter(**kw)(jax.random.PRNGKey(0), jnp.asarray(score[..., 0, :, :]),
                                       jnp.asarray(label[..., 0, :, :])))
        np.testing.assert_array_equal(got[:, 0], ref)
        peak = int(score[0].reshape(-1).argmax())
        assert got[0].reshape(-1)[peak] == 0.0
        assert (got[0].reshape(-1) != score[0].reshape(-1)).sum() == 1
        assert not got[1].any()


# ---------------------------------------------------------------- the recipe

def test_run_training_kys(tmp_path, monkeypatch):
    """run_training('kys', 'kys') on the tiny net (its classifier at the
    recipe's 3 steps is not needed here: the tiny net's 2) and the CPU,
    64x64 crops, one step of 2 sequences of 3 train and 4 test frames from
    the recipe's own pipeline, jitter on: a checkpoint, a finite loss, every
    predictor parameter with a nonzero gradient moved, every other parameter
    and every running statistic bit for bit."""
    from pytracking_tpu_torch.run_training import run_training

    monkeypatch.setenv("PYTRACKING_TPU_TORCH_WORKSPACE", str(tmp_path))
    net = torch_tiny_kys()
    init_weights(net, torch.Generator().manual_seed(0))
    start = {k: v.clone() for k, v in net.state_dict().items()}
    trainer = run_training("kys", "kys",
                           settings=Settings(batch_size=2, num_workers=1, print_interval=1000,
                                             output_sz=SZ, feature_sz=SZ // 16),
                           max_epochs=1, samples_per_epoch=2, net=net.eval(), device="cpu",
                           num_test_frames=4)
    assert (tmp_path / "checkpoints" / "kys" / "kys" / "ep0001.ckpt").exists()
    assert len(trainer.step_log) == 1 and trainer.restarts == 0
    assert np.isfinite(trainer.step_log[0]["loss"])
    params = dict(trainer.net.named_parameters())
    n_moved = 0
    for k, v in trainer.net.state_dict().items():
        if k in params and k.startswith("predictor."):
            reached = params[k].grad is not None and bool(params[k].grad.any())
            assert torch.equal(v, start[k]) != reached, k
            n_moved += reached
        else:
            assert torch.equal(v, start[k]), k
    assert n_moved >= 14
