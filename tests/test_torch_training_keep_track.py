"""Parity of the port's KeepTrack training (the target candidate matching
net) with the JAX package, on the CPU: the assignment loss and the match
metrics on hand-built assignments; the matching net's training forward in
train mode through TCMActor against `make_tcm_actor(train=True)`: the loss,
every stat, every gradient and every running statistic moved; and
`run_training keep_track keep_track` on a tiny net.

Net: the tiny matcher of tests/test_training_actors_extra.py:89 (BasicBlock
ResNet of one block per stage at base width 8 to layer3, 64-channel
descriptors from a 4x4 conv, the keypoint encoder, one ('self', 'cross')
pair of graph layers, 5 Sinkhorn passes, 64x64 frames); weights from the
JAX `init`, random BatchNorm statistics and every bias moved off 0,
converted with `tcmnet_from_flax`. Batches: 3 pairs of textured 64x64
frames, K = 5 candidate slots with matched, unmatchable (-1) and invalid
(-2) ones.

Float32. Tolerances, relative to the larger of 1 and the reference's
largest magnitude: the hand-built loss, metrics and the loss's gradient
1e-6; the actor's loss and stats 1e-5, the running statistics 1e-4; each
gradient leaf within GRAD_TOL (tests/test_torch_training.py) of its own
largest magnitude, after checking that the port's own gradient moves by
less than STEADY_TOL of a leaf's scale when the images change by 3e-7
relative. Gradients that are exactly 0 by construction are held to
GRAD_TOL of their layer's gradient scale on both sides: the
biases before train-mode BatchNorms, the attention keys' biases under
their softmax, the attention values' and merges' biases (a constant
message the next train-mode BatchNorm removes). The port's
ResNet does not run layer4, whose running statistics flax moves (ROADMAP
§3, declared deviations).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytracking_tpu_torch.models.backbones import resnet as t_resnet
from pytracking_tpu_torch.models.loss.target_candidate_matching import (
    matching_metrics, target_candidate_matching_loss)
from pytracking_tpu_torch.models.tcm import superglue as t_superglue
from pytracking_tpu_torch.models.tcm import target_candidate_matching as t_tcm
from pytracking_tpu_torch.training.actors.tracking import TCMActor
from pytracking_tpu_torch.training.settings import Settings
from pytracking_tpu_torch.utils.convert_weights import tcmnet_from_flax

from test_torch_lwl_ops import one_thread  # noqa: F401
from test_torch_training import GRAD_TOL, _close, _np

SZ = 64
S, K = 3, 5
BATCH_SEED = 0
STEADY_EPS = 3e-7
STEADY_TOL = 1e-4
# per pair: the slots' gt match (-2 invalid, -1 to the dustbin, else the
# index on the other frame)
GT_MATCHES0 = np.array([[0, 1, -1, 3, -2], [1, 0, 2, -1, -1], [-1, 4, 2, 0, -2]], np.int32)


def _gt():
    """(gt_assignment (S, K, K), gt_matches0, gt_matches1) from GT_MATCHES0."""
    assign = np.zeros((S, K, K), np.float32)
    m1 = np.full((S, K), -1, np.int32)
    for s in range(S):
        for i, j in enumerate(GT_MATCHES0[s]):
            if j >= 0:
                assign[s, i, j] = 1.0
                m1[s, j] = i
        m1[s, GT_MATCHES0[s] == -2] = -2          # an invalid slot on both frames
    return assign, GT_MATCHES0.copy(), m1


def make_batch(seed):
    """A sample-major numpy batch (images NHWC, 0-255): textured frames with
    bright squares, candidate cells on the 4x4 grid, their image
    coordinates and scores, and the gt matches of GT_MATCHES0."""
    rng = np.random.RandomState(seed)
    ims = rng.rand(2, S, SZ, SZ, 3).astype(np.float32) * 60
    for i in range(2):
        for s in range(S):
            w, h = rng.randint(12, 25, 2)
            x, y = rng.randint(2, SZ - 2 - w), rng.randint(2, SZ - 2 - h)
            ims[i, s, y:y + h, x:x + w] = 150.0 + rng.rand(h, w, 3) * 100
    coords0 = rng.randint(0, SZ // 16, (S, K, 2)).astype(np.int32)
    coords1 = np.clip(coords0 + rng.randint(-1, 2, (S, K, 2)), 0, SZ // 16 - 1).astype(np.int32)
    assign, m0, m1 = _gt()
    return {"img0": ims[0], "img1": ims[1], "tsm_coords0": coords0, "tsm_coords1": coords1,
            "img_coords0": (coords0 * 16 + rng.rand(S, K, 2) * 4).astype(np.float32),
            "img_coords1": (coords1 * 16 + rng.rand(S, K, 2) * 4).astype(np.float32),
            "scores0": rng.rand(S, K).astype(np.float32),
            "scores1": rng.rand(S, K).astype(np.float32),
            "gt_assignment": assign, "gt_matches0": m0, "gt_matches1": m1}


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(np.moveaxis(v, -1, -3)
                                                     if k.startswith("img") and v.ndim == 4
                                                     else v)) for k, v in batch.items()}


def jax_tiny_tcm():
    from pytracking_tpu.models.backbones.resnet import ResNet
    from pytracking_tpu.models.tcm.superglue import SuperGlueMatcher
    from pytracking_tpu.models.tcm.target_candidate_matching import (
        DescriptorExtractor, TargetCandidateMatchingNetwork)

    return TargetCandidateMatchingNetwork(
        feature_extractor=ResNet(block="basic", layers=(1, 1, 1, 1), output_layers=("layer3",),
                                 base_width=8),
        descriptor_extractor=DescriptorExtractor(descriptor_dim=64, kernel_size=4),
        matcher=SuperGlueMatcher(input_dim=64, descriptor_dim=64, num_gnn_layers=1,
                                 num_sinkhorn_iterations=5, image_shape=(SZ, SZ)))


def torch_tiny_tcm():
    return t_tcm.TargetCandidateMatchingNetwork(
        t_resnet.ResNet(layers=(1, 1, 1, 1), output_layers=("layer3",), base_width=8,
                        block="basic"),
        t_tcm.DescriptorExtractor(32, descriptor_dim=64, kernel_size=4),
        t_superglue.SuperGlueMatcher(input_dim=64, descriptor_dim=64, num_gnn_layers=1,
                                     num_sinkhorn_iterations=5, image_shape=(SZ, SZ)))


_JAX_KEYS = ("img0", "img1", "tsm_coords0", "tsm_coords1", "img_coords0", "img_coords1",
             "scores0", "scores1")


@functools.lru_cache(maxsize=None)
def pair():
    """(JAX net, its variables as numpy): random BatchNorm statistics, every
    bias moved by 0.1 x a normal draw."""
    jnet = jax_tiny_tcm()
    b = {k: jnp.asarray(v) for k, v in make_batch(BATCH_SEED).items()}
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(
        lambda key: jnet.init(key, *(b[k] for k in _JAX_KEYS), train=False))(
        jax.random.PRNGKey(0))))
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


def make_tnet():
    _, variables = pair()
    tnet = torch_tiny_tcm()
    tnet.load_state_dict(tcmnet_from_flax(variables, tnet))
    return tnet.train()


@pytest.fixture(scope="module")
def run():
    """The JAX actor in train mode on make_batch(BATCH_SEED): loss, stats,
    new batch stats and gradients (one jit of value_and_grad)."""
    from pytracking_tpu.training.actors.tracking import make_tcm_actor

    jnet, variables = pair()
    actor = make_tcm_actor(jnet, train=True)
    batch = {k: jnp.asarray(v) for k, v in make_batch(BATCH_SEED).items()}
    (loss, (stats, bs)), grads = jax.jit(jax.value_and_grad(actor, has_aux=True))(
        variables["params"], variables["batch_stats"], batch)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"loss": float(loss), "stats": {k: float(v) for k, v in stats.items()},
            "batch_stats": as_np(bs), "grads": as_np(grads)}


def _running_stats(state):
    return {k: v for k, v in state.items() if k.endswith(("running_mean", "running_var"))}


def exact_zero(name):
    """Whether a leaf's gradient is exactly 0 by construction, rounding
    alone making it otherwise: a Dense bias before a train-mode BatchNorm
    (the MLPs' hidden layers); an attention key's bias (a constant per
    query under the softmax over keys); an attention value's and its merge's
    biases (a constant added to every message, which the graph layer's MLP
    feeds to a train-mode BatchNorm over all tokens)."""
    return name.endswith(("proj_k.bias", "proj_v.bias", "merge.bias")) or (
        ".lin" in name and name.endswith(".bias") and not _last_lin(name))


def _last_lin(name):
    """Whether `name` is the bias of an MLP's last layer (no BatchNorm after
    it): lin4 of the keypoint encoder, lin1 of a graph layer's MLP."""
    layer = name.rsplit(".", 2)[1]
    return layer == ("lin4" if ".kenc." in name else "lin1")


# ---------------------------------------------------------------- the loss

def test_loss_and_metrics_match_jax_on_hand_built_assignments():
    """target_candidate_matching_loss on a random log assignment (2 x (4+1)
    x (5+1): non-square) with matched, unmatchable (-1) and invalid (-2)
    slots, a pair with no match and one with no unmatchable slot (the counts
    clamp at 1): every value and the gradient of 'total'; matching_metrics
    on predicted matches with right, wrong, dustbin and invalid slots."""
    from pytracking_tpu.models.loss import target_candidate_matching as j_loss

    rng = np.random.RandomState(5)
    B, M, N = 3, 4, 5
    la = rng.randn(B, M + 1, N + 1).astype(np.float32) - 2.0
    m0 = np.array([[0, -1, 3, -2], [-1, -1, -2, -1], [1, 0, 2, 4]], np.int32)
    m1 = np.array([[0, -2, -1, 2, -1], [-1, -1, -1, -2, -1], [1, 0, 2, -2, 3]], np.int32)
    assign = np.zeros((B, M, N), np.float32)
    for b in range(B):
        for i, j in enumerate(m0[b]):
            if j >= 0:
                assign[b, i, j] = 1.0
    bin_score = np.float32(0.7)
    ref, ref_grad = jax.value_and_grad(
        lambda x: j_loss.target_candidate_matching_loss(
            x, jnp.asarray(assign), jnp.asarray(m0), jnp.asarray(m1), jnp.asarray(bin_score),
            nll_balancing=0.3)["total"])(jnp.asarray(la))
    ref_all = j_loss.target_candidate_matching_loss(
        jnp.asarray(la), jnp.asarray(assign), jnp.asarray(m0), jnp.asarray(m1),
        jnp.asarray(bin_score), nll_balancing=0.3)
    x = torch.from_numpy(la).requires_grad_(True)
    got = target_candidate_matching_loss(x, torch.from_numpy(assign), torch.from_numpy(m0),
                                         torch.from_numpy(m1), torch.tensor(bin_score),
                                         nll_balancing=0.3)
    got["total"].backward()
    assert sorted(got) == sorted(ref_all)
    for k, v in got.items():
        _close(v.item(), float(ref_all[k]), 1e-6)
    _close(got["total"].item(), float(ref), 1e-6)
    _close(_np(x.grad), np.asarray(ref_grad), 1e-6)

    pred = np.array([[0, 3, -1, 2, 1], [-1, 2, -1, 0, 4], [1, 0, -1, 3, 3]], np.int32)
    ref_m = j_loss.matching_metrics(jnp.asarray(pred), jnp.asarray(m1))
    got_m = matching_metrics(torch.from_numpy(pred).long(), torch.from_numpy(m1))
    assert sorted(got_m) == sorted(ref_m)
    for k, v in got_m.items():
        _close(v.item(), float(ref_m[k]), 1e-6)
    assert 0 < got_m["match_recall"].item() < 1 and 0 < got_m["match_precision"].item() < 1


# ---------------------------------------------------------------- the actor

def test_actor_and_running_statistics_match_jax(run):
    """The port's forward in train mode through TCMActor against the JAX
    actor: the loss, every stat under the JAX names (match recall and
    precision among them), and every running statistic moved as flax moves
    it (the backbone's on both frames, the keypoint encoder's on both
    candidate sets, each graph layer's on both); layer4, which the port does
    not run, left as it was where flax moves it."""
    tnet = make_tnet()
    start = {k: v.clone() for k, v in _running_stats(tnet.state_dict()).items()}
    loss, stats = TCMActor(tnet)(to_torch(make_batch(BATCH_SEED)))
    assert sorted(stats) == sorted(run["stats"])
    _close(loss.item(), run["loss"], 1e-5)
    for k, v in stats.items():
        _close(v.item(), run["stats"][k], 1e-5)
    _, variables = pair()
    moved = tcmnet_from_flax({"params": variables["params"], "batch_stats": run["batch_stats"]},
                             tnet)
    n_moved = 0
    for k, v in _running_stats(tnet.state_dict()).items():
        if k.startswith("feature_extractor.layer4"):
            assert torch.equal(v, start[k]) and not torch.equal(moved[k], start[k]), k
            continue
        _close(_np(v), moved[k].numpy(), 1e-4)
        assert not torch.equal(v, start[k]), k
        n_moved += 1
    assert n_moved >= 30


def _grads(batch):
    tnet = make_tnet()
    TCMActor(tnet)(batch)[0].backward()
    return {n: p.grad for n, p in tnet.named_parameters() if p.grad is not None}


def test_gradients_match_jax(run):
    """Every parameter's .grad against jax.value_and_grad of the JAX actor,
    through the converter, within GRAD_TOL of the leaf's scale, after
    checking that the port's own gradient is steady under a 3e-7 relative
    change of the images; layer4 gets no gradient (a zero one in JAX)."""
    batch = to_torch(make_batch(BATCH_SEED))
    g0 = _grads(batch)
    gen = torch.Generator().manual_seed(0)
    moved = dict(batch)
    for k in ("img0", "img1"):
        moved[k] = batch[k] * (1 + STEADY_EPS * torch.randn(batch[k].shape, generator=gen))
    g1 = _grads(moved)
    steady = {n: float((g1[n] - g0[n]).abs().max() / g0[n].abs().max()) for n in g0
              if not exact_zero(n)}
    assert max(steady.values()) < STEADY_TOL, max(steady.items(), key=lambda kv: kv[1])

    _, variables = pair()
    ref = tcmnet_from_flax({"params": run["grads"], "batch_stats": variables["batch_stats"]})
    worst = {}
    for name, _ in make_tnet().named_parameters():
        r = ref[name].numpy()
        if name not in g0:
            assert name.startswith("feature_extractor.layer4") and not r.any(), name
            continue
        if exact_zero(name):
            scale = np.abs(ref[name[:-len("bias")] + "weight"].numpy()).max()
            worst[name] = max(np.abs(_np(g0[name])).max(), np.abs(r).max()) / scale
            continue
        worst[name] = np.abs(_np(g0[name]) - r).max() / np.abs(r).max()
    bad = {k: v for k, v in worst.items() if v > GRAD_TOL}
    assert not bad, bad
    assert len(worst) > 60


# ---------------------------------------------------------------- the recipe

def test_run_training_keep_track(tmp_path, monkeypatch):
    """run_training('keep_track', 'keep_track') on the tiny net and the CPU,
    64x64 frames, K = 4, one step of 2 pairs from the recipe's synthetic
    candidate dataset: a checkpoint, a finite loss and the match stats,
    every parameter with a nonzero gradient moved and the others (layer4)
    not, every running statistic but layer4's moved."""
    from pytracking_tpu_torch.run_training import run_training

    monkeypatch.setenv("PYTRACKING_TPU_TORCH_WORKSPACE", str(tmp_path))
    net = t_tcm.init_weights(torch_tiny_tcm(), torch.Generator().manual_seed(0)).eval()
    start = {k: v.clone() for k, v in net.state_dict().items()}
    trainer = run_training("keep_track", "keep_track",
                           settings=Settings(batch_size=2, num_workers=1, print_interval=1000),
                           max_epochs=1, samples_per_epoch=2, net=net, device="cpu", im_sz=SZ,
                           K=4)
    assert (tmp_path / "checkpoints" / "keep_track" / "keep_track" / "ep0001.ckpt").exists()
    assert len(trainer.step_log) == 1 and trainer.restarts == 0
    assert np.isfinite(trainer.step_log[0]["loss"])
    assert "match_recall" in trainer.stats["train"]
    params = dict(trainer.net.named_parameters())
    for k, v in trainer.net.state_dict().items():
        if k in params:
            reached = params[k].grad is not None and bool(params[k].grad.any())
            assert torch.equal(v, start[k]) != reached, k
            assert reached != k.startswith("feature_extractor.layer4"), k
        elif k.endswith(("running_mean", "running_var")):
            assert torch.equal(v, start[k]) == k.startswith("feature_extractor.layer4"), k
