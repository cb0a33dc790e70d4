"""Parity of the PyTorch port's DiMP slice with the JAX package, on the CPU.

The tiny DiMP of tests/test_dimp_tracker.py (ResNet with one block per
stage at base width 16, 64-channel classification features, 4x4 filter,
10 distance bins, IoU-Net on (128, 256) channels with 32-wide heads, 96x96
samples, memory 8; DiMP-50's initialiser, without size normalisation). Weights: the JAX `net.init` with random BatchNorm
statistics, converted with `dimpnet_from_flax`. Float32 throughout.
Tolerances: modules 1e-4 relative to the larger of 1 and the output's
largest magnitude; the tracker trace: flags, replace indices and
`num_stored` equal, memory weights within 1e-6, boxes within 1e-3 px.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytracking_tpu_torch.models.backbones import resnet as t_resnet
from pytracking_tpu_torch.models.bbreg.iou_net import AtomIoUNet as TAtomIoUNet
from pytracking_tpu_torch.models.classifier.features import \
    ResidualBottleneck as TResidualBottleneck
from pytracking_tpu_torch.models.classifier.initializer import \
    FilterInitializerLinear as TFilterInitializerLinear
from pytracking_tpu_torch.models.classifier.linear_filter import LinearFilter as TLinearFilter
from pytracking_tpu_torch.models.classifier.optimizer import \
    DiMPSteepestDescentGN as TDiMPSteepestDescentGN
from pytracking_tpu_torch.models.tracking import dimpnet as t_dimpnet
from pytracking_tpu_torch.trackers import dimp as t_dimp
from pytracking_tpu_torch.utils.convert_weights import dimpnet_from_flax

ATOL = 1e-4
OUT_DIM, FSZ, BINS = 64, 4, 10
OPT_KW = dict(num_iter=3, feat_stride=16, init_step_length=0.9, init_filter_reg=0.1,
              init_gauss_sigma=0.9, num_dist_bins=BINS, bin_displacement=0.5,
              mask_init_factor=3.0)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _nchw(x):
    return _t(np.moveaxis(np.asarray(x, np.float32), -1, -3))


def _nhwc(x):
    return np.moveaxis(x.detach().numpy(), -3, -1)


def _close(a, b, atol=ATOL):
    """|a - b| <= atol * max(1, max |b|)."""
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(np.asarray(a, np.float64), b,
                               atol=atol * max(1.0, np.abs(b).max()), rtol=0.0)


def jax_tiny_dimpnet():
    from pytracking_tpu.models.backbones.resnet import ResNet
    from pytracking_tpu.models.bbreg.iou_net import AtomIoUNet
    from pytracking_tpu.models.classifier.features import ResidualBottleneck
    from pytracking_tpu.models.classifier.initializer import FilterInitializerLinear
    from pytracking_tpu.models.classifier.linear_filter import LinearFilter
    from pytracking_tpu.models.classifier.optimizer import DiMPSteepestDescentGN
    from pytracking_tpu.models.tracking.dimpnet import DiMPnet

    backbone = ResNet(block="bottleneck", layers=(1, 1, 1, 1),
                      output_layers=("layer2", "layer3"), base_width=16)
    clf_fe = ResidualBottleneck(feature_dim=32, num_blocks=0, l2norm=True, final_conv=True,
                                norm_scale=math.sqrt(1.0 / (OUT_DIM * FSZ * FSZ)),
                                out_dim=OUT_DIM)
    classifier = LinearFilter(filter_size=FSZ,
                              filter_initializer=FilterInitializerLinear(
                                  filter_size=FSZ, feature_dim=OUT_DIM, filter_norm=False),
                              filter_optimizer=DiMPSteepestDescentGN(**OPT_KW),
                              feature_extractor=clf_fe)
    return DiMPnet(feature_extractor=backbone, classifier=classifier,
                   bb_regressor=AtomIoUNet(input_dim=(128, 256), pred_input_dim=(32, 32),
                                           pred_inter_dim=(32, 32)))


def torch_tiny_dimpnet():
    backbone = t_resnet.ResNet(layers=(1, 1, 1, 1), output_layers=("layer2", "layer3"),
                               base_width=16)
    clf_fe = TResidualBottleneck(in_dim=256, out_dim=OUT_DIM,
                                 norm_scale=math.sqrt(1.0 / (OUT_DIM * FSZ * FSZ)))
    classifier = TLinearFilter(TFilterInitializerLinear(filter_size=FSZ, feature_dim=OUT_DIM),
                               TDiMPSteepestDescentGN(**OPT_KW), clf_fe)
    return t_dimpnet.DiMPnet(backbone, classifier,
                             TAtomIoUNet(input_dim=(128, 256), pred_input_dim=(32, 32),
                                         pred_inter_dim=(32, 32))).eval()


def _perturb_batch_stats(variables, seed):
    """Identity BatchNorm statistics would hide a mean/var mix-up: replace
    them with random ones."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (np.abs(rng.randn(*np.shape(v))).astype(np.float32) + 0.5
                 if k == "var" else 0.1 * rng.randn(*np.shape(v)).astype(np.float32))
                for k, v in tree.items()}

    out = dict(variables)
    out["batch_stats"] = walk(variables["batch_stats"])
    return out


@pytest.fixture(scope="module")
def nets():
    """(jax net, flax variables as numpy, torch net with the same weights)."""
    jnet = jax_tiny_dimpnet()
    im = jnp.zeros((1, 1, 96, 96, 3))
    bb = jnp.array([[[30.0, 30.0, 20.0, 20.0]]])
    variables = jax.jit(lambda k: jnet.init(k, im, im, bb, bb[:, :, None], train=False))(
        jax.random.PRNGKey(0))
    variables = _perturb_batch_stats(jax.tree_util.tree_map(np.asarray, dict(variables)), 7)
    tnet = torch_tiny_dimpnet()
    tnet.load_state_dict(dimpnet_from_flax(variables, tnet))
    return jnet, variables, tnet


def _apply(jnet, variables, fn, *args):
    return jnet.apply(variables, *(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                   for a in args), method=fn)


# ---------------------------------------------------------------- weights

def test_converter_uses_every_leaf_and_key(nets):
    _, variables, tnet = nets
    sd = dimpnet_from_flax(variables, tnet)
    assert len(sd) == len(jax.tree_util.tree_leaves(variables)) == len(tnet.state_dict())
    broken = dict(variables)
    broken["params"] = dict(variables["params"], extra={"kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError):
        dimpnet_from_flax(broken, tnet)
    smaller = dict(variables)
    smaller["params"] = {k: v for k, v in variables["params"].items() if k != "bb_regressor"}
    with pytest.raises(KeyError):
        dimpnet_from_flax(smaller, tnet)


@pytest.mark.parametrize("kw", [OPT_KW, dict(num_iter=5, init_step_length=0.9,
                                             init_filter_reg=0.1, init_gauss_sigma=0.9,
                                             num_dist_bins=100, bin_displacement=0.1,
                                             mask_init_factor=3.0)],
                         ids=["tiny", "dimp50"])
def test_optimizer_structured_init_matches_jax(kw):
    """The five meta-optimiser parameters of a port-built optimiser start
    at the JAX module's initial values (1 float32 ulp: exp and tanh)."""
    from pytracking_tpu.models.classifier.optimizer import DiMPSteepestDescentGN

    feat = jnp.zeros((1, 1, 4, 4, 8))
    ref = DiMPSteepestDescentGN(**kw).init(jax.random.PRNGKey(0), jnp.zeros((1, FSZ, FSZ, 8, 1)),
                                           feat, jnp.zeros((1, 1, 4)))["params"]
    got = TDiMPSteepestDescentGN(**kw)
    assert set(ref) == {n for n, _ in got.named_parameters()}
    for name, value in ref.items():
        np.testing.assert_allclose(getattr(got, name).detach().numpy(), value, rtol=2e-7,
                                   atol=1e-7)


# ---------------------------------------------------------------- modules

def _backbone_feats(nets, seed=1, n=2):
    jnet, variables, tnet = nets
    im = np.random.RandomState(seed).rand(n, 96, 96, 3).astype(np.float32) * 255
    ref = _apply(jnet, variables, lambda m, x: m.extract_backbone(x), im)
    got = tnet.extract_backbone(_nchw(im))
    return ref, got


def test_classification_features_match_jax(nets):
    jnet, variables, tnet = nets
    ref_bf, got_bf = _backbone_feats(nets)
    for name in ("layer2", "layer3"):
        _close(_nhwc(got_bf[name]), ref_bf[name])
    ref = _apply(jnet, variables, lambda m, f: m.extract_classification_feat(f), ref_bf)
    _close(_nhwc(tnet.extract_classification_feat(got_bf)), ref)


def test_get_filter_and_classify_match_jax(nets):
    """The initialiser and 3 optimiser iterations over N = 4 images, with
    and without sample weights, then the scores of a test feature."""
    jnet, variables, tnet = nets
    rng = np.random.RandomState(2)
    feat = rng.randn(4, 1, 6, 6, OUT_DIM).astype(np.float32) * 0.05
    bb = np.array([[[30, 28, 22, 26]], [[36, 30, 20, 20]], [[25, 35, 30, 24]],
                   [[40, 40, 16, 18]]], np.float32)
    sw = np.array([[0.4], [0.3], [0.2], [0.1]], np.float32)
    for weight in (None, sw):
        ref = jnet.apply(variables, jnp.asarray(feat), jnp.asarray(bb), method=lambda m, f, b:
                         m.clf_get_filter(f, b, num_iter=3,
                                          sample_weight=None if weight is None
                                          else jnp.asarray(weight)))[0]
        got = tnet.classifier.get_filter(_nchw(feat), _t(bb), num_iter=3,
                                         sample_weight=None if weight is None else _t(weight))
        _close(got.detach().numpy(), np.asarray(ref).transpose(0, 4, 3, 1, 2))
    test = rng.randn(1, 6, 6, OUT_DIM).astype(np.float32) * 0.05
    s_ref = _apply(jnet, variables, lambda m, w, f: m.clf_classify(w, f), ref, test)
    s = tnet.classifier.classify(got, _nchw(test))
    _close(_nhwc(s), s_ref)


def test_iou_net_matches_jax(nets):
    """Modulation, IoU features, predicted IoU and its gradient in the
    proposals (what box refinement ascends)."""
    jnet, variables, tnet = nets
    ref_bf, got_bf = _backbone_feats(nets, seed=3, n=1)
    bb = np.array([[30.0, 28.0, 24.0, 30.0]], np.float32)
    mod_ref = _apply(jnet, variables, lambda m, f, b: m.iou_get_modulation(f, b), ref_bf, bb)
    mod = tnet.bb_regressor.get_modulation(tnet.get_backbone_bbreg_feat(got_bf), _t(bb))
    for g, r in zip(mod, mod_ref):
        _close(g.detach().numpy(), r)
    feat_ref = _apply(jnet, variables, lambda m, f: m.iou_get_iou_feat(f), ref_bf)
    feat = tnet.bb_regressor.get_iou_feat(tnet.get_backbone_bbreg_feat(got_bf))
    for g, r in zip(feat, feat_ref):
        _close(_nhwc(g), r)
    props = np.array([[[30, 28, 24, 30], [26, 30, 30, 22], [10, 50, 40, 40],
                       [-5, 60, 30, 50]]], np.float32)

    def jiou(p):
        return jnet.apply(variables, mod_ref, feat_ref, p,
                          method=lambda m, mo, f, pp: m.iou_predict(mo, f, pp))

    iou_ref, vjp = jax.vjp(jax.jit(jiou), jnp.asarray(props))
    grad_ref = vjp(jnp.ones_like(iou_ref))[0]
    p = _t(props).requires_grad_(True)
    iou = tnet.bb_regressor.predict_iou(mod, feat, p)
    grad, = torch.autograd.grad(iou.sum(), p)
    _close(iou.detach().numpy(), iou_ref)
    _close(grad.numpy(), grad_ref)


# ---------------------------------------------------------------- tracker

def _frame(t, H=128, W=128):
    im = np.full((H, W, 3), 30, np.uint8)
    cy, cx = 56 + 2 * t, 52 + 3 * t
    im[cy - 10:cy + 10, cx - 9:cx + 9] = [220, 60, 60]
    return im


TRACE_KW = dict(image_sample_size=96, sample_memory_size=8, net_opt_iter=3,
                net_opt_update_iter=2, net_opt_hn_iter=1,
                augmentation=(("fliplr", True), ("rotate", (10,)), ("blur", ((2, 1),)),
                              ("relativeshift", ((0.6, 0.6),)), ("dropout", (1, 0.2))),
                num_init_random_boxes=3, box_refinement_iter=2, iounet_k=2,
                train_skipping=4, target_not_found_threshold=0.185)


def _trace_against_jax(nets, trace_kw, n_frames=10):
    """initialize + `n_frames` frames of the JAX tracker and the port's with
    `trace_kw`, the JAX tracker's draws fed to the port; every frame's
    flag, box, score, state counters, memory and filter held to the JAX
    ones. Returns the port's (flags, classifier iterations) per frame."""
    from pytracking_tpu.trackers.dimp import DiMPParams, DiMPTracker

    jnet, variables, tnet = nets
    jtr = DiMPTracker(DiMPParams(**trace_kw), jnet, variables)
    ttr = t_dimp.DiMPTracker(t_dimp.DiMPParams(**trace_kw), tnet, device="cpu")

    drop_key = jax.random.split(jax.random.PRNGKey(0))[1]
    n_drop, prob = dict(trace_kw["augmentation"])["dropout"]

    def keep_mask(shape, p):
        assert tuple(shape) == (n_drop, OUT_DIM, 1, 1) and p == prob
        keep = jax.random.bernoulli(drop_key, 1.0 - p, (n_drop, 1, 1, OUT_DIM))
        return _nchw(keep) > 0.5

    ttr._keep_mask = keep_mask
    info = {"init_bbox": [43.0, 46.0, 18.0, 20.0]}
    jtr.initialize(_frame(0), info)
    ttr.initialize(_frame(0), info)
    _close(_nhwc(ttr.state.mem_samples), jtr.state.mem_samples)
    _close(ttr.state.target_filter.numpy(),
           np.asarray(jtr.state.target_filter).transpose(0, 4, 3, 1, 2))

    flags, iters = [], []
    for t in range(1, n_frames + 1):
        jitter = jax.random.uniform(jax.random.split(jtr.state.key)[1],
                                    (trace_kw["num_init_random_boxes"], 4))
        ttr._uniform = lambda shape, u=_t(jitter): u
        jo = jtr.track(_frame(t))
        to = ttr.track(_frame(t))
        js, ts = jtr.state, ttr.state
        assert to["flag"] == jo["flag"], t
        np.testing.assert_allclose(to["target_bbox"], jo["target_bbox"], atol=1e-3, rtol=0)
        assert abs(to["max_score"] - jo["max_score"]) <= 1e-4 * max(1, abs(jo["max_score"]))
        assert int(ts.flag) == int(js.flag)
        assert int(ts.num_stored) == int(js.num_stored)
        assert int(ts.prev_ind) == int(js.prev_ind)
        assert ts.frame_num == int(js.frame_num)
        np.testing.assert_allclose(ts.mem_weights.numpy(), js.mem_weights, atol=1e-6, rtol=0)
        np.testing.assert_allclose(ts.mem_boxes.numpy(), js.mem_boxes, atol=1e-3, rtol=0)
        _close(_nhwc(ts.mem_samples), js.mem_samples)
        _close(ts.target_filter.numpy(), np.asarray(js.target_filter).transpose(0, 4, 3, 1, 2))
        flags.append(jo["flag"])
        iters.append(ttr._classifier_iterations(t_dimp.FLAG_NAMES.index(to["flag"]),
                                                ts.frame_num))
    return ttr, flags, iters


def test_tracker_trace_matches_jax(nets):
    """initialize + 10 frames on 128x128 frames (the JAX package's 128-pixel
    shape bucket pads nothing). The port draws the dropout mask and the box
    jitter through `_keep_mask` / `_uniform`; here both return the JAX
    tracker's own draws, from its key with its splits. With these random
    weights and a not-found threshold of 0.185 frame 1 is normal (no
    update), frames 2-5 hard negatives (one optimiser iteration each), 6-7
    normal, 8 normal on the train_skipping = 4 cadence (the periodic two),
    9-10 normal; every score peak clears each threshold it is compared with
    by 2e-3 or more, far beyond float32 rounding. Memory 8 with 6 init
    samples fills after 2 updates; the later ones replace the lightest
    slot."""
    ttr, flags, iters = _trace_against_jax(nets, TRACE_KW)
    # the trace filled the memory and ran every classifier branch
    assert int(ttr.state.num_stored) == TRACE_KW["sample_memory_size"], flags
    assert iters == [0, 1, 1, 1, 1, 0, 0, 2, 0, 0], str((flags, iters))


def test_tracker_trace_pair_step_matches_jax(nets):
    """The box refinement's step length as a (pos, sz) pair (ATOM's
    convention, [pos, pos, sz, sz] per coordinate), in the box space and in
    the relative space with a step decay, over 6 frames each."""
    for space, step, decay in (("default", (0.6, 1.4), 1.0), ("relative", (0.02, 0.05), 0.8)):
        kw = dict(TRACE_KW, box_refinement_step_length=step, box_refinement_space=space,
                  box_refinement_step_decay=decay)
        ttr, flags, _ = _trace_against_jax(nets, kw, n_frames=6)
        assert "normal" in flags, (space, flags)


WINDOWED = dict(window_output=True, perform_hn_without_windowing=True)
LOCALIZE_CASES = {
    # name: (peak 1 (value, (row, col)), peak 2 or None, expected flag, params)
    "normal": ((1.0, (9, 9)), None, t_dimp.FLAG_NORMAL, {}),
    "not_found": ((0.2, (9, 9)), None, t_dimp.FLAG_NOT_FOUND, {}),
    "hard_negative_second_peak": ((1.0, (9, 9)), (0.6, (2, 2)), t_dimp.FLAG_HARD_NEG, {}),
    "hard_negative_distractor_far": ((1.0, (9, 9)), (0.9, (1, 17)), t_dimp.FLAG_HARD_NEG, {}),
    "hard_negative_target_moved": ((1.0, (1, 17)), (0.9, (9, 9)), t_dimp.FLAG_HARD_NEG, {}),
    "uncertain": ((1.0, (9, 9)), (0.9, (9, 15)), t_dimp.FLAG_UNCERTAIN, {}),
    # the Hann window takes the centre as the first peak; the raw corner
    # peak is the far distractor
    "windowed_hard_negative": ((0.7, (9, 9)), (1.0, (1, 1)), t_dimp.FLAG_HARD_NEG, WINDOWED),
}


@pytest.mark.parametrize("case", list(LOCALIZE_CASES))
def test_localize_flag_regimes_match_jax(nets, case):
    """Crafted 19x19 score maps (DiMP-50's grid) that reach each flag: the
    port's translation and flag against the JAX tracker's `_localize`."""
    from pytracking_tpu.trackers.dimp import DiMPParams, DiMPTracker

    jnet, variables, tnet = nets
    peak1, peak2, expected, kw = LOCALIZE_CASES[case]
    scores = np.random.RandomState(4).rand(19, 19).astype(np.float32) * 0.05
    for value, (r, c) in (peak1, peak2) if peak2 else (peak1,):
        scores[r, c] = value
    pos, target_sz = np.array([150.0, 170.0], np.float32), np.array([40.0, 36.0], np.float32)
    sample_pos, sample_scale = pos.copy(), np.float32(1.1)
    jtr = DiMPTracker(DiMPParams(**kw), jnet, variables)
    ttr = t_dimp.DiMPTracker(t_dimp.DiMPParams(**kw), tnet, device="cpu")
    j_trans, j_flag, j_max = jtr._localize(
        types.SimpleNamespace(pos=jnp.asarray(pos), target_sz=jnp.asarray(target_sz)),
        jnp.asarray(scores), jnp.asarray(sample_pos), jnp.asarray(sample_scale), 18.0,
        jnp.array([288.0, 288.0]))
    t_trans, t_flag, t_max = ttr._localize(
        types.SimpleNamespace(pos=_t(pos), target_sz=_t(target_sz)), _t(scores),
        _t(sample_pos), torch.tensor(sample_scale))
    assert int(j_flag) == expected
    assert int(t_flag) == int(j_flag)
    np.testing.assert_allclose(t_trans.numpy(), j_trans, atol=1e-4, rtol=0)
    assert float(t_max) == float(j_max)
