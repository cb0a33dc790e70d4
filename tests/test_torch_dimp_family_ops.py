"""Parity of the PyTorch port's DiMP-family modules with the JAX package, on
the CPU: box parametrisations, `sample_patch`'s inside modes, the BasicBlock
ResNet, the classification feature blocks, PrDiMP's Newton optimiser, the
generic Gauss-Newton steepest descent and DiMP-simple's residual module,
and the weight converter on the four new nets (tiny, and the key and shape
map at full width).

Same numpy inputs from a seed through the JAX function and the port's;
weights from the JAX `init` (random BatchNorm statistics) converted with
`dimpnet_from_flax`. Float32. Tolerance: 1e-4 relative to the larger of 1
and the output's largest magnitude.
"""

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
from pytracking_tpu_torch.models.classifier import optimizer as t_optimizer
from pytracking_tpu_torch.models.classifier.residual_modules import \
    GNSteepestDescentDiMP as TGNSteepestDescentDiMP
from pytracking_tpu_torch.models.meta.steepestdescent import \
    gn_steepest_descent as t_gn_steepest_descent
from pytracking_tpu_torch.models.tracking import dimpnet as t_dimpnet
from pytracking_tpu_torch.ops import bbox as t_bbox
from pytracking_tpu_torch.ops import patch as t_patch
from pytracking_tpu_torch.utils.convert_weights import dimpnet_from_flax

ATOL = 1e-4
OUT_DIM, FSZ, BINS = 64, 4, 10
GN_KW = dict(num_iter=3, feat_stride=16, init_step_length=0.9, init_filter_reg=0.1,
             init_gauss_sigma=0.9, num_dist_bins=BINS, bin_displacement=0.5,
             mask_init_factor=3.0)
NEWTON_KW = dict(num_iter=3, feat_stride=16, init_step_length=1.0, init_filter_reg=0.05,
                 min_filter_reg=0.05, gauss_sigma=0.9, alpha_eps=0.05, normalize_label=True)
SIMPLE_KW = dict(num_iter=3, feat_stride=16, init_filter_reg=0.05, init_gauss_sigma=0.9,
                 num_dist_bins=BINS, bin_displacement=0.5, mask_init_factor=3.0,
                 act_param=0.05)
# tiny net of each kind: (block, optimiser)
KINDS = {"superdimp": ("bottleneck", "gn"), "prdimp50": ("bottleneck", "newton"),
         "simple": ("bottleneck", "simple"), "dimp18": ("basic", "gn"),
         "prdimp18": ("basic", "newton")}


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _nchw(x):
    return _t(np.moveaxis(np.asarray(x, np.float32), -1, -3))


def _nhwc(x):
    return np.moveaxis(x.detach().numpy(), -3, -1)


def _filt(w):
    """JAX filter (S, fh, fw, C, 1) -> the port's (S, 1, C, fh, fw)."""
    return np.asarray(w).transpose(0, 4, 3, 1, 2)


def _close(a, b, atol=ATOL):
    """|a - b| <= atol * max(1, max |b|)."""
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(np.asarray(a, np.float64), b,
                               atol=atol * max(1.0, np.abs(b).max()), rtol=0.0)


def perturb_batch_stats(variables, seed):
    """Replace identity BatchNorm statistics with random ones."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (np.abs(rng.randn(*np.shape(v))).astype(np.float32) + 0.5
                 if k == "var" else 0.1 * rng.randn(*np.shape(v)).astype(np.float32))
                for k, v in tree.items()}

    out = dict(variables)
    if "batch_stats" in variables:
        out["batch_stats"] = walk(variables["batch_stats"])
    return out


def _init_numpy(module, *args, seed=0, **kw):
    variables = module.init(jax.random.PRNGKey(seed), *args, **kw)
    return perturb_batch_stats(jax.tree_util.tree_map(np.asarray, dict(variables)), seed + 7)


# ---------------------------------------------------------------- tiny nets

def jax_tiny_net(kind):
    from pytracking_tpu.models.backbones.resnet import ResNet
    from pytracking_tpu.models.bbreg.iou_net import AtomIoUNet
    from pytracking_tpu.models.classifier.features import ResidualBasicBlock, ResidualBottleneck
    from pytracking_tpu.models.classifier.initializer import FilterInitializerLinear
    from pytracking_tpu.models.classifier.linear_filter import LinearFilter
    from pytracking_tpu.models.classifier.optimizer import (DiMPSteepestDescentGN,
                                                            PrDiMPSteepestDescentNewton)
    from pytracking_tpu.models.classifier.residual_modules import GNSteepestDescentDiMP
    from pytracking_tpu.models.tracking.dimpnet import DiMPnet

    block, opt = KINDS[kind]
    norm_scale = math.sqrt(1.0 / (OUT_DIM * FSZ * FSZ))
    backbone = ResNet(block=block, layers=(1, 1, 1, 1), output_layers=("layer2", "layer3"),
                      base_width=16)
    if block == "basic":
        clf_fe = ResidualBasicBlock(feature_dim=64, num_blocks=1, l2norm=True, final_conv=True,
                                    norm_scale=norm_scale, out_dim=OUT_DIM)
        iou_in = (32, 64)
    else:
        clf_fe = ResidualBottleneck(feature_dim=32, num_blocks=0, l2norm=True, final_conv=True,
                                    norm_scale=norm_scale, out_dim=OUT_DIM)
        iou_in = (128, 256)
    optimizer = {"gn": lambda: DiMPSteepestDescentGN(**GN_KW),
                 "newton": lambda: PrDiMPSteepestDescentNewton(**NEWTON_KW),
                 "simple": lambda: GNSteepestDescentDiMP(**SIMPLE_KW)}[opt]()
    classifier = LinearFilter(filter_size=FSZ,
                              filter_initializer=FilterInitializerLinear(
                                  filter_size=FSZ, feature_dim=OUT_DIM, filter_norm=False),
                              filter_optimizer=optimizer, feature_extractor=clf_fe)
    return DiMPnet(feature_extractor=backbone, classifier=classifier,
                   bb_regressor=AtomIoUNet(input_dim=iou_in, pred_input_dim=(32, 32),
                                           pred_inter_dim=(32, 32)))


def torch_tiny_net(kind):
    block, opt = KINDS[kind]
    norm_scale = math.sqrt(1.0 / (OUT_DIM * FSZ * FSZ))
    backbone = t_resnet.ResNet(layers=(1, 1, 1, 1), output_layers=("layer2", "layer3"),
                               base_width=16, block=block)
    if block == "basic":
        clf_fe = t_features.ResidualBasicBlock(in_dim=64, out_dim=OUT_DIM, norm_scale=norm_scale,
                                               feature_dim=64, num_blocks=1, final_conv=True)
        iou_in = (32, 64)
    else:
        clf_fe = t_features.ResidualBottleneck(in_dim=256, out_dim=OUT_DIM,
                                               norm_scale=norm_scale)
        iou_in = (128, 256)
    optimizer = {"gn": lambda: t_optimizer.DiMPSteepestDescentGN(**GN_KW),
                 "newton": lambda: t_optimizer.PrDiMPSteepestDescentNewton(**NEWTON_KW),
                 "simple": lambda: TGNSteepestDescentDiMP(**SIMPLE_KW)}[opt]()
    classifier = TLinearFilter(TFilterInitializerLinear(filter_size=FSZ, feature_dim=OUT_DIM),
                               optimizer, clf_fe)
    return t_dimpnet.DiMPnet(backbone, classifier,
                             TAtomIoUNet(input_dim=iou_in, pred_input_dim=(32, 32),
                                         pred_inter_dim=(32, 32))).eval()


def tiny_pair(kind, seed=0):
    """(jax net, flax variables as numpy, torch net with the same weights)."""
    jnet = jax_tiny_net(kind)
    im = jnp.zeros((1, 1, 96, 96, 3))
    bb = jnp.array([[[30.0, 30.0, 20.0, 20.0]]])
    variables = jax.jit(lambda k: jnet.init(k, im, im, bb, bb[:, :, None], train=False))(
        jax.random.PRNGKey(seed))
    variables = perturb_batch_stats(jax.tree_util.tree_map(np.asarray, dict(variables)),
                                    seed + 7)
    tnet = torch_tiny_net(kind)
    tnet.load_state_dict(dimpnet_from_flax(variables, tnet))
    return jnet, variables, tnet


# ---------------------------------------------------------------- ops

def test_rect_rel_roundtrip_matches_jax():
    from pytracking_tpu.ops.bbox import rect_to_rel, rel_to_rect

    rng = np.random.RandomState(0)
    bb = np.concatenate([rng.rand(3, 5, 2) * 100 - 20, rng.rand(3, 5, 2) * 60 + 1],
                        -1).astype(np.float32)
    sz_norm = np.array([[37.0, 52.0]], np.float32)
    for norm in (None, sz_norm):
        jn = None if norm is None else jnp.asarray(norm)
        tn = None if norm is None else _t(norm)
        rel = t_bbox.rect_to_rel(_t(bb), tn)
        _close(rel.numpy(), rect_to_rel(jnp.asarray(bb), jn))
        back = t_bbox.rel_to_rect(rel, tn)
        _close(back.numpy(), rel_to_rect(rect_to_rel(jnp.asarray(bb), jn), jn))
        _close(back.numpy(), bb)


# (pos (y, x), sample size (y, x)) on a 60x80 image
PATCH_CASES = {
    "inside": ((30.0, 40.0), (40.0, 50.0)),
    "larger_than_image": ((30.0, 40.0), (150.0, 120.0)),
    "major_axis_only_fits": ((20.0, 40.0), (70.0, 50.0)),
    "top_border": ((3.0, 40.0), (30.0, 30.0)),
    "bottom_border": ((58.0, 40.0), (30.0, 30.0)),
    "left_border": ((30.0, 2.0), (30.0, 30.0)),
    "right_border": ((30.0, 79.5), (30.0, 30.0)),
    "corner_outside": ((-5.0, 85.0), (44.0, 36.0)),
}


@pytest.mark.parametrize("max_scale_change", [None, 1.5], ids=["free", "max1.5"])
@pytest.mark.parametrize("mode", ["inside", "inside_major"])
@pytest.mark.parametrize("case", list(PATCH_CASES))
def test_sample_patch_inside_modes_match_jax(case, mode, max_scale_change):
    from pytracking_tpu.ops.patch import sample_patch

    rng = np.random.RandomState(1)
    im = (rng.rand(60, 80, 3) * 255).astype(np.float32)
    pos, sz = (np.array(v, np.float32) for v in PATCH_CASES[case])
    im_sz = np.array([60.0, 80.0], np.float32)
    ref, ref_coords = sample_patch(jnp.asarray(im), jnp.asarray(pos), jnp.asarray(sz), (24, 32),
                                   mode=mode, max_scale_change=max_scale_change,
                                   im_sz=jnp.asarray(im_sz))
    got, coords = t_patch.sample_patch(_nchw(im), _t(pos), _t(sz), (24, 32), mode=mode,
                                       max_scale_change=max_scale_change, im_sz=_t(im_sz))
    _close(_nhwc(got), ref)
    np.testing.assert_allclose(coords.numpy(), ref_coords, atol=1e-4, rtol=0)
    # the image's own size is the default
    got2, coords2 = t_patch.sample_patch(_nchw(im), _t(pos), _t(sz), (24, 32), mode=mode,
                                         max_scale_change=max_scale_change)
    assert torch.equal(coords2, coords) and torch.equal(got2, got)


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize("stride,downsample,inplanes", [(1, False, 16), (2, True, 16),
                                                        (1, True, 8)])
def test_basic_block_matches_jax(stride, downsample, inplanes):
    from pytracking_tpu.models.backbones.resnet import BasicBlock

    x = np.random.RandomState(2).randn(2, 12, 12, inplanes).astype(np.float32)
    jblock = BasicBlock(16, stride=stride, downsample=downsample)
    variables = _init_numpy(jblock, jnp.asarray(x))
    tblock = t_resnet.BasicBlock(inplanes, 16, stride=stride, downsample=downsample).eval()
    tblock.load_state_dict(dimpnet_from_flax(variables, tblock))
    _close(_nhwc(tblock(_nchw(x))), jblock.apply(variables, jnp.asarray(x)))


def test_basic_resnet_matches_jax():
    from pytracking_tpu.models.backbones.resnet import ResNet

    x = np.random.RandomState(3).randn(1, 48, 48, 3).astype(np.float32)
    jnet = ResNet(block="basic", layers=(2, 1, 2, 1), output_layers=("layer2", "layer3"),
                  base_width=16)
    variables = perturb_batch_stats(jax.tree_util.tree_map(
        np.asarray, dict(jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(x)))), 7)
    tnet = t_resnet.ResNet(layers=(2, 1, 2, 1), output_layers=("layer2", "layer3"),
                           base_width=16, block="basic").eval()
    tnet.load_state_dict(dimpnet_from_flax(variables, tnet))
    ref = jax.jit(jnet.apply)(variables, jnp.asarray(x))
    got = tnet(_nchw(x))
    assert set(got) == set(ref) == {"layer2", "layer3"}
    for k in ref:
        _close(_nhwc(got[k]), ref[k])
    # resnet18's layout: 2 BasicBlocks per stage, layer3 at 256 channels
    sd = t_resnet.resnet18().state_dict()
    assert "layer4_1.conv2.weight" in sd and "layer2_0.downsample_conv.weight" in sd
    assert "layer1_0.downsample_conv.weight" not in sd
    assert tuple(sd["layer3_1.bn2.weight"].shape) == (256,)


@pytest.mark.parametrize("which", ["basic_final_conv", "basic_two_blocks", "bottleneck_one_block",
                                   "bottleneck_one_block_no_final"])
def test_classification_feature_blocks_match_jax(which):
    from pytracking_tpu.models.classifier.features import ResidualBasicBlock, ResidualBottleneck

    scale = math.sqrt(1.0 / (32 * 16))
    if which.startswith("basic"):
        n = 1 if which == "basic_final_conv" else 2
        final = which == "basic_final_conv"
        in_dim = 24
        jm = ResidualBasicBlock(feature_dim=24, num_blocks=n, l2norm=True, final_conv=final,
                                norm_scale=scale, out_dim=32)
        tm = t_features.ResidualBasicBlock(in_dim=in_dim, out_dim=32, norm_scale=scale,
                                           feature_dim=24, num_blocks=n, final_conv=final)
    else:
        final = which == "bottleneck_one_block"
        in_dim = 64
        jm = ResidualBottleneck(feature_dim=16, num_blocks=1, l2norm=True, final_conv=final,
                                norm_scale=scale, out_dim=32)
        tm = t_features.ResidualBottleneck(in_dim=in_dim, out_dim=32, norm_scale=scale,
                                           feature_dim=16, num_blocks=1, final_conv=final)
    x = np.random.RandomState(4).randn(2, 6, 6, in_dim).astype(np.float32)
    variables = _init_numpy(jm, jnp.asarray(x))
    tm.eval().load_state_dict(dimpnet_from_flax(variables, tm))
    _close(_nhwc(tm(_nchw(x))), jm.apply(variables, jnp.asarray(x)))


def _filter_problem(seed, N=4, S=2, C=16, H=6, W=6):
    rng = np.random.RandomState(seed)
    feat = rng.randn(N, S, H, W, C).astype(np.float32) * 0.3
    w0 = rng.randn(S, FSZ, FSZ, C, 1).astype(np.float32) * 0.05
    bb = np.concatenate([rng.rand(N, S, 2) * 40 + 10, rng.rand(N, S, 2) * 20 + 14],
                        -1).astype(np.float32)
    sw = rng.rand(N, S).astype(np.float32)
    sw = sw / sw.sum(0, keepdims=True)
    return feat, w0, bb, sw


NEWTON_CASES = {
    "tracking": dict(NEWTON_KW),
    "softmax_reg": dict(NEWTON_KW, softmax_reg=-2.0),
    "uniform_shrink_threshold": dict(NEWTON_KW, init_uni_weight=0.1, label_shrink=0.05,
                                     label_threshold=0.005),
    "unnormalised": dict(NEWTON_KW, gauss_sigma=1.2, normalize_label=False),
}


@pytest.mark.parametrize("weighted", [False, True], ids=["sw_none", "sw_given"])
@pytest.mark.parametrize("case", list(NEWTON_CASES))
def test_prdimp_newton_matches_jax(case, weighted):
    from pytracking_tpu.models.classifier.optimizer import PrDiMPSteepestDescentNewton

    kw = NEWTON_CASES[case]
    feat, w0, bb, sw = _filter_problem(5)
    sw_j = jnp.asarray(sw) if weighted else None
    jm = PrDiMPSteepestDescentNewton(**kw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(w0), jnp.asarray(feat),
                        jnp.asarray(bb))
    ref = jm.apply(variables, jnp.asarray(w0), jnp.asarray(feat), jnp.asarray(bb),
                   sample_weight=sw_j, num_iter=4)[0]
    tm = t_optimizer.PrDiMPSteepestDescentNewton(**kw)
    for name, value in variables["params"].items():      # the structured init
        np.testing.assert_allclose(getattr(tm, name).detach().numpy(), value, rtol=2e-7)
    got = tm(_t(_filt(w0)), _nchw(feat), _t(bb), sample_weight=_t(sw) if weighted else None,
             num_iter=4)
    _close(got.detach().numpy(), _filt(ref))


def test_gn_steepest_descent_toy_residual_matches_jax():
    """A nonlinear least-squares residual with two leaves of different batch
    layouts, the step-length regulariser on."""
    from pytracking_tpu.models.meta.steepestdescent import gn_steepest_descent

    rng = np.random.RandomState(6)
    A = rng.randn(5, 3, 4).astype(np.float32)          # (rows, S, dim)
    y = rng.randn(5, 3).astype(np.float32)
    x0 = rng.randn(3, 4).astype(np.float32) * 0.3

    def jres(x):
        return {"data": jnp.tanh(jnp.einsum("rsd,sd->rs", A, x)) - y, "reg": 0.1 * x[None]}

    def tres(x):
        return {"data": torch.tanh(torch.einsum("rsd,sd->rs", _t(A), x)) - _t(y),
                "reg": 0.1 * x[None]}

    ref = gn_steepest_descent(jres, jnp.asarray(x0), 6, residual_batch_dim=1,
                              steplength_reg=0.2)[0]
    got = t_gn_steepest_descent(tres, _t(x0), 6, residual_batch_dim=1, steplength_reg=0.2)
    _close(got.numpy(), ref)
    # under no_grad, as the tracker calls it
    with torch.no_grad():
        got_ng = t_gn_steepest_descent(tres, _t(x0), 6, residual_batch_dim=1,
                                       steplength_reg=0.2)
    assert torch.equal(got_ng, got)


@pytest.mark.parametrize("weighted", [False, True], ids=["sw_none", "sw_given"])
@pytest.mark.parametrize("act_param", [0.05, None], ids=["act0.05", "act_default"])
def test_gn_steepest_descent_dimp_matches_jax(act_param, weighted):
    from pytracking_tpu.models.classifier.residual_modules import GNSteepestDescentDiMP

    kw = dict(SIMPLE_KW, act_param=act_param)
    feat, w0, bb, sw = _filter_problem(7)
    jm = GNSteepestDescentDiMP(**kw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(w0), jnp.asarray(feat),
                        jnp.asarray(bb))
    ref = jm.apply(variables, jnp.asarray(w0), jnp.asarray(feat), jnp.asarray(bb),
                   sample_weight=jnp.asarray(sw) if weighted else None, num_iter=3)[0]
    tm = TGNSteepestDescentDiMP(**kw)
    assert set(variables["params"]) == {n for n, _ in tm.named_parameters()}
    for name, value in variables["params"].items():      # the structured init
        np.testing.assert_allclose(getattr(tm, name).detach().numpy(), value, rtol=2e-7,
                                   atol=1e-7)
    with torch.no_grad():
        got = tm(_t(_filt(w0)), _nchw(feat), _t(bb), sample_weight=_t(sw) if weighted else None,
                 num_iter=3)
    _close(got.numpy(), _filt(ref))


# ---------------------------------------------------------------- nets and the converter

def _init_shapes(jnet, s=96):
    im = jnp.zeros((1, 1, s, s, 3))
    bb = jnp.array([[[30.0, 30.0, 20.0, 20.0]]])
    return jax.eval_shape(lambda k: jnet.init(k, im, im, bb, bb[:, :, None], train=False),
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("kind", ["dimp18", "prdimp18", "prdimp50", "simple"])
def test_tiny_net_converter_uses_every_leaf(kind):
    """Every flax leaf and torch key used, values in place (an extra or a
    missing leaf raises)."""
    rng = np.random.RandomState(9)
    variables = jax.tree_util.tree_map(lambda x: rng.randn(*x.shape).astype(np.float32),
                                       dict(_init_shapes(jax_tiny_net(kind))))
    tnet = torch_tiny_net(kind)
    sd = dimpnet_from_flax(variables, tnet)
    assert len(sd) == len(jax.tree_util.tree_leaves(variables)) == len(tnet.state_dict())
    tnet.load_state_dict(sd)
    kernel = variables["params"]["classifier"]["feature_extractor"]["final_conv"]["kernel"]
    np.testing.assert_array_equal(
        tnet.classifier.feature_extractor.final_conv.weight.detach().numpy(),
        kernel.transpose(3, 2, 0, 1))
    broken = dict(variables)
    broken["params"] = dict(variables["params"], extra={"kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError):
        dimpnet_from_flax(broken, tnet)
    smaller = dict(variables)
    smaller["params"] = {k: v for k, v in variables["params"].items() if k != "classifier"}
    with pytest.raises(KeyError):
        dimpnet_from_flax(smaller, tnet)


def test_prdimp18_tiny_net_matches_jax():
    """The one net kind the tracker traces do not run: BasicBlock backbone,
    ResidualBasicBlock feature and the Newton optimiser, converted from the
    JAX init, against the JAX net."""
    jnet, variables, tnet = tiny_pair("prdimp18")
    im = np.random.RandomState(8).rand(2, 96, 96, 3).astype(np.float32) * 255
    ref_bf, ref_x = jax.jit(lambda v, x: jnet.apply(
        v, x, method=lambda m, x: (lambda bf: (bf, m.extract_classification_feat(bf)))(
            m.extract_backbone(x))))(variables, jnp.asarray(im))
    with torch.no_grad():
        got_bf = tnet.extract_backbone(_nchw(im))
        got_x = tnet.extract_classification_feat(got_bf)
    for k in ("layer2", "layer3"):
        _close(_nhwc(got_bf[k]), ref_bf[k])
    _close(_nhwc(got_x), ref_x)

    feat = np.asarray(ref_x)[:, None]                    # (2, 1, 6, 6, C)
    bb = np.array([[[30, 28, 22, 26]], [[36, 30, 20, 20]]], np.float32)
    ref = jax.jit(lambda v, f, b: jnet.apply(
        v, f, b, method=lambda m, f, b: m.clf_get_filter(f, b, num_iter=3))[0])(
        variables, jnp.asarray(feat), jnp.asarray(bb))
    with torch.no_grad():
        got = tnet.classifier.get_filter(_nchw(feat), _t(bb), num_iter=3)
    _close(got.numpy(), _filt(ref))


FULL_WIDTH = {  # port constructor: JAX constructor
    "dimpnet18": "dimpnet18", "klcedimpnet18": "klcedimpnet18",
    "klcedimpnet50": "klcedimpnet50", "dimpnet50_simple": "dimpnet50_simple",
}


@pytest.mark.parametrize("name", list(FULL_WIDTH))
def test_full_width_converter_maps_every_leaf(name):
    """The full-width JAX net's variable tree (shapes only, by
    `jax.eval_shape`) maps one to one onto the port's net of the same name,
    at the port net's shapes; the optimiser starts at the JAX values."""
    from pytracking_tpu.models.tracking import dimpnet as j_dimpnet

    jnet = getattr(j_dimpnet, FULL_WIDTH[name])()
    shapes = _init_shapes(jnet)
    variables = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32), dict(shapes))
    tnet = getattr(t_dimpnet, name)(device="cpu")
    sd = dimpnet_from_flax(variables, tnet)
    assert set(sd) == set(tnet.state_dict())
    opt = jnet.classifier.filter_optimizer.clone(parent=None)
    feat = jnp.zeros((1, 1, 6, 6, 8))
    ref_opt = opt.init(jax.random.PRNGKey(0), jnp.zeros((1, FSZ, FSZ, 8, 1)), feat,
                       jnp.zeros((1, 1, 4)))["params"]
    assert set(ref_opt) == set(variables["params"]["classifier"]["filter_optimizer"])
    for leaf, value in ref_opt.items():
        np.testing.assert_allclose(
            getattr(tnet.classifier.filter_optimizer, leaf).detach().numpy(), value,
            rtol=2e-7, atol=1e-7)


# sigma = 0: the label map's initial weights are one-hot on bin 0 (the two
# GN optimisers), PrDiMP's label density one-hot at the nearest cell
ZERO_SIGMA = {
    "dimp_gn": ("DiMPSteepestDescentGN", dict(GN_KW, init_gauss_sigma=0.0)),
    "prdimp_newton": ("PrDiMPSteepestDescentNewton", dict(NEWTON_KW, gauss_sigma=0.0)),
    "simple_gn": ("GNSteepestDescentDiMP", dict(SIMPLE_KW, init_gauss_sigma=0.0)),
}


@pytest.mark.parametrize("site", list(ZERO_SIGMA))
def test_zero_sigma_labels_match_jax(site):
    from pytracking_tpu.models.classifier import optimizer as j_optimizer
    from pytracking_tpu.models.classifier import residual_modules as j_residual

    cls, kw = ZERO_SIGMA[site]
    jcls = getattr(j_optimizer, cls, None) or getattr(j_residual, cls)
    tcls = getattr(t_optimizer, cls, None) or TGNSteepestDescentDiMP
    feat, w0, bb, sw = _filter_problem(11)
    jm = jcls(**kw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(w0), jnp.asarray(feat),
                        jnp.asarray(bb))
    ref = jm.apply(variables, jnp.asarray(w0), jnp.asarray(feat), jnp.asarray(bb),
                   sample_weight=jnp.asarray(sw), num_iter=3)[0]
    tm = tcls(**kw)
    for name, value in variables["params"].items():      # the structured init
        np.testing.assert_allclose(getattr(tm, name).detach().numpy(), value, rtol=2e-7,
                                   atol=1e-7)
    if site == "prdimp_newton":
        center = _t(np.random.RandomState(3).rand(5, 2) * 6)
        dens = tm.get_label_density(center, (7, 7))
        jdens = jm.apply(variables, jnp.asarray(center.numpy()), (7, 7),
                         method=lambda m, c, o: m.get_label_density(c, o))[..., 0]
        assert torch.isfinite(dens).all()
        _close(dens.numpy(), jdens)
    with torch.no_grad():
        got = tm(_t(_filt(w0)), _nchw(feat), _t(bb), sample_weight=_t(sw), num_iter=3)
    assert torch.isfinite(got).all()
    _close(got.numpy(), _filt(ref))
