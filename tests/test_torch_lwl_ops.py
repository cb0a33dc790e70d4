"""Parity of the PyTorch port's LWL / RTS / STA modules with the JAX package,
on the CPU: the stride-in-1x1 Bottleneck and the BGR-255 input, the mask
crop (half-pixel ties), the decoder's resizes and the decoder, both label
encoders and the box prior, the LWL target model, the hinge optimiser, the
stride-2 classification feature, RTS's score encoder and fusion; plus the
tiny nets that test_torch_lwl.py holds to the JAX ones (its net-level tests
cover the STA forward and RTS's fused segmentation).

Same numpy inputs from a seed through the JAX function and the port's;
weights from the JAX `init` (random BatchNorm statistics) converted with
`utils/convert_weights`. Float32. Tolerance: 1e-5 relative to the larger of
1 and the output's largest magnitude (`ATOL`); the mask crop is exact.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytracking_tpu_torch.models.backbones import resnet as t_resnet
from pytracking_tpu_torch.models.classifier import features as t_features
from pytracking_tpu_torch.models.classifier.initializer import \
    FilterInitializerLinear as TFilterInitializerLinear
from pytracking_tpu_torch.models.classifier.linear_filter import LinearFilter as TLinearFilter
from pytracking_tpu_torch.models.classifier.residual_modules import \
    GNSteepestDescentHinge as TGNSteepestDescentHinge
from pytracking_tpu_torch.models.lwl import decoder as t_decoder
from pytracking_tpu_torch.models.lwl import label_encoder as t_label_encoder
from pytracking_tpu_torch.models.lwl import linear_filter as t_linear_filter
from pytracking_tpu_torch.models.lwl import lwl_net as t_lwl_net
from pytracking_tpu_torch.models.lwl import sta_net as t_sta_net
from pytracking_tpu_torch.models.rts import rts_net as t_rts_net
from pytracking_tpu_torch.ops import patch as t_patch
from pytracking_tpu_torch.utils import convert_weights as cw

from test_torch_dimp_family_ops import _close, _filt, _nchw, _nhwc, _t, perturb_batch_stats

ATOL = 1e-5
D, K = 32, 4                     # tiny target-model width and filter channels
TINY_FT = {"layer1": 8, "layer2": 16, "layer3": 32, "layer4": 64}
LAYERS = ("layer4", "layer3", "layer2", "layer1")


def close(a, b):
    _close(a, b, atol=ATOL)


@pytest.fixture(autouse=True)
def one_thread():
    """PyTorch on one CPU thread for each test (restored after): the suite
    runs several workers per machine, where a full set of intra-op threads
    per worker makes these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _init_numpy(module, *args, seed=0):
    """Jitted `init`, variables as numpy with random BatchNorm statistics."""
    v = jax.jit(lambda k: module.init(k, *args))(jax.random.PRNGKey(seed))
    return perturb_batch_stats(jax.tree_util.tree_map(np.asarray, dict(v)), seed + 7)


def _apply(module, v, *args):
    return jax.jit(lambda v: module.apply(v, *args))(v)


def _enc(x):
    """The port's (N, S, K, h, w) -> the JAX layout (N, S, h, w, K)."""
    return np.moveaxis(x.detach().numpy(), 2, -1)


# ---------------------------------------------------------------- tiny nets

def _jax_backbone():
    from pytracking_tpu.models.backbones.resnet import ResNet
    from pytracking_tpu.models.classifier.features import ResidualBasicBlock

    return (ResNet(block="basic", layers=(1, 1, 1, 1),
                   output_layers=("layer1", "layer2", "layer3", "layer4"), base_width=8),
            ResidualBasicBlock(feature_dim=32, num_blocks=1, l2norm=True, final_conv=False,
                               norm_scale=math.sqrt(1 / (D * 9)), out_dim=D))


def _torch_backbone():
    return (t_resnet.ResNet(layers=(1, 1, 1, 1),
                            output_layers=("layer1", "layer2", "layer3", "layer4"),
                            base_width=8, block="basic"),
            t_features.ResidualBasicBlock(in_dim=32, out_dim=D,
                                          norm_scale=math.sqrt(1 / (D * 9)), feature_dim=32,
                                          num_blocks=1, final_conv=False))


def _torch_lwl_parts():
    backbone, tm_feat = _torch_backbone()
    return (backbone, t_linear_filter.LWLLinearFilter(3, K, D, 2, 0.01, tm_feat),
            t_decoder.LWTLDecoder(K, 8, TINY_FT),
            t_label_encoder.ResidualDS16SW((4, 8, 16, K), use_bn=True))


def _finish(variables, tnet, convert, seed):
    variables = perturb_batch_stats(jax.tree_util.tree_map(np.asarray, dict(variables)),
                                    seed + 7)
    tnet.eval().load_state_dict(convert(variables, tnet))
    return variables, tnet


@functools.lru_cache(maxsize=None)
def tiny_lwl_pair(seed=0):
    """(JAX LWTLNet of tests/test_lwl.py, its variables as numpy, the port's
    net with the same weights): a BasicBlock ResNet of one block per stage at
    width 8, a 32-channel target model with a 3x3 filter of 4 channels."""
    from test_lwl import tiny_lwl_net

    jnet = tiny_lwl_net()
    im, m = jnp.zeros((1, 1, 64, 64, 3)), jnp.zeros((1, 1, 64, 64))
    v = jax.jit(lambda k: jnet.init(k, im, im, m, num_refinement_iter=0, train=False))(
        jax.random.PRNGKey(seed))
    return (jnet,) + _finish(v, t_lwl_net.LWTLNet(*_torch_lwl_parts()), cw.lwtlnet_from_flax,
                             seed)


@functools.lru_cache(maxsize=None)
def tiny_boxnet_pair(seed=0):
    """The tiny LWL with the box label encoder of tests/test_lwl.py:180; the
    variables are the tiny LWL's and the box encoder's own init, merged as
    the JAX parameter module merges them."""
    from pytracking_tpu.models.lwl.label_encoder import ResidualDS16FeatSWBox
    from pytracking_tpu.models.lwl.lwl_net import LWTLBoxNet

    base, v_main, _ = tiny_lwl_pair(seed)
    box_enc = ResidualDS16FeatSWBox(layer_dims=(4, 8, 16, 16, K), use_bn=True)
    jnet = LWTLBoxNet(feature_extractor=base.feature_extractor, target_model=base.target_model,
                      decoder=base.decoder, label_encoder=base.label_encoder,
                      box_label_encoder=box_enc,
                      target_model_input_layer=base.target_model_input_layer,
                      decoder_input_layers=base.decoder_input_layers)
    v_box = jax.jit(lambda k: box_enc.init(k, jnp.zeros((1, 1, 4)), jnp.zeros((1, 1, 4, 4, D)),
                                           (64, 64)))(jax.random.PRNGKey(seed + 1))
    v = {c: {**v_main[c], "box_label_encoder": v_box[c]} for c in ("params", "batch_stats")}
    box_t = t_label_encoder.ResidualDS16FeatSWBox((4, 8, 16, 16, K), feat_dim=D, use_bn=True)
    return (jnet,) + _finish(v, t_lwl_net.LWTLBoxNet(*_torch_lwl_parts(),
                                                     box_label_encoder=box_t),
                             cw.lwtlboxnet_from_flax, seed)


@functools.lru_cache(maxsize=None)
def tiny_sta_pair(seed=0):
    """The tiny STANet of tests/test_lwl.py:100 (two target models sharing
    one feature block, a decoder over 2K channels)."""
    from pytracking_tpu.models.lwl.decoder import LWTLDecoder
    from pytracking_tpu.models.lwl.label_encoder import ResidualDS16FeatSWBox, ResidualDS16SW
    from pytracking_tpu.models.lwl.linear_filter import LWLLinearFilter
    from pytracking_tpu.models.lwl.sta_net import STANet

    backbone, tm_feat = _jax_backbone()

    def make_tm():
        return LWLLinearFilter(filter_size=3, num_filters=K, feature_dim=D, num_iter=2,
                               feature_extractor=tm_feat)

    jnet = STANet(feature_extractor=backbone, target_model=make_tm(),
                  target_model_segm=make_tm(),
                  decoder=LWTLDecoder(in_channels=2 * K, out_channels=8, ft_layers=LAYERS),
                  label_encoder=ResidualDS16FeatSWBox(layer_dims=(4, 8, 16, 16, K)),
                  bbox_encoder=ResidualDS16FeatSWBox(layer_dims=(4, 8, 16, 16, K)),
                  segm_encoder=ResidualDS16SW(layer_dims=(4, 8, 16, K)))
    v = jax.jit(lambda k: jnet.init(k, jnp.zeros((1, 1, 64, 64, 3)),
                                    jnp.array([[[16.0, 16.0, 24.0, 24.0]]]), train=False))(
        jax.random.PRNGKey(seed))
    tb, tm = _torch_backbone()
    tnet = t_sta_net.STANet(
        tb, t_linear_filter.LWLLinearFilter(3, K, D, 2, 0.01, tm),
        t_linear_filter.LWLLinearFilter(3, K, D, 2, 0.01, None),
        t_decoder.LWTLDecoder(2 * K, 8, TINY_FT),
        t_label_encoder.ResidualDS16FeatSWBox((4, 8, 16, 16, K), feat_dim=D),
        t_label_encoder.ResidualDS16FeatSWBox((4, 8, 16, 16, K), feat_dim=D),
        t_label_encoder.ResidualDS16SW((4, 8, 16, K)))
    return (jnet,) + _finish(v, tnet, cw.stanet_from_flax, seed)


HINGE_KW = dict(num_iter=2, feat_stride=16, hinge_threshold=0.05, activation_leak=0.1,
                score_act="relu", learn_filter_reg=False)


@functools.lru_cache(maxsize=None)
def tiny_rts_pair(seed=0):
    """The tiny RTSNet of tests/test_rts.py:9 with RTS-50's classification
    feature layout: a stride-2 final conv (classifier at /32, 2x2 on a 64x64
    crop, so the score encoding is resized up to the /16 grid)."""
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
                                             out_dim=D, final_stride=2))
    jnet = RTSNet(feature_extractor=backbone,
                  target_model=LWLLinearFilter(filter_size=3, num_filters=K, feature_dim=D,
                                               num_iter=2, feature_extractor=tm_feat),
                  decoder=LWTLDecoder(in_channels=K, out_channels=8, ft_layers=LAYERS),
                  label_encoder=ResidualDS16SW(layer_dims=(4, 8, 16, K)), classifier=classifier,
                  clf_encoder=ResidualDS16SWClf(layer_dims=(4, 8, 16, K)),
                  fusion_module=LearnersFusion(fusion_type="concat", out_channels=K))
    im, m = jnp.zeros((1, 1, 64, 64, 3)), jnp.zeros((1, 1, 64, 64))
    tb = jnp.array([[[20.0, 20.0, 24.0, 24.0]]])
    v = jax.jit(lambda k: jnet.init(k, im, im, m, tb, num_refinement_iter=0, train=False))(
        jax.random.PRNGKey(seed))
    tback, ttm = _torch_backbone()
    tclf = TLinearFilter(
        TFilterInitializerLinear(filter_size=4, feature_dim=D),
        TGNSteepestDescentHinge(**HINGE_KW),
        t_features.ResidualBottleneck(in_dim=32, out_dim=D, norm_scale=norm_scale,
                                      feature_dim=8, num_blocks=0, final_conv=True,
                                      final_stride=2))
    tnet = t_rts_net.RTSNet(tback, t_linear_filter.LWLLinearFilter(3, K, D, 2, 0.01, ttm),
                            t_decoder.LWTLDecoder(K, 8, TINY_FT),
                            t_label_encoder.ResidualDS16SW((4, 8, 16, K)), tclf,
                            t_rts_net.ResidualDS16SWClf((4, 8, 16, K)),
                            t_rts_net.LearnersFusion("concat", K, K))
    return (jnet,) + _finish(v, tnet, cw.rtsnet_from_flax, seed)


# ---------------------------------------------------------------- backbone

@pytest.mark.parametrize("stride,downsample", [(1, False), (2, True), (1, True)])
def test_stride_in_1x1_bottleneck_matches_jax(stride, downsample):
    from pytracking_tpu.models.backbones.resnet import Bottleneck

    inplanes = 16 if not downsample else 8
    x = np.random.RandomState(stride).randn(2, 9, 11, inplanes).astype(np.float32)
    jm = Bottleneck(4, stride=stride, downsample=downsample, stride_in_1x1=True)
    v = _init_numpy(jm, jnp.asarray(x))
    tm = t_resnet.Bottleneck(inplanes, 4, stride=stride, downsample=downsample,
                             stride_in_1x1=True).eval()
    tm.load_state_dict(cw._net_from_flax(v, tm))
    with torch.no_grad():
        out = tm(_nchw(x))
    close(_nhwc(out), _apply(jm, v, jnp.asarray(x)))


def test_mrcnn_resnet_and_bgr255_match_jax():
    from pytracking_tpu.models.backbones.resnet import ResNet, normalize_image_bgr255

    im = np.random.RandomState(0).rand(2, 32, 48, 3).astype(np.float32) * 255
    close(t_resnet.normalize_image_bgr255(_nchw(im)).numpy(),
          np.moveaxis(np.asarray(normalize_image_bgr255(jnp.asarray(im))), -1, 1))
    jm = ResNet(block="bottleneck", layers=(1, 1, 1, 1), base_width=8, stride_in_1x1=True,
                output_layers=("layer1", "layer2", "layer3", "layer4"))
    v = _init_numpy(jm, jnp.zeros((1, 32, 32, 3)))
    tm = t_resnet.ResNet(layers=(1, 1, 1, 1), base_width=8, stride_in_1x1=True,
                         output_layers=("layer1", "layer2", "layer3", "layer4")).eval()
    tm.load_state_dict(cw._net_from_flax(v, tm))
    ref = jax.jit(jm.apply)(v, normalize_image_bgr255(jnp.asarray(im)))
    with torch.no_grad():
        out = tm(t_resnet.normalize_image_bgr255(_nchw(im)))
    for k in ref:
        close(_nhwc(out[k]), ref[k])


# ---------------------------------------------------------------- mask crop

# (pos (y, x), sample size (y, x), output size): integer centres with an
# even sample on an output of the same size put every coordinate on a
# half-pixel tie, which rounds half to even
MASK_CASES = {
    "ties": ((20.0, 30.0), (8.0, 12.0), (8, 12)),
    "ties_odd_centre": ((21.0, 33.0), (6.0, 10.0), (6, 10)),
    "downscale": ((25.3, 31.7), (40.0, 52.0), (16, 20)),
    "outside_image": ((2.0, 70.0), (30.0, 30.0), (12, 12)),
}


@pytest.mark.parametrize("mode", ["replicate", "inside_major"])
@pytest.mark.parametrize("case", list(MASK_CASES))
def test_mask_crop_matches_jax(case, mode):
    from pytracking_tpu.ops.patch import sample_patch

    pos, sz, out_sz = MASK_CASES[case]
    rng = np.random.RandomState(1)
    mask = (rng.rand(48, 72) > 0.5).astype(np.float32) + np.arange(72, dtype=np.float32) / 100
    ref, ref_c = sample_patch(jnp.asarray(mask[..., None]), jnp.asarray(pos), jnp.asarray(sz),
                              out_sz, mode=mode, is_mask=True)
    got, got_c = t_patch.sample_patch(_t(mask[None]), _t(pos), _t(sz), out_sz, mode=mode,
                                      is_mask=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref)[..., 0])
    np.testing.assert_allclose(got_c.numpy(), ref_c, atol=1e-5, rtol=0)
    if case == "ties":       # the coordinates really are ties
        ys = pos[0] + ((np.arange(out_sz[0]) + 0.5) / out_sz[0] - 0.5) * sz[0]
        assert np.all(ys % 1 == 0.5)


def test_batched_crops_equal_single_crops():
    """pos (B, 2) crops each sample of its own image or of a shared one,
    as one crop per sample does."""
    rng = np.random.RandomState(2)
    ims = _t(rng.rand(2, 3, 40, 50) * 255)
    pos, sz = _t([[12.0, 20.0], [30.5, 7.0]]), _t([[30.0, 44.0], [60.0, 20.0]])
    for mode in ("replicate", "inside_major"):
        for is_mask in (False, True):
            both, coords = t_patch.sample_patch(ims, pos, sz, (10, 14), mode=mode,
                                                is_mask=is_mask)
            shared, _ = t_patch.sample_patch(ims[0], pos, sz, (10, 14), mode=mode,
                                             is_mask=is_mask)
            for i in range(2):
                one, c = t_patch.sample_patch(ims[i], pos[i], sz[i], (10, 14), mode=mode,
                                              is_mask=is_mask)
                torch.testing.assert_close(both[i], one, rtol=0, atol=1e-4)
                torch.testing.assert_close(coords[i], c, rtol=0, atol=0)
                if i == 0:
                    torch.testing.assert_close(shared[0], one, rtol=0, atol=1e-4)


# ---------------------------------------------------------------- decoder

@pytest.mark.parametrize("src,dst", [((30, 52), (15, 26)), ((7, 9), (4, 5)),
                                     ((15, 26), (30, 52)), ((3, 3), (4, 4)), ((1, 1), (6, 8))])
def test_interp_matches_jax_resize(src, dst):
    """Bilinear as `jax.image.resize`: antialiased when it shrinks (LWL's /16
    scores to layer4's /32 grid is the first case), plain when it grows."""
    from pytracking_tpu.models.lwl.decoder import _interp

    x = np.random.RandomState(3).randn(2, src[0], src[1], 5).astype(np.float32)
    ref = _interp(jnp.asarray(x), dst)
    close(_nhwc(t_decoder._interp(_nchw(x), dst)), ref)
    if dst[0] < src[0]:        # a plain bilinear resize misses the downsample
        plain = F.interpolate(_nchw(x), size=dst, mode="bilinear", align_corners=False)
        assert np.abs(_nhwc(plain) - np.asarray(ref)).max() > 0.1


@pytest.mark.parametrize("src,dst", [((8, 13), (16, 26)), ((16, 26), (64, 104)),
                                     ((5, 7), (20, 21))])
def test_bicubic_resize_matches_jax_and_torch(src, dst):
    """The decoder's bicubic (a = -0.75, borders clamped) against the JAX
    weights, and against F.interpolate(bicubic), which computes the same."""
    from pytracking_tpu.models.lwl.decoder import _bicubic_resize

    x = np.random.RandomState(4).randn(2, src[0], src[1], 3).astype(np.float32)
    got = t_decoder._bicubic_resize(_nchw(x), dst)
    close(_nhwc(got), _bicubic_resize(jnp.asarray(x), dst))
    ref = F.interpolate(_nchw(x), size=dst, mode="bicubic", align_corners=False)
    close(got.numpy(), ref.numpy())


def test_decoder_matches_jax():
    from pytracking_tpu.models.lwl.decoder import LWTLDecoder

    rng = np.random.RandomState(5)
    scores = rng.randn(2, 4, 6, K).astype(np.float32)
    feats = {L: rng.randn(2, 4 * 16 // s, 6 * 16 // s, c).astype(np.float32)
             for L, s, c in (("layer1", 4, 8), ("layer2", 8, 16), ("layer3", 16, 32),
                             ("layer4", 32, 64))}
    jm = LWTLDecoder(in_channels=K, out_channels=8, ft_layers=LAYERS)
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    v = _init_numpy(jm, jnp.asarray(scores), jf, (64, 96))
    tm = t_decoder.LWTLDecoder(K, 8, TINY_FT).eval()
    tm.load_state_dict(cw._net_from_flax(v, tm))
    ref, ref_levels = _apply(jm, v, jnp.asarray(scores), jf, (64, 96))
    with torch.no_grad():
        got, levels = tm(_nchw(scores), {k: _nchw(x) for k, x in feats.items()}, (64, 96))
    close(_nhwc(got), ref)
    for k in ref_levels:
        close(_nhwc(levels[k]), ref_levels[k])


# ---------------------------------------------------------------- label encoders

def test_bbox_to_gauss_matches_jax():
    from pytracking_tpu.models.lwl.label_encoder import bbox_to_gauss

    bb = np.array([[10.0, 20.0, 30.0, 12.0], [-5.0, 40.0, 2.0, 3.0], [50.3, 1.7, 0.5, 80.0]],
                  np.float32)
    close(t_label_encoder.bbox_to_gauss(_t(bb), (64, 96)).numpy()[:, 0],
          np.asarray(bbox_to_gauss(jnp.asarray(bb), (64, 96)))[..., 0])


@pytest.mark.parametrize("use_bn", [True, False])
def test_mask_label_encoder_matches_jax(use_bn):
    from pytracking_tpu.models.lwl.label_encoder import ResidualDS16SW

    mask = np.random.RandomState(6).rand(2, 3, 64, 96).astype(np.float32)
    jm = ResidualDS16SW(layer_dims=(4, 8, 16, K), use_bn=use_bn)
    v = _init_numpy(jm, jnp.asarray(mask))
    tm = t_label_encoder.ResidualDS16SW((4, 8, 16, K), use_bn=use_bn).eval()
    tm.load_state_dict(cw._net_from_flax(v, tm))
    ref = _apply(jm, v, jnp.asarray(mask))
    with torch.no_grad():
        got = tm(_t(mask))
    for a, b in zip(got, ref):
        assert a.shape == (2, 3, K, 4, 6)
        close(_enc(a), b)


@pytest.mark.parametrize("use_bn,final_bn", [(True, True), (False, True), (False, False)])
def test_box_label_encoder_matches_jax(use_bn, final_bn):
    from pytracking_tpu.models.lwl.label_encoder import ResidualDS16FeatSWBox

    rng = np.random.RandomState(7)
    bb = np.array([[[10.0, 12.0, 30.0, 20.0]], [[40.0, 5.0, 14.0, 50.0]]], np.float32)
    feat = rng.randn(2, 1, 4, 6, D).astype(np.float32)
    jm = ResidualDS16FeatSWBox(layer_dims=(4, 8, 16, 16, K), use_bn=use_bn, final_bn=final_bn)
    v = _init_numpy(jm, jnp.asarray(bb), jnp.asarray(feat), (64, 96))
    tm = t_label_encoder.ResidualDS16FeatSWBox((4, 8, 16, 16, K), feat_dim=D, use_bn=use_bn,
                                               final_bn=final_bn).eval()
    tm.load_state_dict(cw._net_from_flax(v, tm))
    ref = _apply(jm, v, jnp.asarray(bb), jnp.asarray(feat), (64, 96))
    with torch.no_grad():
        got = tm(_t(bb), _t(np.moveaxis(feat, -1, 2)), (64, 96))
    for a, b in zip(got, ref):
        close(_enc(a), b)


def test_sample_weight_head_starts_at_one():
    """Before weights are loaded the sample-weight head gives 1 everywhere,
    as the JAX initialiser (zero kernel, bias one) does."""
    with torch.no_grad():
        _, sw = t_label_encoder.ResidualDS16SW((4, 8, 16, K))(torch.rand(1, 1, 64, 64))
    assert torch.all(sw == 1.0)


# ---------------------------------------------------------------- target models

@pytest.mark.parametrize("weighted", [False, True])
def test_lwl_linear_filter_matches_jax(weighted):
    from pytracking_tpu.models.lwl.linear_filter import LWLLinearFilter

    rng = np.random.RandomState(8)
    N, S, h, w = 3, 2, 5, 7
    feat = rng.randn(N, S, h, w, D).astype(np.float32) * 0.1
    label = rng.randn(N, S, h, w, K).astype(np.float32)
    sw = (rng.rand(N, S, h, w, K).astype(np.float32) + 0.5) if weighted else None
    jm = LWLLinearFilter(filter_size=3, num_filters=K, feature_dim=D, num_iter=3)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(feat), jnp.asarray(feat),
                jnp.asarray(label), method=lambda m, a, b, c: m.get_filter(a, c))
    jsw = None if sw is None else jnp.asarray(sw)
    ref, _, _ = jm.apply(v, jnp.asarray(feat), jnp.asarray(label), jsw,
                         method=lambda m, a, b, c: m.get_filter(a, b, c))
    ref2, _, _ = jm.apply(v, ref, jnp.asarray(feat), jnp.asarray(label), jsw,
                          method=lambda m, f, a, b, c: m.update_filter(f, a, b, c, num_iter=2))
    tm = t_linear_filter.LWLLinearFilter(3, K, D, 3, 0.01).requires_grad_(False)
    tm.load_state_dict(cw._net_from_flax(jax.tree_util.tree_map(np.asarray, dict(v)), tm))
    tf, tl = _t(np.moveaxis(feat, -1, 2)), _t(np.moveaxis(label, -1, 2))
    tsw = None if sw is None else _t(np.moveaxis(sw, -1, 2))
    got = tm.get_filter(tf, tl, tsw)
    close(got.numpy().transpose(0, 3, 4, 2, 1), ref)
    got2 = tm.update_filter(got, tf, tl, tsw, num_iter=2)
    close(got2.numpy().transpose(0, 3, 4, 2, 1), ref2)
    ref_enc = jm.apply(v, ref2, jnp.asarray(feat),
                       method=lambda m, f, a: m.apply_target_model(f, a))
    close(_enc(tm.apply_target_model(got2, tf)), ref_enc)


@pytest.mark.parametrize("score_act", ["relu", "bentpar"])
@pytest.mark.parametrize("weighted", [False, True])
def test_hinge_optimizer_matches_jax(score_act, weighted):
    """Includes exact-zero scores: the first filter's taps are zero over
    part of the window (|x|'s derivative at 0 is JAX's +1)."""
    from pytracking_tpu.models.classifier.residual_modules import GNSteepestDescentHinge

    rng = np.random.RandomState(9)
    N, S, h, w = 5, 1, 2, 3
    feat = rng.randn(N, S, h, w, D).astype(np.float32) * 0.1
    w0 = rng.randn(S, 4, 4, D, 1).astype(np.float32) * 0.1
    w0[:, 2:] = 0.0                              # zero taps -> zero scores in row 0
    yy, xx = np.mgrid[:h + 1, :w + 1]
    label = np.broadcast_to(np.exp(-((yy - 1.3) ** 2 + (xx - 0.8) ** 2) / 0.3),
                            (N, S, h + 1, w + 1)).astype(np.float32)
    sw = (rng.rand(N, S).astype(np.float32) + 0.2) if weighted else None
    kw = dict(num_iter=3, feat_stride=16, hinge_threshold=0.05, activation_leak=0.1,
              score_act=score_act, act_param=0.5 if score_act == "bentpar" else None,
              learn_filter_reg=False)
    ref = GNSteepestDescentHinge(**kw).apply({}, jnp.asarray(w0), jnp.asarray(feat), None,
                                             jnp.asarray(label),
                                             None if sw is None else jnp.asarray(sw))[0]
    got = TGNSteepestDescentHinge(**kw)(_t(w0.transpose(0, 4, 3, 1, 2)),
                                        _t(np.moveaxis(feat, -1, 2)), None,
                                        train_label=_t(label),
                                        sample_weight=None if sw is None else _t(sw))
    close(got.numpy(), _filt(ref))


def test_stride2_classification_feature_matches_jax():
    from pytracking_tpu.models.classifier.features import ResidualBottleneck

    x = np.random.RandomState(10).randn(2, 7, 9, 32).astype(np.float32)
    jm = ResidualBottleneck(feature_dim=8, num_blocks=0, final_conv=True, out_dim=16,
                            norm_scale=0.3, final_stride=2)
    v = _init_numpy(jm, jnp.asarray(x))
    tm = t_features.ResidualBottleneck(in_dim=32, out_dim=16, norm_scale=0.3, feature_dim=8,
                                       num_blocks=0, final_conv=True, final_stride=2)
    tm.load_state_dict(cw._net_from_flax(v, tm))
    with torch.no_grad():
        got = tm(_nchw(x))
    assert got.shape == (2, 16, 4, 5)
    close(_nhwc(got), _apply(jm, v, jnp.asarray(x)))


# ---------------------------------------------------------------- RTS and STA

def test_score_encoder_and_fusion_match_jax():
    from pytracking_tpu.models.rts.rts_net import LearnersFusion, ResidualDS16SWClf

    rng = np.random.RandomState(11)
    score = rng.randn(1, 2, 5, 7).astype(np.float32)
    jm = ResidualDS16SWClf(layer_dims=(4, 8, 16, K))
    v = _init_numpy(jm, jnp.asarray(score))
    tm = t_rts_net.ResidualDS16SWClf((4, 8, 16, K)).eval()
    tm.load_state_dict(cw._net_from_flax(v, tm))
    ref = _apply(jm, v, jnp.asarray(score))
    with torch.no_grad():
        got = tm(_t(score))
    for a, b in zip(got, ref):
        close(_enc(a), b)
    seg, clf = rng.randn(2, 1, 2, 5, 7, K).astype(np.float32)
    for fusion in ("add", "concat"):
        jf = LearnersFusion(fusion_type=fusion, out_channels=K)
        vf = _init_numpy(jf, jnp.asarray(seg), jnp.asarray(clf))
        tf = t_rts_net.LearnersFusion(fusion, K, K)
        tf.load_state_dict(cw._net_from_flax(vf, tf))
        with torch.no_grad():
            got = tf(_t(np.moveaxis(seg, -1, 2)), _t(np.moveaxis(clf, -1, 2)))
        close(_enc(got), jf.apply(vf, jnp.asarray(seg), jnp.asarray(clf)))
