"""Parity of the PyTorch port's ToMP slice with the JAX package, on the CPU.

The same inputs (made from numpy seeds) and the same weights (the JAX
`net.init` converted with `tompnet_from_flax`) go through each JAX module
and its port. Float32 throughout, at the tiny ToMP of
tests/test_tomp_tracker.py (ResNet with one block per stage at width 16, d =
64, 4 heads, 2 + 2 transformer layers, a 6x6 feature grid from 96x96
samples). Feature maps are NHWC in JAX and NCHW in the port; the
comparisons transpose. The full-size nets are checked for keys and shapes
only, against `jax.eval_shape` of the JAX init.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytracking_tpu_torch.models.backbones import resnet as t_resnet
from pytracking_tpu_torch.models.classifier.features import \
    ResidualBottleneck as TResidualBottleneck
from pytracking_tpu_torch.models.tracking import tamosnet as t_tamosnet
from pytracking_tpu_torch.models.tracking import tompnet as t_tompnet
from pytracking_tpu_torch.models.transformer.filter_predictor import \
    FilterPredictor as TFilterPredictor
from pytracking_tpu_torch.models.transformer.heads import (
    DenseBoxRegressor as TDenseBoxRegressor, Head as THead,
    LinearFilterClassifier as TLinearFilterClassifier)
from pytracking_tpu_torch.models.transformer.transformer import \
    Transformer as TTransformer
from pytracking_tpu_torch.trackers import tomp as t_tomp
from pytracking_tpu_torch.utils.convert_weights import tompnet_from_flax
from pytracking_tpu_torch.utils.loading import round_to_bf16_
from tests.test_dimp_tracker import make_frame
from tests.test_torch_tamos import (_bf16_ulp, _close, _gate_stats, _nchw, _nhwc,
                                    _perturb_batch_stats, _t)

D_MODEL = 64
FEAT = 6
SAMPLE = FEAT * 16


def jax_tiny_tompnet(dtype=None):
    """tests/test_tomp_tracker.tiny_tompnet with a compute dtype for the
    backbone and the transformer."""
    from pytracking_tpu.models.backbones.resnet import ResNet
    from pytracking_tpu.models.classifier.features import ResidualBottleneck
    from pytracking_tpu.models.tracking.tompnet import ToMPnet
    from pytracking_tpu.models.transformer.filter_predictor import FilterPredictor
    from pytracking_tpu.models.transformer.heads import (DenseBoxRegressor, Head,
                                                         LinearFilterClassifier)
    from pytracking_tpu.models.transformer.transformer import Transformer

    d = D_MODEL
    backbone = ResNet(block="bottleneck", layers=(1, 1, 1, 1), output_layers=("layer3",),
                      base_width=16, dtype=dtype)
    head_fe = ResidualBottleneck(feature_dim=32, num_blocks=0, l2norm=True, final_conv=True,
                                 norm_scale=math.sqrt(1.0 / d), out_dim=d)
    transformer = Transformer(d_model=d, nhead=4, num_encoder_layers=2, num_decoder_layers=2,
                              dim_feedforward=128, dtype=dtype)
    fp = FilterPredictor(transformer, feature_sz=FEAT)
    head = Head(filter_predictor=fp, feature_extractor=head_fe,
                classifier=LinearFilterClassifier(num_channels=d),
                bb_regressor=DenseBoxRegressor(num_channels=d))
    return ToMPnet(feature_extractor=backbone, head=head, head_layer="layer3")


def torch_tiny_tompnet(dtype=None):
    d = D_MODEL
    backbone = t_resnet.ResNet(layers=(1, 1, 1, 1), output_layers=("layer3",),
                               base_width=16, dtype=dtype)
    head_fe = TResidualBottleneck(in_dim=256, out_dim=d, norm_scale=math.sqrt(1.0 / d))
    transformer = TTransformer(d_model=d, nhead=4, num_encoder_layers=2, num_decoder_layers=2,
                               dim_feedforward=128, dtype=dtype)
    head = THead(filter_predictor=TFilterPredictor(transformer, feature_sz=FEAT),
                 feature_extractor=head_fe, classifier=TLinearFilterClassifier(d),
                 bb_regressor=TDenseBoxRegressor(d))
    return t_tompnet.ToMPnet(feature_extractor=backbone, head=head).eval()


def _init_inputs(s=SAMPLE, f=FEAT):
    return (jnp.zeros((1, 1, s, s, 3)), jnp.zeros((1, 1, s, s, 3)), jnp.zeros((1, 1, f, f)),
            jnp.zeros((1, 1, f, f, 4)))


@pytest.fixture(scope="module")
def nets():
    """(jax net, flax variables as numpy, torch net with the same weights).
    The box regressor's last layer is damped so that the random net's boxes
    stay inside the frame (exp of its raw output covers the whole image)."""
    jnet = jax_tiny_tompnet()
    init = jax.jit(lambda key, *a: jnet.init(key, *a, train=False))
    variables = init(jax.random.PRNGKey(0), *_init_inputs())
    variables = copy.deepcopy(_perturb_batch_stats(
        jax.tree_util.tree_map(np.asarray, dict(variables)), seed=7))
    variables["params"] = jax.tree_util.tree_map(np.array, variables["params"])
    bbreg = variables["params"]["head"]["bb_regressor"]["bbreg_layer"]
    bbreg["kernel"] = bbreg["kernel"] * 0.05
    bbreg["bias"] = (bbreg["bias"] + np.log(0.15)).astype(np.float32)
    tnet = torch_tiny_tompnet()
    tnet.load_state_dict(tompnet_from_flax(variables, tnet))
    return jnet, variables, tnet


def _apply(jnet, variables, fn, *args):
    return jnet.apply(variables, *args, method=fn)


def _predictor_inputs(seed, Nf=2):
    rng = np.random.RandomState(seed)
    train_feat = rng.randn(Nf, 1, FEAT, FEAT, D_MODEL).astype(np.float32)
    test_feat = rng.randn(1, 1, FEAT, FEAT, D_MODEL).astype(np.float32)
    label = rng.rand(Nf, 1, FEAT, FEAT).astype(np.float32)
    ltrb = rng.rand(Nf, 1, FEAT, FEAT, 4).astype(np.float32)
    return train_feat, test_feat, label, ltrb


# ---------------------------------------------------------------- modules

def test_backbone_and_head_feature_match_jax(nets):
    jnet, variables, tnet = nets
    im = np.random.RandomState(3).rand(2, SAMPLE, SAMPLE, 3).astype(np.float32) * 255
    ref = _apply(jnet, variables, lambda m, x: m.extract_backbone(x), jnp.asarray(im))
    got = tnet.extract_backbone(_nchw(im))
    assert set(got) == {"layer3"}
    _close(_nhwc(got["layer3"]), ref["layer3"])
    href = _apply(jnet, variables, lambda m, f: m.extract_head_feat(f), ref)
    _close(_nhwc(tnet.extract_head_feat(got)), href)


def test_predict_filter_matches_jax(nets):
    jnet, variables, tnet = nets
    train_feat, test_feat, label, ltrb = _predictor_inputs(6)
    filt_ref, enc_ref = _apply(
        jnet, variables, lambda m, a, b, c, d: m.head.filter_predictor.predict_filter(a, b, c, d),
        *(jnp.asarray(x) for x in (train_feat, test_feat, label, ltrb)))
    filt, enc = tnet.head.filter_predictor.predict_filter(_nchw(train_feat), _nchw(test_feat),
                                                          _t(label), _t(ltrb))
    _close(filt.detach().numpy(), np.asarray(filt_ref).reshape(1, D_MODEL))
    _close(_nhwc(enc), enc_ref)


@pytest.mark.parametrize("cls_mask,bb_mask", [
    ((True, True), (True, False)),      # both slots stored; bbreg sees the first frame
    ((True, False), (True, False)),     # slot 1 empty
    (None, None),
], ids=["slot1_stored", "slot1_empty", "no_masks"])
def test_parallel_filters_match_jax(nets, cls_mask, bb_mask):
    jnet, variables, tnet = nets
    train_feat, test_feat, label, ltrb = _predictor_inputs(7)
    jm = [None if m is None else jnp.asarray(m) for m in (cls_mask, bb_mask)]
    tm = [None if m is None else torch.tensor(m) for m in (cls_mask, bb_mask)]
    refs = _apply(jnet, variables,
                  lambda m, a, b, c, d: m.head_get_filters_parallel(a, b, c, d, *jm),
                  *(jnp.asarray(x) for x in (train_feat, test_feat, label, ltrb)))
    got = tnet.head_get_filters_parallel(_nchw(train_feat), _nchw(test_feat), _t(label),
                                         _t(ltrb), *tm)
    for g, r in zip(got[:2], refs[:2]):
        _close(g.detach().numpy(), np.asarray(r).reshape(1, D_MODEL))
    for g, r in zip(got[2:], refs[2:]):
        _close(_nhwc(g), r)
    differ = not np.allclose(got[0].detach().numpy(), got[1].detach().numpy(), atol=1e-3)
    assert differ == (cls_mask == (True, True))       # the copies saw different memories


def test_head_classifier_and_regressor_match_jax(nets):
    jnet, variables, tnet = nets
    rng = np.random.RandomState(8)
    feat = rng.randn(2, 1, FEAT, FEAT, D_MODEL).astype(np.float32)
    filt = rng.randn(1, D_MODEL).astype(np.float32)
    jf = jnp.asarray(filt.reshape(1, 1, 1, D_MODEL, 1))
    s_ref = _apply(jnet, variables, lambda m, f, w: m.head_classify(f, w), jnp.asarray(feat), jf)
    b_ref = _apply(jnet, variables, lambda m, f, w: m.head_bbreg(f, w), jnp.asarray(feat), jf)
    s = tnet.head_classify(_nchw(feat), _t(filt))                      # (2, 1, H, W)
    b = tnet.head_bbreg(_nchw(feat), _t(filt))                         # (2, 1, 4, H, W)
    _close(s.detach().numpy(), np.asarray(s_ref)[..., 0])
    _close(b.detach().numpy().transpose(0, 1, 3, 4, 2), b_ref, rtol=1e-4)


def test_tompnet_forward_matches_jax(nets):
    jnet, variables, tnet = nets
    rng = np.random.RandomState(10)
    tr = rng.rand(2, 1, SAMPLE, SAMPLE, 3).astype(np.float32) * 255
    te = rng.rand(1, 1, SAMPLE, SAMPLE, 3).astype(np.float32) * 255
    lab = rng.rand(2, 1, FEAT, FEAT).astype(np.float32)
    ltrb = rng.rand(2, 1, FEAT, FEAT, 4).astype(np.float32)
    s_ref, b_ref = jnet.apply(variables, *(jnp.asarray(x) for x in (tr, te, lab, ltrb)),
                              train=False)
    with torch.inference_mode():
        s, b = tnet(_nchw(tr), _nchw(te), _t(lab), _t(ltrb))
    _close(s.numpy(), np.asarray(s_ref)[..., 0], atol=1e-4 * np.abs(s_ref).max())
    _close(b.numpy().transpose(0, 1, 3, 4, 2), b_ref, rtol=1e-4)


def test_converter_uses_every_leaf_and_key(nets):
    jnet, variables, tnet = nets
    sd = tompnet_from_flax(variables, tnet)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    n_stacked = sum(np.asarray(x).shape[0] - 1 for p, x in
                    jax.tree_util.tree_flatten_with_path(variables)[0]
                    if "layer" in [getattr(k, "key", None) for k in p])
    assert len(sd) == n_leaves + n_stacked == len(tnet.state_dict())
    assert "head.filter_predictor.query_embed_test" in sd
    broken = copy.deepcopy(variables)
    broken["params"]["head"]["extra"] = {"kernel": np.zeros((2, 2))}
    with pytest.raises(KeyError):
        tompnet_from_flax(broken, tnet)
    smaller = copy.deepcopy(variables)
    del smaller["params"]["head"]["filter_predictor"]["query_embed_test"]
    with pytest.raises(KeyError):
        tompnet_from_flax(smaller, tnet)


def _eval_shape_variables(jax_net, *inputs):
    """The JAX net's init variables as zero numpy arrays of their shapes
    (traced, not computed)."""
    shapes = jax.eval_shape(lambda: jax_net.init(jax.random.PRNGKey(0), *inputs, train=False))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)


@pytest.mark.parametrize("name", ["tompnet50", "tompnet101"])
def test_full_size_keys_and_shapes_match_jax(name, monkeypatch):
    """The full-size nets (ResNet-50/101, d = 512, 8 heads, 6 + 6 layers):
    every converted flax leaf lands on a port key of the same shape, and
    every port key has one. The port net is built on the meta device."""
    from pytracking_tpu.models.tracking import tompnet as j_tompnet

    s, f = 288, 18
    variables = _eval_shape_variables(getattr(j_tompnet, name)(), *_init_inputs(s, f))
    monkeypatch.setattr(t_tompnet, "init_weights", lambda net, generator: net)
    with torch.device("meta"):
        net = getattr(t_tompnet, name)(device="meta")
    n_blocks = sum(1 for k in net.state_dict() if k.startswith("feature_extractor.layer3_")
                   and k.endswith(".conv1.weight"))
    assert n_blocks == {"tompnet50": 6, "tompnet101": 23}[name]
    tompnet_from_flax(variables, net)


# ---------------------------------------------------------------- tracker

# The seeded tiny net's score peaks on this sequence (JAX tracker, these
# thresholds): 11.46-11.95 on frames 1-4 (uncertain, hard negative stored in
# slot 1, uncertain, hard negative replacing slot 1), 9.855-9.894 on frames
# 5-9 (not_found: the search area is rescaled from the scale history), 9.910
# on frame 10 (hard negative, stored). The module's 0.25 and 0.9 would make
# every frame found and stored.
TRACE_PARAMS = dict(train_feature_size=FEAT, target_not_found_threshold=9.9, conf_ths=9.0)
TRACE_FLAGS = ["uncertain", "hard_negative"] * 2 + ["not_found"] * 5 + ["hard_negative"]


def _trace_frames(n=11):
    centers = [(60 + 3 * t, 60 + 2 * t) for t in range(n)]
    return ([make_frame(*c) for c in centers],
            {"init_bbox": [centers[0][1] - 10, centers[0][0] - 10, 20, 20]})


def _compare_state(ts, js):
    np.testing.assert_array_equal(int(ts.flag), int(js.flag))
    for name in ("num_stored", "prev_ind", "not_found_counter", "scale_hist_len"):
        assert int(getattr(ts, name)) == int(getattr(js, name)), name
    _close(ts.mem_weights.numpy(), js.mem_weights, atol=1e-6)
    _close(ts.mem_boxes.numpy(), js.mem_boxes, atol=1e-3)
    _close(ts.mem_labels.numpy(), js.mem_labels, atol=1e-5)
    _close(_nhwc(ts.mem_samples), js.mem_samples)
    _close(ts.scale_history.numpy(), js.scale_history, rtol=1e-5)
    _close(ts.target_scale.numpy(), js.target_scale, rtol=1e-5)


def test_tracker_trace_matches_jax(nets, monkeypatch):
    """initialize + 10 frames against the JAX tracker, which runs without
    shape buckets so that both read the same image ('inside_major' crops
    use the image's size). The trace stores a hard negative in slot 1,
    replaces it, and rescales the search area over five not_found frames."""
    from pytracking_tpu.trackers.tomp import ToMPParams, ToMPTracker

    monkeypatch.setenv("PYTRACKING_TPU_SHAPE_BUCKETS", "0")
    jnet, variables, tnet = nets
    jtr = ToMPTracker(ToMPParams(**TRACE_PARAMS), jnet, variables)
    ttr = t_tomp.ToMPTracker(t_tomp.ToMPParams(**TRACE_PARAMS), tnet, device="cpu")
    jtr.enable_debug_outputs()
    ttr.enable_debug_outputs()
    frames, info = _trace_frames()
    jtr.initialize(frames[0], info)
    ttr.initialize(frames[0], info)
    _compare_state(ttr.state, jtr.state)
    flags = []
    for im in frames[1:]:
        jo = jtr.track(im)
        to = ttr.track(im)
        assert to["flag"] == jo["flag"]
        _close(to["target_bbox"], jo["target_bbox"], atol=1e-3)
        _close(to["max_score"], jo["max_score"], atol=1e-4 * abs(jo["max_score"]))
        _close(to["score_map"], jo["score_map"], atol=1e-4 * np.abs(jo["score_map"]).max())
        _compare_state(ttr.state, jtr.state)
        flags.append(to["flag"])
    assert flags == TRACE_FLAGS, flags
    assert int(ttr.state.prev_ind) == 1 and int(ttr.state.num_stored) == 2


def test_output_not_found_box():
    """The port reads `output_not_found_box` where the JAX tracker's
    fetch_output does: a not_found frame then reports [-1, -1, -1, -1]."""
    net = torch_tiny_tompnet()
    t_tamosnet.init_weights(net, torch.Generator().manual_seed(0))

    class Params(t_tomp.ToMPParams):
        output_not_found_box = True

    params = Params(train_feature_size=FEAT, target_not_found_threshold=math.inf)
    tracker = t_tomp.ToMPTracker(params, net, device="cpu")
    frames, info = _trace_frames(2)
    tracker.initialize(frames[0], info)
    out = tracker.track(frames[1])
    assert out["flag"] == "not_found" and out["target_bbox"] == [-1, -1, -1, -1]
    assert "score_map" not in out


# ---------------------------------------------------------------- bf16

@pytest.fixture(scope="module")
def bf16_nets(nets):
    """(JAX bf16 net, its maybe_bf16_variables-rounded variables, the port's
    bf16 twin with round_to_bf16_)."""
    from pytracking_tpu.utils.loading import maybe_bf16_variables

    _, variables, tnet = nets
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTRACKING_TPU_BF16", "1")
        v16 = maybe_bf16_variables(variables)
    net16 = torch_tiny_tompnet(dtype=torch.bfloat16)
    net16.load_state_dict(tnet.state_dict())
    round_to_bf16_(net16)
    return jax_tiny_tompnet(dtype=jnp.bfloat16), v16, net16


def test_round_to_bf16_matches_maybe_bf16_variables(nets, bf16_nets):
    _, v16, net16 = bf16_nets
    sd = tompnet_from_flax(jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), v16),
                           net16)
    for k, v in net16.state_dict().items():
        assert torch.equal(v, sd[k]), k


def _within_one_rounding(got, ref, name):
    """bf16 recipe check: where both sides round alike they agree to float32
    rounding; a bf16 rounding that falls the other way moves an element by
    one bf16 ulp. So at most 2% of the elements differ by more than 1e-5 of
    the output's scale, and none by more than one bf16 ulp."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    tol = 1e-5 * np.abs(ref).max()
    assert np.mean(np.abs(got - ref) > tol) <= 0.02, name
    assert np.abs(got - ref).max() <= _bf16_ulp(ref), name


def test_bf16_backbone_blocks_match_jax_bf16(bf16_nets):
    """Each bf16 ResNet block of the port (bf16 convolutions, BatchNorm in
    bf16 arithmetic on the bf16-stored statistics, as flax computes it)
    against the JAX bf16 block on the JAX block's own input. Over the whole
    backbone the one-ulp differences compound, so the blocks are held one
    by one."""
    j16, v16, t16 = bf16_nets
    im = np.random.RandomState(12).rand(2, SAMPLE, SAMPLE, 3).astype(np.float32) * 255
    _, inter = j16.apply(v16, jnp.asarray(im), method=lambda m, x: m.extract_backbone(x),
                         capture_intermediates=True, mutable=["intermediates"])
    blocks = inter["intermediates"]["feature_extractor"]
    for prev, name in (("layer1_0", "layer2_0"), ("layer2_0", "layer3_0")):
        x = torch.from_numpy(np.asarray(blocks[prev]["__call__"][0], np.float32))
        with torch.inference_mode():
            got = getattr(t16.feature_extractor, name)(x.permute(0, 3, 1, 2).to(torch.bfloat16))
        _within_one_rounding(_nhwc(got.float()), blocks[name]["__call__"][0], name)


def test_bf16_transformer_layers_match_jax_bf16(bf16_nets):
    """The first encoder and decoder layers of the bf16 transformer (bf16
    projections, attention and feed-forward; float32 softmax, LayerNorm and
    residuals) against the JAX bf16 layers with the same weights."""
    from pytracking_tpu.models.transformer.transformer import (TransformerDecoderLayer,
                                                               TransformerEncoderLayer)

    j16, v16, t16 = bf16_nets
    rng = np.random.RandomState(13)
    L = 3 * FEAT * FEAT
    src, pos = (rng.randn(2, L, D_MODEL).astype(np.float32) for _ in range(2))
    tgt, qpos = (rng.randn(2, 1, D_MODEL).astype(np.float32) for _ in range(2))
    pad = np.zeros((2, L), bool)
    pad[1, :L // 3] = True
    tv = v16["params"]["head"]["filter_predictor"]["transformer"]
    first = {k: jax.tree_util.tree_map(lambda a: a[0], tv[k]["layer"])
             for k in ("encoder", "decoder")}
    args = dict(d_model=D_MODEL, nhead=4, dim_feedforward=128, dtype=jnp.bfloat16)
    enc_ref = TransformerEncoderLayer(**args).apply(
        {"params": first["encoder"]}, jnp.asarray(src), jnp.asarray(pos), jnp.asarray(pad))
    dec_ref = TransformerDecoderLayer(**args).apply(
        {"params": first["decoder"]}, jnp.asarray(tgt), jnp.asarray(src), jnp.asarray(pos),
        jnp.asarray(qpos), jnp.asarray(pad))
    tr = t16.head.filter_predictor.transformer
    with torch.inference_mode():
        enc = tr.encoder[0](_t(src), _t(pos), torch.from_numpy(pad))
        dec = tr.decoder[0](_t(tgt), _t(src), _t(pos), _t(qpos), torch.from_numpy(pad))
    _within_one_rounding(enc.float().numpy(), enc_ref, "encoder layer")
    _within_one_rounding(dec.float().numpy(), dec_ref, "decoder layer")


def test_bf16_forward_matches_jax_bf16(nets, bf16_nets):
    """The whole bf16 ToMPnet forward, port against JAX, by the bf16 gate's
    statistics (corr > 0.98, max-score rel diff < 0.05, peak displacement
    <= 2, median LTRB rel err < 0.05) at tighter limits: the max score 2x,
    the rest 5-20x. bf16 rounding moves the raw peak score of this net by
    0.1-1.3% (JAX's own bf16 against its float32 on these inputs), so the
    score limit stays above that."""
    j16, v16, t16 = bf16_nets
    rng = np.random.RandomState(12)
    tr = rng.rand(2, 1, SAMPLE, SAMPLE, 3).astype(np.float32) * 255
    te = rng.rand(1, 1, SAMPLE, SAMPLE, 3).astype(np.float32) * 255
    lab = rng.rand(2, 1, FEAT, FEAT).astype(np.float32)
    ltrb = rng.rand(2, 1, FEAT, FEAT, 4).astype(np.float32)
    s_ref, b_ref = j16.apply(v16, *(jnp.asarray(x) for x in (tr, te, lab, ltrb)), train=False)
    with torch.inference_mode():
        s, b = t16(_nchw(tr), _nchw(te), _t(lab), _t(ltrb))
    corr, max_rel, disp, ltrb_err = _gate_stats(
        np.asarray(s_ref, np.float64)[:, :, None, :, :, 0], s.double().numpy()[:, :, None],
        np.asarray(b_ref, np.float64).transpose(0, 1, 4, 2, 3)[:, :, None],
        b.double().numpy()[:, :, None])
    assert corr > 0.999 and max_rel < 0.025 and disp == 0 and ltrb_err < 0.01, \
        (corr, max_rel, disp, ltrb_err)
