"""Parity of the port's Swin backbone and TaMOs-SwinBase with the JAX
package, on the CPU.

A small Swin (embed 32, depths (2, 2, 2, 2), heads (2, 4, 8, 16), window 7)
on inputs whose stage sizes are not multiples of 7, so that every stage pads
its input and every shifted block masks the wrapped regions; odd sizes
also make the patch merging crop. Then a tiny TaMOs on that Swin (d = 64,
2 heads: head dim 32, and 8x12 tokens per frame, so the encoder's L = 288
goes through the fused attention's plain version on the CPU) through the
forward and the tracker. Weights: the JAX `net.init` converted with
`tamosnet_from_flax`. The full-size TaMOs-SwinBase is checked for keys and
shapes against `jax.eval_shape` of the JAX init.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytracking_tpu_torch.models.backbones import swin as t_swin
from pytracking_tpu_torch.models.classifier.features import \
    ResidualBottleneck as TResidualBottleneck
from pytracking_tpu_torch.models.tracking import tamosnet as t_tamosnet
from pytracking_tpu_torch.models.transformer.got_filter_predictor import \
    GOTFilterPredictor as TGOT
from pytracking_tpu_torch.models.transformer.heads import (
    DenseBoxRegressor as TDenseBoxRegressor, LinearFilterClassifier as TLinearFilterClassifier)
from pytracking_tpu_torch.models.transformer.transformer import \
    Transformer as TTransformer
from pytracking_tpu_torch.ops import fused_mha
from pytracking_tpu_torch.trackers import tamos as t_tamos
from pytracking_tpu_torch.utils.convert_weights import tamosnet_from_flax
from tests.test_torch_tamos import _close, _frame, _nchw, _nhwc, _t, _values

SWIN = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16))
STAGES = ("stage1", "stage2", "stage3", "stage4")
IMAGE = (100, 132)      # stages 25x33, 12x16, 6x8, 3x4: none a multiple of 7
K = 3
FEAT = (8, 12)
D_MODEL = 64


def _scale_close(got, ref, rel=1e-4):
    ref = np.asarray(ref, np.float64)
    _close(got, ref, atol=rel * np.abs(ref).max())


@pytest.fixture(scope="module")
def swin_pair():
    """(JAX Swin with every stage out, its variables, the port's twin)."""
    from pytracking_tpu.models.backbones.swin import SwinTransformer

    jnet = SwinTransformer(output_layers=STAGES, **SWIN)
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.zeros((1,) + IMAGE + (3,)))))
    # the init's zero biases and unit norms would hide a swapped leaf
    rng = np.random.RandomState(4)
    variables = jax.tree_util.tree_map(
        lambda x: (x + 0.1 * rng.randn(*x.shape)).astype(np.float32), variables)
    tnet = t_swin.SwinTransformer(output_layers=STAGES, **SWIN).eval()
    sd = tamosnet_from_flax(variables, tnet)
    tnet.load_state_dict(sd)
    return jnet, variables, tnet


def test_rel_pos_index_and_shift_mask_match_jax():
    from pytracking_tpu.models.backbones import swin as j_swin

    np.testing.assert_array_equal(t_swin._rel_pos_index(7), j_swin._rel_pos_index(7))
    H, W, ws = 14, 21, 7
    img_mask = np.zeros((1, H, W, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -3), slice(-3, None)):
        for wsl in (slice(0, -ws), slice(-ws, -3), slice(-3, None)):
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mw = np.asarray(j_swin._window_partition(jnp.asarray(img_mask), ws))[..., 0]
    ref = np.where(mw[:, None, :] != mw[:, :, None], -100.0, 0.0)
    got = t_swin.shift_mask(H, W, ws, torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got is t_swin.shift_mask(H, W, ws, torch.device("cpu"))     # built once


def test_swin_stages_match_jax(swin_pair):
    jnet, variables, tnet = swin_pair
    x = np.random.RandomState(5).randn(2, *IMAGE, 3).astype(np.float32)
    ref = jax.jit(jnet.apply)(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = tnet(_nchw(x))
    assert list(got) == list(STAGES)
    for name in STAGES:
        assert got[name].is_contiguous()
        _scale_close(_nhwc(got[name]), ref[name])


def test_swin_stops_after_last_output_stage(swin_pair):
    """With output_layers up to stage3, stage 4 and the last merge are built
    (their weights are the model's) but never run."""
    jnet, variables, tnet = swin_pair
    net = t_swin.SwinTransformer(output_layers=("stage2", "stage3"), **SWIN).eval()
    net.load_state_dict(tnet.state_dict())

    def never(*args):
        raise AssertionError("stage 4 ran")

    net.stage4_block0.forward = net.merge_norm3.forward = never
    x = np.random.RandomState(6).randn(1, *IMAGE, 3).astype(np.float32)
    ref = jax.jit(jnet.apply)(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = net(_nchw(x))
    assert list(got) == ["stage2", "stage3"]
    for name in got:
        _scale_close(_nhwc(got[name]), ref[name])


# ---------------------------------------------------------------- TaMOs-Swin

def jax_tiny_tamos_swin():
    from pytracking_tpu.models.backbones.swin import SwinTransformer
    from pytracking_tpu.models.classifier.features import ResidualBottleneck
    from pytracking_tpu.models.tracking.tamosnet import FPN, TaMOsNet
    from pytracking_tpu.models.transformer.got_filter_predictor import GOTFilterPredictor
    from pytracking_tpu.models.transformer.heads import (DenseBoxRegressor,
                                                         LinearFilterClassifier)
    from pytracking_tpu.models.transformer.transformer import Transformer

    d = D_MODEL
    head_fe = ResidualBottleneck(feature_dim=32, num_blocks=0, l2norm=True, final_conv=True,
                                 norm_scale=(1 / d) ** 0.5, out_dim=d)
    transformer = Transformer(d_model=d, nhead=2, num_encoder_layers=2, num_decoder_layers=2,
                              dim_feedforward=64)
    fp = GOTFilterPredictor(transformer, feature_sz=max(FEAT), num_tokens=K,
                            box_enc="ltrb_token")
    return TaMOsNet(feature_extractor=SwinTransformer(output_layers=("stage2", "stage3"),
                                                      **SWIN),
                    head_feature_extractor=head_fe, filter_predictor=fp,
                    classifier=LinearFilterClassifier(num_channels=d),
                    bb_regressor=DenseBoxRegressor(num_channels=d), fpn=FPN(output_dim=d),
                    head_layer="stage3", high_res_layer="stage2")


def torch_tiny_tamos_swin():
    d = D_MODEL
    transformer = TTransformer(d_model=d, nhead=2, num_encoder_layers=2, num_decoder_layers=2,
                               dim_feedforward=64)
    return t_tamosnet.TaMOsNet(
        feature_extractor=t_swin.SwinTransformer(output_layers=("stage2", "stage3"), **SWIN),
        head_feature_extractor=TResidualBottleneck(in_dim=128, out_dim=d,
                                                   norm_scale=(1 / d) ** 0.5, feature_dim=32),
        filter_predictor=TGOT(transformer, feature_sz=max(FEAT), num_tokens=K,
                              box_enc="ltrb_token"),
        classifier=TLinearFilterClassifier(d), bb_regressor=TDenseBoxRegressor(d),
        fpn=t_tamosnet.FPN(d, 64, d), head_layer="stage3", high_res_layer="stage2").eval()


def _tamos_init_inputs(hw, feat, k):
    Hs, Ws = hw
    return (jnp.zeros((1, 1, Hs, Ws, 3)), jnp.zeros((1, 1, Hs, Ws, 3)),
            jnp.zeros((1, 1, k) + tuple(feat)), jnp.zeros((1, 1, k) + tuple(feat) + (4,)))


@pytest.fixture(scope="module")
def tamos_pair():
    jnet = jax_tiny_tamos_swin()
    Hs, Ws = FEAT[0] * 16, FEAT[1] * 16
    init = jax.jit(lambda key, *a: jnet.init(key, *a, train=False))
    variables = jax.tree_util.tree_map(np.asarray, dict(init(
        jax.random.PRNGKey(0), *_tamos_init_inputs((Hs, Ws), FEAT, K))))
    tnet = torch_tiny_tamos_swin()
    tnet.load_state_dict(tamosnet_from_flax(variables, tnet))
    return jnet, variables, tnet


def test_tamos_swin_forward_matches_jax(tamos_pair, monkeypatch):
    jnet, variables, tnet = tamos_pair
    calls = []
    fsa = fused_mha.fused_self_attention
    monkeypatch.setattr("pytracking_tpu_torch.models.transformer.transformer."
                        "fused_self_attention", lambda *a, **k: calls.append(1) or fsa(*a, **k))
    rng = np.random.RandomState(10)
    Hs, Ws = FEAT[0] * 16, FEAT[1] * 16
    tr = rng.rand(2, 1, Hs, Ws, 3).astype(np.float32) * 255
    te = rng.rand(1, 1, Hs, Ws, 3).astype(np.float32) * 255
    lab = rng.rand(2, 1, K, *FEAT).astype(np.float32)
    ltrb = rng.rand(2, 1, K, *FEAT, 4).astype(np.float32)
    s_ref, b_ref = jax.jit(lambda v, *a: jnet.apply(v, *a, train=False))(
        variables, *(jnp.asarray(x) for x in (tr, te, lab, ltrb)))
    with torch.inference_mode():
        s, b = tnet(_nchw(tr), _nchw(te), _t(lab), _t(ltrb))
    _scale_close(s.numpy().transpose(0, 1, 3, 4, 2), s_ref)
    _close(b.numpy().transpose(0, 1, 4, 5, 2, 3), b_ref, rtol=1e-4)
    assert len(calls) == 2             # the two encoder layers, L = 3 x 8 x 12 = 288


def test_tamos_swin_converter_uses_every_leaf_and_key(tamos_pair):
    _, variables, tnet = tamos_pair
    sd = tamosnet_from_flax(variables, tnet)
    assert len(sd) == len(tnet.state_dict())
    assert "feature_extractor.stage1_block1.attn.rel_pos_bias" in sd
    broken = copy.deepcopy(variables)
    broken["params"]["feature_extractor"]["stage1_block0"]["attn"]["extra"] = np.zeros(3)
    with pytest.raises(KeyError):
        tamosnet_from_flax(broken, tnet)
    smaller = copy.deepcopy(variables)
    del smaller["params"]["feature_extractor"]["merge_reduce2"]
    with pytest.raises(KeyError):
        tamosnet_from_flax(smaller, tnet)


def test_tamos_swin_tracker_trace_matches_jax(tamos_pair):
    """init + 3 frames of a two-object sequence through both TaMOs trackers
    on the tiny TaMOs-Swin (frames of 128x256 are the JAX package's shape
    bucket, so its padding is a no-op). The random net's scores saturate
    the sigmoid, so every second peak is a distractor: a distractor
    threshold above 1, conf_ths=-1 and a zero not-found threshold let the
    memory update run."""
    from pytracking_tpu.trackers.tamos import TaMOsParams, TaMOsTracker

    jnet, variables, tnet = tamos_pair
    info = {"init_bbox": {"3": [40, 40, 24, 20], "7": [150, 80, 20, 24]},
            "init_object_ids": ["3", "7"], "object_ids": ["3", "7"]}
    kw = dict(train_feature_size=FEAT, num_tokens=K, conf_ths=-1.0,
              target_not_found_threshold=0.0, distractor_threshold=1.1)
    jtr = TaMOsTracker(TaMOsParams(**kw), jnet, variables)
    ttr = t_tamos.TaMOsTracker(t_tamos.TaMOsParams(**kw), tnet, device="cpu")
    jtr.initialize(_frame(0), info)
    ttr.initialize(_frame(0), info)
    for t in range(1, 4):
        jo = jtr.track(_frame(t))
        to = ttr.track(_frame(t))
        _close(_values(to["target_bbox"]), _values(jo["target_bbox"]), atol=1e-3)
        _close(_values(to["object_presence_score"]), _values(jo["object_presence_score"]),
               atol=1e-5)
        np.testing.assert_array_equal(ttr.state.flag.numpy(), np.asarray(jtr.state.flag))
        assert int(ttr.state.num_stored) == int(jtr.state.num_stored)
        _close(ttr.state.mem_weights.numpy(), jtr.state.mem_weights, atol=1e-6)
        _close(_nhwc(ttr.state.mem_samples), jtr.state.mem_samples, atol=1e-4)
    assert int(ttr.state.num_stored) == 2


def test_full_size_tamos_swin_base_keys_and_shapes_match_jax(monkeypatch):
    """TaMOs-SwinBase at full size (Swin-B: embed 128, depths (2, 2, 18,
    2), heads (4, 8, 16, 32); d = 256): every converted flax leaf lands on
    a port key of the same shape, and every port key has one. The port net
    is built on the meta device."""
    from pytracking_tpu.models.tracking.tamosnet import tamosnet_swin_base

    jnet = tamosnet_swin_base()
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), *_tamos_init_inputs(
        (384, 576), (24, 36), 10), train=False))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    monkeypatch.setattr(t_tamosnet, "init_weights", lambda net, generator: net)
    with torch.device("meta"):
        net = t_tamosnet.tamosnet_swin_base(device="meta")
    sd = tamosnet_from_flax(variables, net)
    assert sum(k.endswith("attn.rel_pos_bias") for k in sd) == 2 + 2 + 18 + 2
    assert sd["feature_extractor.stage3_block17.attn.rel_pos_bias"].shape == (169, 16)
