"""Parity of the PyTorch port's TaMOs slice with the JAX package, on the CPU.

The same inputs (made from numpy seeds) and the same weights (the JAX
`net.init` converted with `tamosnet_from_flax`) go through each JAX module
and its port. Float32 throughout, at the tiny TaMOs configuration of
tests/test_tamos.py (ResNet with one block per stage at width 8, d = 32,
4 heads, 2 + 2 transformer layers, K = 3 objects, 4x6 feature grid), with
box_enc='ltrb_token' so the box encoder is exercised. Feature maps are
NHWC in JAX and NCHW in the port; the comparisons transpose.
"""

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
from pytracking_tpu_torch.models.transformer import position_encoding as t_pos
from pytracking_tpu_torch.models.transformer.got_filter_predictor import \
    GOTFilterPredictor as TGOT
from pytracking_tpu_torch.models.transformer.heads import (
    DenseBoxRegressor as TDenseBoxRegressor,
    LinearFilterClassifier as TLinearFilterClassifier)
from pytracking_tpu_torch.models.transformer.transformer import \
    Transformer as TTransformer
from pytracking_tpu_torch.ops import dcf as t_dcf
from pytracking_tpu_torch.ops import filter as t_filter
from pytracking_tpu_torch.ops import patch as t_patch
from pytracking_tpu_torch.trackers import tamos as t_tamos
from pytracking_tpu_torch.utils.convert_weights import tamosnet_from_flax

ATOL = 1e-4
K = 3
FEAT = (4, 6)
D_MODEL = 32


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _nchw(x):
    """NHWC numpy (..., H, W, C) -> NCHW torch (..., C, H, W)."""
    x = np.asarray(x, np.float32)
    return _t(np.moveaxis(x, -1, -3))


def _nhwc(x: torch.Tensor):
    return np.moveaxis(x.detach().numpy(), -3, -1)


def _close(a, b, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=atol, rtol=rtol)


def jax_tiny_tamosnet(dtype=None):
    from pytracking_tpu.models.backbones.resnet import ResNet
    from pytracking_tpu.models.classifier.features import ResidualBottleneck
    from pytracking_tpu.models.tracking.tamosnet import FPN, TaMOsNet
    from pytracking_tpu.models.transformer.got_filter_predictor import GOTFilterPredictor
    from pytracking_tpu.models.transformer.heads import (DenseBoxRegressor,
                                                         LinearFilterClassifier)
    from pytracking_tpu.models.transformer.transformer import Transformer

    d = D_MODEL
    backbone = ResNet(block="bottleneck", layers=(1, 1, 1, 1),
                      output_layers=("layer2", "layer3"), base_width=8, dtype=dtype)
    head_fe = ResidualBottleneck(feature_dim=16, num_blocks=0, l2norm=True,
                                 final_conv=True, norm_scale=math.sqrt(1 / d), out_dim=d)
    transformer = Transformer(d_model=d, nhead=4, num_encoder_layers=2,
                              num_decoder_layers=2, dim_feedforward=64, dtype=dtype)
    fp = GOTFilterPredictor(transformer, feature_sz=max(FEAT), num_tokens=K,
                            box_enc="ltrb_token")
    return TaMOsNet(feature_extractor=backbone, head_feature_extractor=head_fe,
                    filter_predictor=fp, classifier=LinearFilterClassifier(num_channels=d),
                    bb_regressor=DenseBoxRegressor(num_channels=d), fpn=FPN(output_dim=d))


def torch_tiny_tamosnet(dtype=None):
    d = D_MODEL
    backbone = t_resnet.ResNet(layers=(1, 1, 1, 1), output_layers=("layer2", "layer3"),
                               base_width=8, dtype=dtype)
    head_fe = TResidualBottleneck(in_dim=128, out_dim=d, norm_scale=math.sqrt(1 / d))
    transformer = TTransformer(d_model=d, nhead=4, num_encoder_layers=2,
                               num_decoder_layers=2, dim_feedforward=64, dtype=dtype)
    fp = TGOT(transformer, feature_sz=max(FEAT), num_tokens=K, box_enc="ltrb_token")
    return t_tamosnet.TaMOsNet(
        feature_extractor=backbone, head_feature_extractor=head_fe, filter_predictor=fp,
        classifier=TLinearFilterClassifier(d), bb_regressor=TDenseBoxRegressor(d),
        fpn=t_tamosnet.FPN(d, 64, d)).eval()


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
    out["batch_stats"] = walk(jax.tree_util.tree_map(np.asarray,
                                                     variables["batch_stats"]))
    return out


@pytest.fixture(scope="module")
def nets():
    """(jax net, flax variables as numpy, torch net with the same weights)."""
    jnet = jax_tiny_tamosnet()
    Hs, Ws = FEAT[0] * 16, FEAT[1] * 16
    tr = jnp.zeros((1, 1, Hs, Ws, 3))
    lab = jnp.zeros((1, 1, K) + FEAT)
    ltrb = jnp.zeros((1, 1, K) + FEAT + (4,))
    variables = jnet.init(jax.random.PRNGKey(0), tr, tr, lab, ltrb, train=False)
    variables = jax.tree_util.tree_map(np.asarray, _perturb_batch_stats(
        jax.tree_util.tree_map(np.asarray, dict(variables)), seed=7))
    tnet = torch_tiny_tamosnet()
    tnet.load_state_dict(tamosnet_from_flax(variables, tnet))
    return jnet, variables, tnet


def _apply(jnet, variables, fn, *args):
    return jnet.apply(variables, *args, method=fn)


# ---------------------------------------------------------------- ops

def test_gauss_2d_and_max2d_match_jax():
    from pytracking_tpu.ops import dcf

    rng = np.random.RandomState(0)
    centers = rng.randn(5, 2).astype(np.float32) * 2
    sigma = np.abs(rng.randn(5, 2)).astype(np.float32) + 0.5
    for k in range(5):
        ref = dcf.gauss_2d((7, 9), jnp.asarray(sigma[k]), jnp.asarray(centers[k])[None])
        got = t_dcf.gauss_2d((7, 9), _t(sigma[k:k + 1]), _t(centers[k:k + 1]))
        _close(got.numpy(), ref, atol=1e-6)
    a = rng.rand(3, 5, 6).astype(np.float32)
    a[1, 2, 3] = a[1, 4, 0] = 2.0                      # tie: first index wins
    vj, ij = dcf.max2d(jnp.asarray(a))
    vt, it = t_dcf.max2d(_t(a))
    _close(vt.numpy(), vj, atol=0)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert tuple(it[1].tolist()) == (2, 3)


@pytest.mark.parametrize("pos,extent", [((40.0, 70.0), (64.0, 96.0)),
                                        ((10.0, 5.0), (200.0, 300.0)),
                                        ((59.5, 79.5), (30.0, 45.0))])
def test_sample_patch_replicate_matches_jax(pos, extent):
    from pytracking_tpu.ops.patch import sample_patch

    im = np.random.RandomState(1).rand(120, 160, 3).astype(np.float32) * 255
    ref, ref_coords = sample_patch(jnp.asarray(im), jnp.asarray(pos), jnp.asarray(extent),
                                   (32, 48), mode="replicate")
    got, coords = t_patch.sample_patch(_t(im).permute(2, 0, 1), _t(pos), _t(extent),
                                       (32, 48))
    _close(_nhwc(got), ref, atol=1e-3)
    _close(coords.numpy(), ref_coords, atol=1e-5)


@pytest.mark.parametrize("fsz", [(1, 1), (4, 4), (3, 5)])
def test_apply_filter_dimp_matches_jax(fsz):
    from pytracking_tpu.ops.filter import apply_filter

    rng = np.random.RandomState(2)
    feat = rng.randn(3, 9, 11, 8).astype(np.float32)
    filt = rng.randn(3, fsz[0], fsz[1], 8, 2).astype(np.float32)
    ref = apply_filter(jnp.asarray(feat), jnp.asarray(filt), mode="dimp")
    got = t_filter.apply_filter(_nchw(feat), _t(filt.transpose(0, 4, 3, 1, 2)))
    _close(_nhwc(got), ref)


# ---------------------------------------------------------------- modules

def test_resnet_backbone_matches_jax(nets):
    jnet, variables, tnet = nets
    im = np.random.RandomState(3).rand(2, 64, 96, 3).astype(np.float32) * 255
    ref = _apply(jnet, variables, lambda m, x: m.extract_backbone(x), jnp.asarray(im))
    got = tnet.extract_backbone(_nchw(im))
    assert set(got) == {"layer2", "layer3"}
    for name in got:
        _close(_nhwc(got[name]), ref[name])


def test_residual_bottleneck_matches_jax(nets):
    jnet, variables, tnet = nets
    x = np.random.RandomState(4).randn(2, 4, 6, 128).astype(np.float32)
    ref = _apply(jnet, variables, lambda m, f: m.head_feature_extractor(f), jnp.asarray(x))
    got = tnet.head_feature_extractor(_nchw(x))
    _close(_nhwc(got), ref)


@pytest.mark.parametrize("shape,d,max_res", [((4, 6), 32, 6), ((24, 36), 256, 36)])
def test_position_encoding_matches_jax(shape, d, max_res):
    from pytracking_tpu.models.transformer.position_encoding import \
        position_embedding_sine

    ref = position_embedding_sine(shape, d, max_res)
    _close(t_pos.position_embedding_sine(shape, d, max_res).numpy(), ref, atol=1e-5)


def test_transformer_with_key_padding_matches_jax(nets):
    jnet, variables, tnet = nets
    rng = np.random.RandomState(5)
    L = 3 * FEAT[0] * FEAT[1]
    src = rng.randn(2, L, D_MODEL).astype(np.float32)
    pos = rng.randn(2, L, D_MODEL).astype(np.float32)
    qe = rng.randn(K, D_MODEL).astype(np.float32)
    pad = np.zeros((2, L), bool)
    pad[1, :L // 3] = True
    jtr = jnet.filter_predictor.transformer
    tvars = {c: variables[c]["filter_predictor"]["transformer"] for c in ("params",)}
    dec_ref, mem_ref = jtr.apply(tvars, jnp.asarray(src), jnp.asarray(qe), jnp.asarray(pos),
                                 key_padding_mask=jnp.asarray(pad))
    dec, mem = tnet.filter_predictor.transformer(_t(src), _t(qe), _t(pos),
                                                 key_padding_mask=torch.from_numpy(pad))
    _close(dec.detach().numpy(), dec_ref)
    _close(mem.detach().numpy(), mem_ref)


def _predictor_inputs(seed, Nf=2):
    rng = np.random.RandomState(seed)
    C = D_MODEL
    train_feat = rng.randn(Nf, 1, FEAT[0], FEAT[1], C).astype(np.float32)
    test_feat = rng.randn(1, 1, FEAT[0], FEAT[1], C).astype(np.float32)
    label = rng.rand(Nf, 1, K, FEAT[0], FEAT[1]).astype(np.float32)
    ltrb = rng.rand(Nf, 1, K, FEAT[0], FEAT[1], 4).astype(np.float32)
    return train_feat, test_feat, label, ltrb


def test_got_predict_filter_matches_jax(nets):
    jnet, variables, tnet = nets
    train_feat, test_feat, label, ltrb = _predictor_inputs(6)
    mask = np.array([True, False])
    (filt_ref, enc_ref) = _apply(
        jnet, variables,
        lambda m, a, b, c, d: m.filter_predictor.predict_filter(a, b, c, d,
                                                                train_frame_mask=mask),
        jnp.asarray(train_feat), jnp.asarray(test_feat), jnp.asarray(label),
        jnp.asarray(ltrb))
    filt, enc = tnet.predict_filters(_nchw(train_feat), _nchw(test_feat), _t(label),
                                     _t(ltrb), torch.from_numpy(mask))
    _close(filt.detach().numpy(), np.asarray(filt_ref).reshape(1, K, D_MODEL))
    _close(_nhwc(enc), enc_ref)


def test_got_parallel_filters_match_jax(nets):
    jnet, variables, tnet = nets
    train_feat, test_feat, label, ltrb = _predictor_inputs(7)
    fmask, gmask = np.array([True, True]), np.array([True, False])
    refs = _apply(jnet, variables,
                  lambda m, a, b, c, d: m.predict_filters_parallel(a, b, c, d, fmask, gmask),
                  jnp.asarray(train_feat), jnp.asarray(test_feat), jnp.asarray(label),
                  jnp.asarray(ltrb))
    got = tnet.predict_filters_parallel(_nchw(train_feat), _nchw(test_feat), _t(label),
                                        _t(ltrb), torch.from_numpy(fmask),
                                        torch.from_numpy(gmask))
    for g, r in zip(got[:2], refs[:2]):
        _close(g.detach().numpy(), np.asarray(r).reshape(1, K, D_MODEL))
    for g, r in zip(got[2:], refs[2:]):
        _close(_nhwc(g), r)
    # the two copies saw different memories
    assert not np.allclose(got[0].detach().numpy(), got[1].detach().numpy(), atol=1e-3)


def test_heads_match_jax(nets):
    jnet, variables, tnet = nets
    rng = np.random.RandomState(8)
    feat = rng.randn(1, 1, 8, 12, D_MODEL).astype(np.float32)
    filt = rng.randn(1, K, 1, 1, D_MODEL, 1).astype(np.float32)
    s_ref = _apply(jnet, variables, lambda m, f, w: m.classify(f, w), jnp.asarray(feat),
                   jnp.asarray(filt))
    b_ref = _apply(jnet, variables, lambda m, f, w: m.bbreg(f, w), jnp.asarray(feat),
                   jnp.asarray(filt))
    tf = _t(filt.reshape(1, K, D_MODEL))
    s = tnet.classify(_nchw(feat), tf)                             # (1, 1, K, H, W)
    b = tnet.bbreg(_nchw(feat), tf)                                # (1, 1, K, 4, H, W)
    _close(s.detach().numpy().transpose(0, 1, 3, 4, 2), s_ref)
    _close(b.detach().numpy().transpose(0, 1, 4, 5, 2, 3), b_ref, rtol=1e-4)
    out_hw = (8, 12)
    enc = rng.randn(1, 1, 4, 6, D_MODEL).astype(np.float32)
    c_ref = _apply(jnet, variables, lambda m, f, w: m.classify_trafo(f, w, out_hw),
                   jnp.asarray(enc), jnp.asarray(filt))
    c = tnet.classify_trafo(_nchw(enc), tf, out_hw)
    _close(c.detach().numpy().transpose(0, 1, 3, 4, 2), c_ref)


def test_fpn_matches_jax(nets):
    jnet, variables, tnet = nets
    rng = np.random.RandomState(9)
    enc = rng.randn(1, 1, 4, 6, D_MODEL).astype(np.float32)
    high = rng.randn(1, 8, 12, 64).astype(np.float32)
    ref = _apply(jnet, variables, lambda m, e, f: m.run_fpn(e, {"layer2": f}),
                 jnp.asarray(enc), jnp.asarray(high))
    got = tnet.run_fpn(_nchw(enc), {"layer2": _nchw(high)})
    for k in ("feat2", "feat3"):
        _close(_nhwc(got[k]), ref[k])


def test_tamosnet_forward_matches_jax(nets):
    jnet, variables, tnet = nets
    rng = np.random.RandomState(10)
    Hs, Ws = FEAT[0] * 16, FEAT[1] * 16
    tr = rng.rand(2, 1, Hs, Ws, 3).astype(np.float32) * 255
    te = rng.rand(1, 1, Hs, Ws, 3).astype(np.float32) * 255
    lab = rng.rand(2, 1, K, FEAT[0], FEAT[1]).astype(np.float32)
    ltrb = rng.rand(2, 1, K, FEAT[0], FEAT[1], 4).astype(np.float32)
    s_ref, b_ref = jnet.apply(variables, jnp.asarray(tr), jnp.asarray(te),
                              jnp.asarray(lab), jnp.asarray(ltrb), train=False)
    s, b = tnet(_nchw(tr), _nchw(te), _t(lab), _t(ltrb))
    _close(s.detach().numpy().transpose(0, 1, 3, 4, 2), s_ref)
    _close(b.detach().numpy().transpose(0, 1, 4, 5, 2, 3), b_ref, rtol=1e-4)


def test_converter_uses_every_leaf_and_key(nets):
    jnet, variables, tnet = nets
    sd = tamosnet_from_flax(variables, tnet)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    n_stacked = sum(np.asarray(x).shape[0] - 1 for p, x in
                    jax.tree_util.tree_flatten_with_path(variables)[0]
                    if "layer" in [getattr(k, "key", None) for k in p])
    assert len(sd) == n_leaves + n_stacked == len(tnet.state_dict())
    broken = dict(variables)
    broken["params"] = dict(variables["params"], extra={"kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError):
        tamosnet_from_flax(broken, tnet)
    smaller = dict(variables)
    smaller["params"] = {k: v for k, v in variables["params"].items() if k != "fpn"}
    with pytest.raises(KeyError):
        tamosnet_from_flax(smaller, tnet)


# ---------------------------------------------------------------- tracker

def _values(x):
    """A tracker output entry as an array; a multi-object dict in key order."""
    return np.asarray(list(x.values()) if isinstance(x, dict) else x, np.float64)


def _frame(t, H=128, W=256):
    im = np.full((H, W, 3), 30, np.uint8)
    im[40 + 2 * t:60 + 2 * t, 40 + 3 * t:64 + 3 * t] = [220, 60, 60]
    im[80:104, 150 + 2 * t:170 + 2 * t] = [60, 220, 60]
    return im


@pytest.mark.parametrize("info", [
    {"init_bbox": {"3": [40, 40, 24, 20], "7": [150, 80, 20, 24]},
     "init_object_ids": ["3", "7"], "object_ids": ["3", "7"]},
    {"init_bbox": [40, 40, 24, 20]},
], ids=["two_objects", "single_object"])
def test_tracker_trace_matches_jax(nets, info):
    """init + 3 frames of a two-object sequence. The frames are multiples of
    the JAX package's 128-pixel shape bucket, so its padding is a no-op.
    With random weights every score is low, so conf_ths=-1 and a zero
    not-found threshold let the memory update run: the first tracked frame
    has num_stored < M (the key mask is exercised), the third replaces a
    slot."""
    from pytracking_tpu.trackers.tamos import TaMOsParams, TaMOsTracker

    jnet, variables, tnet = nets
    kw = dict(train_feature_size=FEAT, num_tokens=K, sample_memory_size=2, conf_ths=-1.0,
              target_not_found_threshold=0.0)
    jtr = TaMOsTracker(TaMOsParams(**kw), jnet, variables)
    ttr = t_tamos.TaMOsTracker(t_tamos.TaMOsParams(**kw), tnet, device="cpu")
    jtr.initialize(_frame(0), info)
    ttr.initialize(_frame(0), info)
    _close(_nhwc(ttr.state.mem_samples), jtr.state.mem_samples)
    for t in range(1, 4):
        jo = jtr.track(_frame(t))
        to = ttr.track(_frame(t))
        for key, atol in (("target_bbox", 1e-3), ("object_presence_score", 1e-5)):
            assert type(to[key]) is type(jo[key])
            if isinstance(jo[key], dict):
                assert list(to[key]) == list(jo[key])
            _close(_values(to[key]), _values(jo[key]), atol=atol)
        js, ts = jtr.state, ttr.state
        np.testing.assert_array_equal(ts.flag.numpy(), np.asarray(js.flag))
        assert int(ts.num_stored) == int(js.num_stored)
        assert int(ts.prev_ind) == int(js.prev_ind)
        _close(ts.mem_weights.numpy(), js.mem_weights, atol=1e-6)
        _close(ts.mem_boxes.numpy(), js.mem_boxes, atol=1e-3)
        _close(ts.mem_labels.numpy(), js.mem_labels, atol=1e-5)
        _close(_nhwc(ts.mem_samples), js.mem_samples)
    assert int(ttr.state.num_stored) == 2


# ---------------------------------------------------------------- bf16

def test_bf16_port_close_to_f32_under_gate_limits(nets, bf16_nets):
    """The port's bf16 compute (backbone + transformer) against its float32
    compute with the same weights, at the limits of the JAX package's bf16
    TaMOs gate (tests/test_bf16_harness_gate.py)."""
    _, _, tnet = nets
    net16 = bf16_nets[2]
    rng = np.random.RandomState(11)
    Hs, Ws = FEAT[0] * 16, FEAT[1] * 16
    tr = rng.rand(1, 1, Hs, Ws, 3).astype(np.float32) * 255
    te = np.roll(tr, (3, -5), axis=(2, 3))
    centers = np.array([[2.0, 3.0], [1.5, 4.0], [3.0, 1.5]], np.float32)
    lab = t_dcf.gauss_2d(FEAT, 1.0, _t(centers))[None, None]
    with torch.inference_mode():
        s32, l32 = tnet(_nchw(tr), _nchw(te), lab)
        s16, l16 = net16(_nchw(tr), _nchw(te), lab)
    corr, max_rel, disp, ltrb_err = _gate_stats(s32.double().numpy(), s16.double().numpy(),
                                                l32.double().numpy(), l16.double().numpy())
    assert corr > 0.98, corr
    assert max_rel < 0.05, max_rel
    assert disp <= 2, disp
    assert ltrb_err < 0.05, ltrb_err


def _gate_stats(s_ref, s, l_ref, l):
    """The JAX package's bf16 gate statistics of (s, l) against (s_ref,
    l_ref): score corr, max-score rel diff, per-object argmax displacement,
    median LTRB rel err. Scores (..., K, H, W), ltrb (..., K, 4, H, W)."""
    corr = np.corrcoef(s_ref.ravel(), s.ravel())[0, 1]
    max_rel = abs(s.max() - s_ref.max()) / max(abs(s_ref.max()), 1e-6)
    disp = []
    for k in range(s.shape[-3]):
        a = np.unravel_index(np.argmax(s_ref[0, 0, k]), s_ref.shape[-2:])
        b = np.unravel_index(np.argmax(s[0, 0, k]), s.shape[-2:])
        disp.append(max(abs(a[0] - b[0]), abs(a[1] - b[1])))
    ltrb_err = np.median(np.abs(l - l_ref) / (np.abs(l_ref) + 1e-3))
    return corr, max_rel, max(disp), ltrb_err


@pytest.fixture(scope="module")
def bf16_nets(nets):
    """(JAX net in bf16, its variables, the port's bf16 twin): the same
    converted weights, bf16 backbone and transformer compute in both."""
    _, variables, tnet = nets
    net16 = torch_tiny_tamosnet(dtype=torch.bfloat16)
    net16.load_state_dict(tnet.state_dict())
    return jax_tiny_tamosnet(dtype=jnp.bfloat16), variables, net16


def _bf16_ulp(x):
    """One bf16 unit in the last place at the largest magnitude of x."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


def _bf16_module_outputs(nets, bf16_nets, module, seed=10):
    """{name: (JAX bf16, port bf16, JAX f32)} outputs of one bf16 module on
    the same inputs and weights."""
    jnet, variables, _ = nets
    j16, _, t16 = bf16_nets
    rng = np.random.RandomState(seed)
    if module == "backbone":
        im = rng.rand(2, FEAT[0] * 16, FEAT[1] * 16, 3).astype(np.float32) * 255
        refs = [_apply(jn, variables, lambda m, x: m.extract_backbone(x), jnp.asarray(im))
                for jn in (j16, jnet)]
        with torch.inference_mode():
            got = t16.extract_backbone(_nchw(im))
        return {n: (refs[0][n], _nhwc(got[n].float()), refs[1][n]) for n in got}
    L = 3 * FEAT[0] * FEAT[1]
    src, pos = (rng.randn(2, L, D_MODEL).astype(np.float32) for _ in range(2))
    qe = rng.randn(K, D_MODEL).astype(np.float32)
    pad = np.zeros((2, L), bool)
    pad[1, :L // 3] = True
    tvars = {"params": variables["params"]["filter_predictor"]["transformer"]}
    refs = [jn.filter_predictor.transformer.apply(
        tvars, jnp.asarray(src), jnp.asarray(qe), jnp.asarray(pos),
        key_padding_mask=jnp.asarray(pad)) for jn in (j16, jnet)]
    with torch.inference_mode():
        _, mem = t16.filter_predictor.transformer(_t(src), _t(qe), _t(pos),
                                                  key_padding_mask=torch.from_numpy(pad))
    return {"memory": (refs[0][1], mem.float().numpy(), refs[1][1])}


@pytest.mark.parametrize("module", ["backbone", "transformer"])
def test_bf16_modules_match_jax_bf16_recipe(nets, bf16_nets, module):
    """The port's bf16 recipe (which layers cast to bf16; softmax, LayerNorm
    and residuals in float32) against the JAX package's bf16 net on the same
    weights and inputs. Where both round alike the outputs agree to float32
    rounding; a bf16 rounding that falls the other way moves an element by
    at most one bf16 ulp. So: at most 2% of the elements differ by more than
    1e-5 of the output's scale, and none by more than one bf16 ulp. The JAX
    float32 net, the control, differs in far more elements: the test tells
    the bf16 recipe from float32 compute."""
    for name, (j16, t16, j32) in _bf16_module_outputs(nets, bf16_nets, module).items():
        j16, t16, j32 = (np.asarray(x, np.float64) for x in (j16, t16, j32))
        tol = 1e-5 * np.abs(j16).max()
        differ = np.mean(np.abs(t16 - j16) > tol)
        assert differ <= 0.02, (name, differ)
        assert np.abs(t16 - j16).max() <= _bf16_ulp(j16), (name, np.abs(t16 - j16).max())
        assert np.mean(np.abs(j32 - j16) > tol) >= 0.2, name


def test_bf16_forward_matches_jax_bf16_tighter_than_gate(nets, bf16_nets):
    """The whole bf16 TaMOsNet forward, port against JAX on the same weights,
    at limits 5-20x tighter than the bf16 gate's (corr > 0.98, rel diff <
    0.05, displacement <= 2, LTRB < 0.05): one bf16 rounding that falls the
    other way in the decoder moves every filter a little, so the whole net
    is held by these statistics and the element-wise recipe check is the
    module test above."""
    _, variables, _ = nets
    j16, _, t16 = bf16_nets
    rng = np.random.RandomState(10)
    Hs, Ws = FEAT[0] * 16, FEAT[1] * 16
    tr = rng.rand(2, 1, Hs, Ws, 3).astype(np.float32) * 255
    te = rng.rand(1, 1, Hs, Ws, 3).astype(np.float32) * 255
    lab = rng.rand(2, 1, K, FEAT[0], FEAT[1]).astype(np.float32)
    ltrb = rng.rand(2, 1, K, FEAT[0], FEAT[1], 4).astype(np.float32)
    s_ref, b_ref = j16.apply(variables, *(jnp.asarray(x) for x in (tr, te, lab, ltrb)),
                             train=False)
    with torch.inference_mode():
        s, b = t16(_nchw(tr), _nchw(te), _t(lab), _t(ltrb))
    corr, max_rel, disp, ltrb_err = _gate_stats(
        np.asarray(s_ref, np.float64).transpose(0, 1, 4, 2, 3), s.double().numpy(),
        np.asarray(b_ref, np.float64).transpose(0, 1, 4, 5, 2, 3), b.double().numpy())
    assert corr > 0.999, corr
    assert max_rel < 0.01, max_rel
    assert disp == 0, disp
    assert ltrb_err < 0.01, ltrb_err
