"""Parity of the PyTorch port's KYS modules with the JAX package, on the CPU:
`hann2d_clipped`, the cost volume, `shift_features`, the conv GRU, the
response predictor, `KYSNet.predict_response` and `kysnet_from_flax`.

Same numpy inputs from a seed through the JAX function and the port's;
weights from the JAX `init` (random BatchNorm statistics) converted with
`kysnet_from_flax`. Float32. Tolerance: 1e-4 relative to the larger of 1
and the output's largest magnitude; `shift_features` and the windows within
1e-6. Maps are 5x7 (not square), so a swapped axis shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytracking_tpu_torch.models.kys import conv_gru as t_conv_gru
from pytracking_tpu_torch.models.kys import cost_volume as t_cost_volume
from pytracking_tpu_torch.models.kys import response_predictor as t_rp
from pytracking_tpu_torch.models.tracking import kysnet as t_kysnet
from pytracking_tpu_torch.ops import dcf as t_dcf
from pytracking_tpu_torch.utils.convert_weights import kysnet_from_flax

from test_torch_dimp_family_ops import (_close, _init_numpy, _nchw, _nhwc, _t, jax_tiny_net,
                                        perturb_batch_stats, torch_tiny_net)

H, W = 5, 7
STATE_DIM = 4


def jax_tiny_kys(conf="entropy"):
    """The tiny SuperDiMP-kind DiMPnet of the family tests with a response
    predictor (4-channel state, one 8-channel representation conv) and
    displacements up to 3 cells."""
    from pytracking_tpu.models.kys.response_predictor import ResponsePredictor
    from pytracking_tpu.models.tracking.kysnet import KYSNet

    d = jax_tiny_net("superdimp")
    return KYSNet(feature_extractor=d.feature_extractor, classifier=d.classifier,
                  bb_regressor=d.bb_regressor, classification_layer="layer3",
                  bb_regressor_layer=("layer2", "layer3"),
                  predictor=ResponsePredictor(state_dim=STATE_DIM,
                                              representation_predictor_dims=(8,),
                                              conf_measure=conf, dimp_thresh=0.05),
                  max_displacement=3)


def torch_tiny_kys(conf="entropy"):
    d = torch_tiny_net("superdimp")
    return t_kysnet.KYSNet(d.feature_extractor, d.classifier, d.bb_regressor,
                           t_rp.ResponsePredictor(state_dim=STATE_DIM,
                                                  representation_predictor_dims=(8,),
                                                  conf_measure=conf, dimp_thresh=0.05),
                           max_displacement=3).eval()


def tiny_kys_pair(conf="entropy", seed=0):
    """(jax KYSNet, its flax variables as numpy, the port's net with the same
    weights). The variables merge the DiMP training forward's init with the
    predictor's, as the JAX parameter module does."""
    jnet = jax_tiny_kys(conf)
    im = jnp.zeros((1, 1, 96, 96, 3))
    bb = jnp.array([[[30.0, 30.0, 20.0, 20.0]]])
    v_main = jax.jit(lambda k: jnet.init(k, im, im, bb, bb[:, :, None], train=False))(
        jax.random.PRNGKey(seed))
    mf = jnp.zeros((1, 6, 6, 256))
    s1 = jnp.zeros((1, 6, 6, 1))
    # jitted: the same values as the eager init, in a quarter of its time
    v_pred = jax.jit(lambda k: jnet.init(
        k, mf, mf, None, s1, s1,
        method=lambda m, a, b, c, e, g: m.predict_response(a, b, c, e, init_label=g)))(
        jax.random.PRNGKey(seed + 1))
    variables = {"params": {**v_main["params"], **v_pred["params"]},
                 "batch_stats": {**v_main["batch_stats"], **v_pred["batch_stats"]}}
    variables = perturb_batch_stats(jax.tree_util.tree_map(np.asarray, variables), seed + 7)
    tnet = torch_tiny_kys(conf)
    tnet.load_state_dict(kysnet_from_flax(variables, tnet))
    return jnet, variables, tnet


# ---------------------------------------------------------------- ops

@pytest.mark.parametrize("sz,eff", [((18, 18), (36, 36)), ((14, 14), (14, 14)),
                                    ((6, 9), (3, 4)), ((7, 5), (11, 3))],
                         ids=["crop", "exact", "pad", "crop_rows_pad_cols"])
def test_hann2d_clipped_matches_jax(sz, eff):
    from pytracking_tpu.ops.dcf import hann2d_clipped

    got = t_dcf.hann2d_clipped(sz, eff)
    assert tuple(got.shape) == sz
    np.testing.assert_allclose(got.numpy(), hann2d_clipped(sz, eff), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kernel_size,md", [(1, 2), (3, 2), (3, 9), (1, 0)],
                         ids=["k1_md2", "k3_md2", "k3_md_beyond_grid", "k1_md0"])
def test_cost_volume_matches_jax(kernel_size, md):
    from pytracking_tpu.models.kys.cost_volume import cost_volume_abs

    rng = np.random.RandomState(1)
    f1 = rng.randn(2, H, W, 6).astype(np.float32)
    f2 = rng.randn(2, H, W, 6).astype(np.float32)
    ref = cost_volume_abs(jnp.asarray(f1), jnp.asarray(f2), md, kernel_size=kernel_size)
    got = t_cost_volume.cost_volume_abs(_nchw(f1), _nchw(f2), md, kernel_size=kernel_size)
    assert tuple(got.shape) == (2, H * W, H, W)
    _close(got.numpy(), ref)


SHIFTS = {
    "inside": [[0.03, -0.05], [-0.08, 0.02]],
    "beyond_one_cell": [[0.3, -0.45], [-0.41, 0.37]],
    "off_map": [[1.2, -1.5], [0.0, 1.01]],
    "zero": [[0.0, 0.0], [0.0, 0.0]],
}


@pytest.mark.parametrize("case", list(SHIFTS))
def test_shift_features_matches_jax(case):
    from pytracking_tpu.models.kys.response_predictor import shift_features

    feat = np.random.RandomState(2).randn(2, H, W, 3).astype(np.float32)
    s = np.asarray(SHIFTS[case], np.float32)
    ref = shift_features(jnp.asarray(feat), jnp.asarray(s))
    got = t_rp.shift_features(_nchw(feat), _t(s))
    np.testing.assert_allclose(_nhwc(got), ref, atol=1e-6, rtol=0)
    if case == "zero":
        np.testing.assert_array_equal(_nhwc(got), feat)


def test_conv_gru_matches_jax():
    from pytracking_tpu.models.kys.conv_gru import ConvGRUCell

    rng = np.random.RandomState(3)
    x = rng.randn(2, H, W, 4).astype(np.float32)
    st = np.tanh(rng.randn(2, H, W, STATE_DIM)).astype(np.float32)
    jm = ConvGRUCell(hidden_dim=STATE_DIM, kernel_size=3)
    variables = _init_numpy(jm, jnp.asarray(x), jnp.asarray(st))
    tm = t_conv_gru.ConvGRUCell(4, STATE_DIM, 3)
    tm.load_state_dict(kysnet_from_flax(variables, tm))
    _close(_nhwc(tm(_nchw(x), _nchw(st))), jm.apply(variables, jnp.asarray(x), jnp.asarray(st)))


# state: the previous state as given, the label-seeded state selected by
# state_valid False, or no previous state
PREDICTOR_CASES = {
    "valid_entropy": ("entropy", "valid"),
    "invalid_entropy": ("entropy", "invalid"),
    "none_entropy": ("entropy", "none"),
    "valid_max": ("max", "valid"),
    "invalid_max": ("max", "invalid"),
    "valid_noconf": ("none", "valid"),
    "none_noconf": ("none", "none"),
}


def _predictor_inputs(seed):
    rng = np.random.RandomState(seed)
    cv = (rng.randn(2, H * W, H, W) * 3).astype(np.float32)
    sp = np.tanh(rng.randn(2, H, W, STATE_DIM)).astype(np.float32)
    ds = rng.rand(2, H, W, 1).astype(np.float32) * 0.2
    il = rng.rand(2, H, W, 1).astype(np.float32)
    win = rng.rand(1, H, W, 1).astype(np.float32)
    return cv, sp, ds, il, win


@pytest.mark.parametrize("case", list(PREDICTOR_CASES))
def test_response_predictor_matches_jax(case):
    from pytracking_tpu.models.kys.response_predictor import ResponsePredictor

    conf, state = PREDICTOR_CASES[case]
    cv, sp, ds, il, win = _predictor_inputs(4)
    jm = ResponsePredictor(state_dim=STATE_DIM, representation_predictor_dims=(8, 6),
                           conf_measure=conf, dimp_thresh=0.05)
    variables = _init_numpy(jm, jnp.asarray(cv), None, jnp.asarray(ds),
                            init_label=jnp.asarray(il))
    tm = t_rp.ResponsePredictor(state_dim=STATE_DIM, representation_predictor_dims=(8, 6),
                                conf_measure=conf, dimp_thresh=0.05).eval()
    tm.load_state_dict(kysnet_from_flax(variables, tm))
    jsp = None if state == "none" else jnp.asarray(sp)
    tsp = None if state == "none" else _nchw(sp)
    valid = {"valid": True, "invalid": False, "none": None}[state]
    ref = jm.apply(variables, jnp.asarray(cv), jsp, jnp.asarray(ds), init_label=jnp.asarray(il),
                   output_window=jnp.asarray(win),
                   state_valid=None if valid is None else jnp.asarray(valid))
    with torch.no_grad():
        got = tm(_t(cv), tsp, _nchw(ds), init_label=_nchw(il), output_window=_nchw(win),
                 state_valid=None if valid is None else torch.tensor(valid), aux=True)
        plain = tm(_t(cv), tsp, _nchw(ds), init_label=_nchw(il), output_window=_nchw(win),
                   state_valid=None if valid is None else torch.tensor(valid))
    _close(_nhwc(got[0]), ref[0])
    _close(_nhwc(got[1]), ref[1])
    assert set(got[2]) == set(ref[2])
    for name, value in ref[2].items():
        if value is None:
            assert got[2][name] is None, name
        else:
            _close(_nhwc(got[2][name]), value)
    # the auxiliary heads are computed only on request and change nothing
    assert plain[2] == {}
    assert torch.equal(plain[0], got[0]) and torch.equal(plain[1], got[1])


@pytest.fixture(scope="module")
def kys_pair():
    return tiny_kys_pair()


@pytest.mark.parametrize("state", ["valid", "invalid"])
def test_kysnet_predict_response_matches_jax(kys_pair, state):
    jnet, variables, tnet = kys_pair
    rng = np.random.RandomState(5)
    mp = rng.randn(1, 6, 6, 256).astype(np.float32)
    mc = (mp + 0.3 * rng.randn(1, 6, 6, 256)).astype(np.float32)
    sp = np.tanh(rng.randn(1, 6, 6, STATE_DIM)).astype(np.float32)
    ds = rng.rand(1, 6, 6, 1).astype(np.float32) * 0.3
    il = rng.rand(1, 6, 6, 1).astype(np.float32)
    valid = state == "valid"
    ref = jnet.apply(variables, *(jnp.asarray(x) for x in (mp, mc, sp, ds, il)),
                     method=lambda m, a, b, c, e, g: m.predict_response(
                         a, b, c, e, init_label=g, dimp_thresh=0.1,
                         state_valid=jnp.asarray(valid)))
    with torch.no_grad():
        got = tnet.predict_response(*(_nchw(x) for x in (mp, mc, sp, ds, il)), dimp_thresh=0.1,
                                    state_valid=torch.tensor(valid))
    _close(_nhwc(got[0]), ref[0])
    _close(_nhwc(got[1]), ref[1])
    # the motion features are the raw layer3 map
    feat = {"layer2": torch.zeros(1), "layer3": _nchw(mp)}
    assert tnet.get_motion_feat(feat) is feat["layer3"]


def test_kysnet_converter_uses_every_leaf_and_raises(kys_pair):
    _, variables, tnet = kys_pair
    sd = kysnet_from_flax(variables, tnet)
    assert set(sd) == set(tnet.state_dict())
    assert any(k.startswith("predictor.state_predictor.conv_reset") for k in sd)
    extra = {"params": {**variables["params"],
                        "predictor": {**variables["params"]["predictor"],
                                      "stray": {"kernel": np.zeros((3, 3, 1, 1), np.float32)}}},
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="flax leaves without a torch key"):
        kysnet_from_flax(extra, tnet)
    params = dict(variables["params"])
    params["predictor"] = {k: v for k, v in params["predictor"].items() if k != "init_hidden"}
    with pytest.raises(KeyError, match="torch keys without a flax leaf"):
        kysnet_from_flax({"params": params, "batch_stats": variables["batch_stats"]}, tnet)


def test_full_width_kysnet_keys_match_jax(monkeypatch):
    """kysnet_res50's keys and shapes against the JAX net's (eval_shape), on
    the meta device."""
    from pytracking_tpu.models.tracking.kysnet import kysnet_res50

    jnet = kysnet_res50()
    im = jnp.zeros((1, 1, 288, 288, 3))
    bb = jnp.array([[[100.0, 100.0, 50.0, 50.0]]])
    v_main = jax.eval_shape(lambda k: jnet.init(k, im, im, bb, bb[:, :, None], train=False),
                            jax.random.PRNGKey(0))
    mf = jnp.zeros((1, 18, 18, 1024))
    s1 = jnp.zeros((1, 18, 18, 1))
    v_pred = jax.eval_shape(lambda k: jnet.init(
        k, mf, mf, None, s1, s1,
        method=lambda m, a, b, c, e, g: m.predict_response(a, b, c, e, init_label=g)),
        jax.random.PRNGKey(1))
    variables = {"params": {**v_main["params"], **v_pred["params"]},
                 "batch_stats": {**v_main["batch_stats"], **v_pred["batch_stats"]}}
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), variables)
    monkeypatch.setattr(t_kysnet, "init_weights", lambda net, generator: net)
    with torch.device("meta"):
        tnet = t_kysnet.kysnet_res50(device="meta")
    kysnet_from_flax(variables, tnet)
