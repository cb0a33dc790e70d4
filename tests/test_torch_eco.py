"""Parity of the PyTorch port's ECO (pytracking_tpu_torch/models/backbones/
{vggm_resnet,mobilenetv3}.py, trackers/eco.py, parameter/eco/*) with the JAX
package, on the CPU.

Nets: the full-width ResNet18-VGG-m1 (to layer3) and MobileNetV3-Large (to
layer5), their JAX `net.init` with random BatchNorm statistics, converted.
Float32 / complex64 throughout. Tolerances: backbone outputs 1e-4 of the
larger of 1 and their largest magnitude, the Fourier sample 1e-5; traces:
the scale index equal, boxes within 1e-3 px, sample weights within 1e-6,
projections and filters within 1e-4 of scale after aligning each
projection column's sign (singular vectors are unique up to sign; the
filter's channel takes its column's sign). The dropout masks of the port
are replaced by the JAX tracker's own, from its key with its splits.
"""

import dataclasses
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytracking_tpu_torch.models.backbones import mobilenetv3 as t_mobilenet
from pytracking_tpu_torch.models.backbones import vggm_resnet as t_vggm
from pytracking_tpu_torch.parameter.eco import default as t_eco_default
from pytracking_tpu_torch.trackers import eco as t_eco
from pytracking_tpu_torch.utils.convert_weights import (eco_backbone_from_flax,
                                                        mobilenet3_from_flax,
                                                        resnet18_vggm_from_flax)
from test_torch_lwl_ops import one_thread  # noqa: F401 (autouse: one CPU thread)
from test_torch_dimp import _perturb_batch_stats
from test_torch_atom import _HostTensors

ATOL = 1e-4
# tests/test_eco.py's operating point with the default feature blocks and
# scales: 112x112 samples (29x29 and 7x7 filter grids), 5 init samples
TRACE_KW = dict(max_image_sample_size=96 ** 2, min_image_sample_size=96 ** 2,
                sample_memory_size=10, init_CG_iter=10, init_GN_iter=2, CG_iter=3,
                train_skipping=3,
                blocks=((4, 8, 1 / 16, 0.4, 10e-3), (16, 16, 1 / 4, 0.6, 50e-3)),
                augmentation=(("fliplr", True), ("shift", ((4, 4), (-4, -4))),
                              ("dropout", (1, 0.2))))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, atol=ATOL):
    """|a - b| <= atol * max(1, max |b|), complex values compared as such."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a.astype(np.complex128), b.astype(np.complex128),
                               atol=atol * max(1.0, float(np.abs(b).max())), rtol=0.0)


def _nhwc(x):
    return np.moveaxis(x.detach().numpy(), -3, -1)


def _init(jnet, seed):
    variables = jax.jit(lambda k: jnet.init(k, jnp.zeros((1, 64, 64, 3))))(
        jax.random.PRNGKey(seed))
    return _perturb_batch_stats(jax.tree_util.tree_map(np.asarray, dict(variables)), seed)


@pytest.fixture(scope="module")
def eco_nets():
    """(JAX _ECOBackbone over ResNet18-VGG-m1, its variables, the port's)."""
    from pytracking_tpu.models.backbones.vggm_resnet import resnet18_vggmconv1
    from pytracking_tpu.parameter.eco.default import _ECOBackbone

    jnet = _ECOBackbone(resnet18_vggmconv1(("vggconv1", "layer3")))
    variables = _init(jnet, 1)
    tnet = t_eco_default.ECOBackbone(t_vggm.resnet18_vggmconv1(("vggconv1", "layer3"))).eval()
    tnet.load_state_dict(eco_backbone_from_flax(variables, tnet))
    return jnet, variables, tnet


# ---------------------------------------------------------------- backbones

def _backbone_case(name):
    from pytracking_tpu.models.backbones import mobilenetv3 as j_mobilenet
    from pytracking_tpu.models.backbones import vggm_resnet as j_vggm

    if name == "vggm":
        layers = ("vggconv1", "conv1", "layer1", "layer3")
        return (j_vggm.resnet18_vggmconv1(layers), t_vggm.resnet18_vggmconv1(layers),
                resnet18_vggm_from_flax)
    layers = ("init_conv", "layer2", "layer5")
    return j_mobilenet.mobilenet3(layers), t_mobilenet.mobilenet3(layers), mobilenet3_from_flax


@pytest.mark.parametrize("name", ["vggm", "mobilenet3"])
def test_backbone_matches_jax(name):
    """Every requested output at 64x64 (the LRN, squeeze-excite, the
    depthwise convolutions, the hard activations), the converter using
    every leaf and key."""
    jnet, tnet, convert = _backbone_case(name)
    variables = _init(jnet, 2)
    sd = convert(variables, tnet)
    assert len(sd) == len(jax.tree_util.tree_leaves(variables)) == len(tnet.state_dict())
    tnet.load_state_dict(sd)
    broken = dict(variables, params=dict(variables["params"], extra={"kernel": np.zeros((2, 2))}))
    with pytest.raises(KeyError):
        convert(broken, tnet)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    ref = jax.jit(lambda v, x: jnet.apply(v, x))(variables, x)
    with torch.no_grad():
        got = tnet.eval()(_t(np.moveaxis(x, -1, 1)))
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(_nhwc(got[k]), ref[k])


def test_lrn_matches_jax():
    from pytracking_tpu.models.backbones.vggm_resnet import spatial_cross_map_lrn

    x = np.random.RandomState(3).randn(2, 5, 6, 7).astype(np.float32) * 20
    _close(_nhwc(t_vggm.spatial_cross_map_lrn(_t(np.moveaxis(x, -1, 1)))),
           spatial_cross_map_lrn(jnp.asarray(x)), 1e-6)


def test_eco_backbone_converter(eco_nets):
    _, variables, tnet = eco_nets
    assert len(eco_backbone_from_flax(variables, tnet)) == len(tnet.state_dict())
    smaller = dict(variables, params={"feature_extractor": {
        k: v for k, v in variables["params"]["feature_extractor"].items() if k != "vggmconv1"}})
    with pytest.raises(KeyError):
        eco_backbone_from_flax(smaller, tnet)


# ---------------------------------------------------------------- tracker

def _frame(t, H=128, W=128):
    im = np.full((H, W, 3), 30, np.uint8)
    cy, cx = 56 + 2 * t, 52 + 2 * t
    im[cy - 10:cy + 10, cx - 10:cx + 10] = [220, 60, 60]
    return im


INFO = {"init_bbox": [42.0, 46.0, 20.0, 20.0]}


def _pair(eco_nets, kw):
    """The JAX tracker and the port's, the JAX dropout masks fed to the
    port's `_keep_mask`."""
    from pytracking_tpu.trackers.eco import ECOParams, ECOTracker

    jnet, variables, tnet = eco_nets
    jtr = ECOTracker(ECOParams(**kw), jnet, variables)
    ttr = t_eco.ECOTracker(t_eco.ECOParams(**kw), tnet, device="cpu")
    n_drop, prob = ttr.params.aug_dict()["dropout"]
    keys = list(jax.random.split(jax.random.PRNGKey(0), len(kw["blocks"]) + 1)[1:])

    def keep_mask(shape, p):
        keep = np.asarray(jax.random.bernoulli(keys.pop(0), 1.0 - p, (n_drop, 1, 1, shape[1])))
        return torch.from_numpy(keep.transpose(0, 3, 1, 2).copy())

    ttr._keep_mask = keep_mask
    return jtr, ttr


def _filters_close(ts, js):
    """P and hf per block after aligning each projection column's sign."""
    for b in range(len(ts.proj)):
        jp, tp = np.asarray(js.proj[b]), ts.proj[b].numpy()
        sign = np.sign(np.sum(jp * tp, axis=0))
        _close(tp * sign, jp)
        _close(np.moveaxis(ts.filters[b].numpy(), 0, -1) * sign, js.filters[b])


def test_fourier_sample_matches_jax(eco_nets):
    """One block's windowed, padded, interpolated spectrum of random
    features, both blocks' grids."""
    jtr, ttr = _pair(eco_nets, TRACE_KW)
    ttr.initialize(_frame(0), INFO)
    rng = np.random.RandomState(4)
    for b, (fsz, filt) in enumerate(zip(ttr._feat_szs, ttr._filt_szs)):
        feat = rng.randn(2, fsz, fsz, 6).astype(np.float32)
        ref = jtr._fourier_sample(jnp.asarray(feat), fsz, filt)
        _close(np.moveaxis(ttr._fourier_sample(_t(np.moveaxis(feat, -1, 1)), b).numpy(), 1, -1),
               ref, 1e-5)


def test_tracker_trace_matches_jax(eco_nets):
    """initialize + 12 frames of a target moving (+2, +2) px per frame on
    128x128 frames over 5 scales: the init's P and hf (after sign
    alignment), then per frame the scale index (from the target scale),
    the box, the score, the memory counters and weights, and the filters,
    through the refits at frames 3, 6, 9 and 12 (train_skipping 3)."""
    jtr, ttr = _pair(eco_nets, TRACE_KW)
    jtr.initialize(_frame(0), INFO)
    ttr.initialize(_frame(0), INFO)
    js, ts = jtr.state, ttr.state
    assert (ttr._sample_sz, ttr._filt_szs) == (jtr._sample_sz, jtr._filt_szs) == (112, [29, 7])
    _filters_close(ts, js)
    factors = np.asarray(TRACE_KW.get("scale_factors", t_eco.ECOParams().scale_factors))
    scale_inds = []
    for t in range(1, 13):
        j_scale = float(jtr.state.target_scale)
        jo = jtr.track(_frame(t))
        with _HostTensors() as made:
            to = ttr.track(_frame(t))
        assert made.count == 1, made.where      # the frame alone
        js, ts = jtr.state, ttr.state
        j_ind = int(np.argmin(np.abs(float(js.target_scale) / j_scale - factors)))
        assert int(ts.scale_ind) == j_ind, t
        scale_inds.append(j_ind)
        np.testing.assert_allclose(to["target_bbox"], jo["target_bbox"], atol=1e-3, rtol=0)
        assert abs(to["max_score"] - jo["max_score"]) <= 1e-4 * max(1, abs(jo["max_score"]))
        assert int(ts.num_stored) == int(js.num_stored)
        assert int(ts.prev_ind) == int(js.prev_ind)
        np.testing.assert_allclose(ts.sample_weights.numpy(), js.sample_weights, atol=1e-6,
                                   rtol=0)
        _filters_close(ts, js)
    assert len(set(scale_inds)) > 1, scale_inds


# ---------------------------------------------------------------- parameters

def test_params_dataclass_matches_jax():
    from pytracking_tpu.trackers.eco import ECOParams

    assert [f.name for f in dataclasses.fields(t_eco.ECOParams)] == \
        [f.name for f in dataclasses.fields(ECOParams)]
    assert ECOParams() == ECOParams(**dataclasses.asdict(t_eco.ECOParams()))


@pytest.mark.parametrize("name", ["default", "mobile3"])
def test_parameter_module_matches_jax(name, monkeypatch, tmp_path):
    """The port module's params equal the JAX module's (env_settings and
    variable loading stubbed, nothing initialised); its net's backbone is
    the module's, on the given device, from the given seed."""
    env = types.SimpleNamespace(network_path=str(tmp_path / "absent"))
    mod = importlib.import_module(f"pytracking_tpu.parameter.eco.{name}")
    monkeypatch.setattr(mod, "env_settings", lambda: env)
    monkeypatch.setattr(mod, "load_or_init_variables", lambda *a, **k: {})
    ref = mod.parameters()
    seen = {}
    port = importlib.import_module(f"pytracking_tpu_torch.parameter.eco.{name}")
    monkeypatch.setattr(port, "eco_backbone",
                        lambda fe, generator, device: seen.update(fe=fe, generator=generator,
                                                                  device=device))
    got = port.parameters(device="cpu", seed=3)
    assert got.params == t_eco.ECOParams(**dataclasses.asdict(ref.params))
    for f in dataclasses.fields(ref.params):
        assert getattr(got.params, f.name) == getattr(ref.params, f.name), f.name
    assert seen["device"] == "cpu" and seen["generator"].initial_seed() == 3
    assert seen["fe"].output_layers == tuple(ref.net.feature_extractor.output_layers)
    assert type(seen["fe"]).__name__ == type(ref.net.feature_extractor).__name__
    assert not (tmp_path / "absent").exists()
