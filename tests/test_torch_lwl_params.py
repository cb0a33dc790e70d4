"""The port's LWL / RTS parameter modules and converters at full width, on
the CPU: `lwl_ytvos`, `lwl_boxinit` and `rts50` against the JAX modules'
parameters; each converter on the full-width JAX variable tree; one
full-width LWL-YTVOS segmentation forward (128x224) against JAX, in float32
and with `weights_bf16` against `maybe_bf16_variables`.

The JAX modules run with their net constructors, `env_settings` and
`load_or_init_variables` replaced by stubs, so no JAX net is initialised.
The full-width variable trees are the JAX `net.init` trees of the JAX
parameter modules' example inputs, taken by `jax.eval_shape` (no compile)
and filled from a seed: kernels lecun-scaled, biases and BatchNorm shifts
small, variances in [0.5, 1.5]. Forward tolerance: 1e-4 relative to the
larger of 1 and the output's largest magnitude.
"""

import copy
import dataclasses
import functools
import importlib
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytracking_tpu_torch.models.layers.blocks import BatchNorm
from pytracking_tpu_torch.trackers import lwl as t_lwl
from pytracking_tpu_torch.trackers import rts as t_rts
from pytracking_tpu_torch.utils import convert_weights as cw
from pytracking_tpu_torch.utils.loading import round_to_bf16_

from test_torch_dimp_family_ops import _close
from test_torch_lwl_ops import one_thread  # noqa: F401 (autouse: one CPU thread)

# parameter module: (package, JAX net constructor name)
MODULES = {"lwl_ytvos": ("lwl", "steepest_descent_resnet50"),
           "lwl_boxinit": ("lwl", "steepest_descent_resnet50_boxinit"),
           "rts50": ("rts", "rts50")}


class _StubNet:
    """Stands in for the JAX net: `init` gives empty variables."""

    def init(self, *args, **kwargs):
        return {"params": {}, "batch_stats": {}}


@pytest.mark.parametrize("params_cls,ref", [("lwl", "LWLParams"), ("rts", "RTSParams")])
def test_params_dataclasses_match_jax(params_cls, ref):
    jmod = importlib.import_module(f"pytracking_tpu.trackers.{params_cls}")
    tmod = {"lwl": t_lwl, "rts": t_rts}[params_cls]
    jcls, tcls = getattr(jmod, ref), getattr(tmod, ref)
    assert [f.name for f in dataclasses.fields(tcls)] == [f.name for f in dataclasses.fields(jcls)]
    assert jcls() == jcls(**dataclasses.asdict(tcls()))


@pytest.mark.parametrize("name", list(MODULES))
def test_parameter_module_matches_jax(name, monkeypatch, tmp_path):
    """The JAX module's tracker parameters; the port's full-width net on the
    CPU from the seed, every weight finite (bf16-representable with
    `weights_bf16`); RTS's lazy STA factory builds STA on the CPU."""
    package, ctor = MODULES[name]
    jmod = importlib.import_module(f"pytracking_tpu.parameter.{package}.{name}")
    monkeypatch.setattr(jmod, ctor, lambda *a, **k: _StubNet())
    monkeypatch.setattr(_StubNet, "box_forward", None, raising=False)
    monkeypatch.setattr(jmod, "env_settings",
                        lambda: types.SimpleNamespace(network_path=str(tmp_path)))
    monkeypatch.setattr(jmod, "load_or_init_variables", lambda *a, **k: {})
    ref = jmod.parameters()
    port = importlib.import_module(f"pytracking_tpu_torch.parameter.{package}.{name}")
    spec = port.parameters(device="cpu", seed=3)
    assert spec.params == type(spec.params)(**dataclasses.asdict(ref.params))
    for f in dataclasses.fields(ref.params):
        assert getattr(spec.params, f.name) == getattr(ref.params, f.name), f.name
    sd = spec.net.state_dict()
    assert all(bool(torch.isfinite(v).all()) for v in sd.values())
    assert sum(v.numel() for v in spec.net.parameters()) > 20e6
    # the same net again (a copy, not redrawn) through the module's bf16 switch
    monkeypatch.setattr(port, ctor, lambda **k: copy.deepcopy(spec.net))
    again = port.parameters(device="cpu", seed=3, weights_bf16=True).net.state_dict()
    for k, v in sd.items():
        if v.dtype == torch.float32:
            torch.testing.assert_close(again[k], v.to(torch.bfloat16).float(), rtol=0, atol=0)
    if name == "rts50":
        assert set(spec.tracker_kwargs) == {"sta_factory"}
        sta = spec.tracker_kwargs["sta_factory"]()
        assert next(sta.parameters()).device.type == "cpu"
    else:
        assert spec.tracker_kwargs == {}


# ---------------------------------------------------------------- converters

def _fill(shapes, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "var":
            return (rng.rand(*s.shape) + 0.5).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if name == "filter_reg":
            return np.full(s.shape, 0.01, np.float32)
        return (0.05 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _full_width(name):
    """(JAX net, its full-width variables filled from a seed, the port's net
    on the meta device (keys and shapes, no weights drawn), the converter)
    for each converter's net."""
    from pytracking_tpu.models.lwl.lwl_net import (steepest_descent_resnet50,
                                                   steepest_descent_resnet50_boxinit)
    from pytracking_tpu.models.lwl.sta_net import sta_resnet50
    from pytracking_tpu.models.rts.rts_net import rts50

    from pytracking_tpu_torch.models.lwl import lwl_net as t_lwl_net
    from pytracking_tpu_torch.models.lwl import sta_net as t_sta_net
    from pytracking_tpu_torch.models.rts import rts_net as t_rts_net

    def meta(ctor):
        with mock.patch.object(t_lwl_net, "init_weights", lambda net, g: net), \
                mock.patch.object(t_sta_net, "init_weights", lambda net, g: net), \
                mock.patch.object(t_rts_net, "init_weights", lambda net, g: net), \
                torch.device("meta"):
            return ctor(device="meta")

    im, mask = jnp.zeros((1, 1, 128, 128, 3)), jnp.zeros((1, 1, 128, 128))
    bb = jnp.array([[[30.0, 30.0, 50.0, 50.0]]])
    k = jax.random.PRNGKey(0)
    if name == "lwtlnet":
        jnet = steepest_descent_resnet50(filter_size=3, num_filters=16, optim_iter=5,
                                         out_feature_dim=512, label_encoder_dims=(16, 32, 64))
        shapes = jax.eval_shape(lambda: jnet.init(k, im, im, mask))
        return jnet, _fill(shapes, 1), meta(t_lwl_net.steepest_descent_resnet50), \
            cw.lwtlnet_from_flax
    if name == "lwtlboxnet":
        jnet = steepest_descent_resnet50_boxinit()
        main = jax.eval_shape(lambda: jnet.init(k, im, im, mask, num_refinement_iter=0,
                                                train=False))
        box = jax.eval_shape(lambda: jnet.init(k, im, bb, train=False, method=jnet.box_forward))
        shapes = {c: {**main[c], **box[c]} for c in ("params", "batch_stats")}
        return jnet, _fill(shapes, 2), meta(t_lwl_net.steepest_descent_resnet50_boxinit), \
            cw.lwtlboxnet_from_flax
    if name == "stanet":
        jnet = sta_resnet50()
        shapes = jax.eval_shape(lambda: jnet.init(k, im, bb))
        return jnet, _fill(shapes, 3), meta(t_sta_net.sta_resnet50), cw.stanet_from_flax
    jnet = rts50()
    shapes = jax.eval_shape(lambda: jnet.init(k, im, im, mask, bb))
    return jnet, _fill(shapes, 4), meta(t_rts_net.rts50), cw.rtsnet_from_flax


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("name", ["lwtlnet", "lwtlboxnet", "stanet", "rtsnet"])
def test_full_width_converter_round_trips(name):
    """Every flax leaf lands in its torch key (kernels HWIO -> OIHW,
    BatchNorm scale / mean / var as weight / running_mean / running_var),
    the result holds exactly the port's keys and shapes, and an extra leaf
    raises."""
    _, v, tnet, convert = _full_width(name)
    sd = convert(v, tnet)
    names = {"scale": "weight", "mean": "running_mean", "var": "running_var",
             "kernel": "weight"}
    n = 0
    for collection in ("params", "batch_stats"):
        for path, arr in _flat(v[collection]):
            key = ".".join(path[:-1] + (names.get(path[-1], path[-1]),))
            want = arr.transpose(3, 2, 0, 1) if path[-1] == "kernel" else arr
            np.testing.assert_array_equal(sd[key].numpy(), want, err_msg=key)
            n += 1
    assert n == len(sd)
    extra = {"params": {**v["params"], "decoder": {**v["params"]["decoder"],
                                                   "stray": {"bias": np.zeros(1, np.float32)}}},
             "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError):
        convert(extra, tnet)


# ---------------------------------------------------------------- forward

def _inputs(H=128, W=224):
    rng = np.random.RandomState(5)
    im = rng.rand(1, H, W, 3).astype(np.float32) * 255
    mask = np.zeros((1, 1, H, W), np.float32)
    mask[0, 0, 30:90, 60:150] = 1.0
    return im, mask


def _jax_forward(jnet, v, exact=False):
    """The tracker's segmentation path on one frame, jitted: backbone,
    target-model features, label encoding of a mask, a 3-step filter fit,
    the decoder. `exact` compiles with XLA's excess precision off, so that
    every bf16 operation rounds to bf16 as flax's op-by-op definition does."""
    im, mask = _inputs()

    def f(m, im, mask):
        bf = m.extract_backbone(im)
        x = m.extract_target_model_features(bf)
        lab, sw = m.label_encode(mask, x[:, None])
        filt = m.tm_get_filter(x[:, None], lab, sw, num_iter=3)[0]
        return m.segment_target(filt, x[:, None], bf, im.shape[1:3])[0], lab

    args = (v, jnp.asarray(im), jnp.asarray(mask))
    lowered = jax.jit(lambda v, a, b: jnet.apply(v, a, b, method=f)).lower(*args)
    options = {"xla_allow_excess_precision": False} if exact else None
    seg, lab = lowered.compile(compiler_options=options)(*args)
    return np.asarray(seg, np.float64), np.asarray(lab)


def _torch_forward(tnet):
    im, mask = _inputs()
    with torch.no_grad():
        bf = tnet.extract_backbone(torch.from_numpy(im).permute(0, 3, 1, 2))
        x = tnet.extract_target_model_features(bf)
        lab, sw = tnet.label_encode(torch.from_numpy(mask), x[:, None])
        filt = tnet.tm_get_filter(x[:, None], lab, sw, num_iter=3)
        seg, _ = tnet.segment_target(filt, x[:, None], bf, im.shape[1:3])
    return seg[0].numpy(), np.moveaxis(lab.numpy(), 2, -1)


@pytest.fixture(scope="module")
def full_lwl():
    """The full-width JAX LWL, its variables, and the port's net from
    `lwl_ytvos.parameters(device="cpu")` with those weights."""
    jnet, v, _, _ = _full_width("lwtlnet")
    tnet = importlib.import_module("pytracking_tpu_torch.parameter.lwl.lwl_ytvos").parameters(
        device="cpu").net
    tnet.load_state_dict(cw.lwtlnet_from_flax(v, tnet))
    return jnet, v, tnet


def test_full_width_lwl_forward_matches_jax(full_lwl):
    jnet, v, tnet = full_lwl
    got, got_lab = _torch_forward(tnet)
    ref, ref_lab = _jax_forward(jnet, v)
    assert got.shape == (128, 224) and np.isfinite(got).all()
    assert np.abs(ref).max() > 1.0                 # not a vanishing output
    _close(got_lab, ref_lab, atol=1e-4)
    _close(got, ref, atol=1e-4)


def test_full_width_lwl_bf16_weights_match_jax(full_lwl, monkeypatch):
    """`weights_bf16` (round_to_bf16_: weights rounded, float32 compute,
    BatchNorm's multiplier in bf16) against the JAX net on
    `maybe_bf16_variables` with PYTRACKING_TPU_BF16=1: flax promotes bf16
    weights to float32 activations and computes rsqrt(var + eps) * scale in
    bf16. The JAX side is compiled with XLA's excess precision off: with it
    on (the default) some of those bf16 multipliers stay float32 and others
    not (0.3-0.6% of scale from the op-by-op result at layer1-layer4 on
    this input), which would measure the compiler, not the port."""
    from pytracking_tpu.utils.loading import maybe_bf16_variables

    jnet, v, tnet = full_lwl
    monkeypatch.setenv("PYTRACKING_TPU_BF16", "1")
    v16 = maybe_bf16_variables(v)
    assert all(x.dtype == jnp.bfloat16 for x in jax.tree_util.tree_leaves(v16))
    got32, _ = _torch_forward(tnet)
    net16 = round_to_bf16_(copy.deepcopy(tnet))
    assert all(m.param_dtype == torch.bfloat16 for m in net16.modules()
               if isinstance(m, BatchNorm))
    got, got_lab = _torch_forward(net16)
    ref, ref_lab = _jax_forward(jnet, v16, exact=True)
    _close(got_lab, ref_lab, atol=1e-4)
    _close(got, ref, atol=1e-4)
    assert np.abs(got - got32).max() > 1e-3        # the rounding shows in the output
