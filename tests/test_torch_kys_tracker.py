"""Parity of the PyTorch port's KYS tracker with `pytracking_tpu.trackers.kys`,
on the CPU, and of its parameter modules with the JAX ones.

The tiny KYS of test_torch_kys.py (the family tests' tiny SuperDiMP-kind
DiMPnet, a response predictor with a 4-channel state, 6x6 motion grid,
96x96 samples, memory 8). The port draws the dropout mask and the box
jitter through `_keep_mask` / `_uniform`; here both return the JAX
tracker's own draws. The JAX tracker runs with frame-shape buckets off.
Limits: flags, replace indices and `num_stored` equal; `have_state`
equal; memory weights within 1e-6; boxes within 1e-3 px; the state vectors,
motion features, labels, filters and memory samples 1e-4 relative to their
scale.

The seeded tiny net's fused peaks on this sequence (JAX tracker) are
0.47204-0.47246; the fused not-found threshold 0.4721 sits between the
found frames' (>= 0.472155) and the lost ones' (<= 0.472044). Without the
mining: frames 1-5 normal, 6-8 not_found; frame 1 seeds the state from the
label, frames 2-3 centre the previous frame (the target left the centre
band), 4-8 remove its sub-pixel offset. With the mining on: frame 1 a hard
negative (the DiMP score at the fused peak is far below its second peak),
then not_found frames that keep the state, each aligned by the centre
shift.
"""

import dataclasses
import importlib
import types

import jax
import numpy as np
import pytest

from pytracking_tpu_torch.trackers import kys as t_kys

from test_torch_dimp_family import BASE, frame
from test_torch_dimp_family_ops import OUT_DIM, _close, _filt, _nchw, _nhwc, _t
from test_torch_kys import tiny_kys_pair

NOT_FOUND = 0.4721
TRACES = {  # name: (extra params, frames, expected flags)
    "plain": (dict(), 8, ["normal"] * 5 + ["not_found"] * 3),
    "hn_mining": (dict(perform_hn_mining_dimp=True), 6,
                  ["hard_negative"] + ["not_found"] * 5),
}
INIT_BBOX = [43.0, 46.0, 18.0, 20.0]


@pytest.fixture(scope="module")
def pair():
    return tiny_kys_pair()


def _trackers(pair, kw, monkeypatch):
    from pytracking_tpu.trackers.kys import KYSParams, KYSTracker

    monkeypatch.setenv("PYTRACKING_TPU_SHAPE_BUCKETS", "0")
    jnet, variables, tnet = pair
    jtr = KYSTracker(KYSParams(**kw), jnet, variables)
    ttr = t_kys.KYSTracker(t_kys.KYSParams(**kw), tnet, device="cpu")
    drop_key = jax.random.split(jax.random.PRNGKey(0))[1]
    n_drop, prob = dict(kw["augmentation"])["dropout"]

    def keep_mask(shape, p):
        assert tuple(shape) == (n_drop, OUT_DIM, 1, 1) and p == prob
        keep = jax.random.bernoulli(drop_key, 1.0 - p, (n_drop, 1, 1, OUT_DIM))
        return _nchw(keep) > 0.5

    ttr._keep_mask = keep_mask
    return jtr, ttr


def _branch(js):
    """The alignment the next frame applies to the previous one, from the
    JAX state: none before a state exists, else the centre shift when the
    previous box centre left the centre band, else the sub-pixel removal."""
    if not bool(js.have_state):
        return "none"
    box = np.asarray(js.prev_box_patch)
    c = box[:2] + box[2:] / 2
    near = np.all((c < 96 * (0.5 + 1 / 5)) & (c > 96 * (0.5 - 1 / 5)))
    return "sub" if near else "center"


def _check_state(ts, js, t):
    assert int(ts.flag) == int(js.flag), t
    assert int(ts.num_stored) == int(js.num_stored), t
    assert int(ts.prev_ind) == int(js.prev_ind), t
    assert bool(ts.have_state) == bool(js.have_state), t
    assert ts.frame_num == int(js.frame_num)
    np.testing.assert_allclose(ts.mem_weights.numpy(), js.mem_weights, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.mem_boxes.numpy(), js.mem_boxes, atol=1e-3, rtol=0)
    np.testing.assert_allclose(ts.prev_box_patch.numpy(), js.prev_box_patch, atol=1e-3, rtol=0)
    _close(_nhwc(ts.mem_samples), js.mem_samples)
    _close(ts.target_filter.numpy(), _filt(js.target_filter))
    _close(_nhwc(ts.state_vector), js.state_vector)
    _close(_nhwc(ts.motion_feat_prev), js.motion_feat_prev)
    _close(_nhwc(ts.prev_label), js.prev_label)


@pytest.mark.parametrize("name", list(TRACES))
def test_kys_trace_matches_jax(name, pair, monkeypatch):
    extra, n, expected = TRACES[name]
    kw = dict(BASE, target_not_found_threshold_fused=NOT_FOUND, **extra)
    jtr, ttr = _trackers(pair, kw, monkeypatch)
    info = {"init_bbox": list(INIT_BBOX)}
    jtr.initialize(frame(0), info)
    ttr.initialize(frame(0), info)
    _check_state(ttr.state, jtr.state, 0)
    flags, branches = [], []
    for t in range(1, n + 1):
        jitter = jax.random.uniform(jax.random.split(jtr.state.key)[1],
                                    (kw["num_init_random_boxes"], 4))
        ttr._uniform = lambda shape, u=_t(jitter): u
        branches.append(_branch(jtr.state))
        jo = jtr.track(frame(t))
        to = ttr.track(frame(t))
        assert to["flag"] == jo["flag"], (t, to, jo)
        np.testing.assert_allclose(to["target_bbox"], jo["target_bbox"], atol=1e-3, rtol=0)
        assert abs(to["max_score"] - jo["max_score"]) <= 1e-4 * max(1, abs(jo["max_score"]))
        _check_state(ttr.state, jtr.state, t)
        flags.append(jo["flag"])
    assert flags == expected, flags
    if name == "plain":
        assert branches == ["none", "center", "center"] + ["sub"] * 5, branches
    else:
        assert branches == ["none"] + ["center"] * 5, branches


# ---------------------------------------------------------------- parameter modules

class _StubNet:
    """Stands in for the JAX net in the JAX parameter module: `init` gives
    empty variables."""

    def init(self, *args, **kwargs):
        return {"params": {}, "batch_stats": {}}


def test_params_dataclass_matches_jax():
    from pytracking_tpu.trackers.kys import KYSParams

    ref = [f.name for f in dataclasses.fields(KYSParams)]
    assert [f.name for f in dataclasses.fields(t_kys.KYSParams)] == ref
    assert KYSParams() == KYSParams(**dataclasses.asdict(t_kys.KYSParams()))


@pytest.mark.parametrize("name", ["default", "default_vot"])
def test_parameter_module_matches_jax(name, monkeypatch, tmp_path):
    jdefault = importlib.import_module("pytracking_tpu.parameter.kys.default")
    monkeypatch.setattr(jdefault, "kysnet_res50", _StubNet)
    monkeypatch.setattr(jdefault, "env_settings",
                        lambda: types.SimpleNamespace(network_path=str(tmp_path)))
    ref = importlib.import_module(f"pytracking_tpu.parameter.kys.{name}").parameters().params
    port = importlib.import_module(f"pytracking_tpu_torch.parameter.kys.{name}")
    built = {}
    monkeypatch.setattr(port, "kysnet_res50", lambda **k: built.setdefault("net", k))
    got = port.parameters(device="cpu", seed=3)
    for f in dataclasses.fields(ref):
        assert getattr(got.params, f.name) == getattr(ref, f.name), f.name
    assert built["net"]["device"] == "cpu" and built["net"]["generator"].initial_seed() == 3
    assert got.tracker_kwargs == {}
