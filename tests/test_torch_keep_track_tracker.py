"""Parity of the PyTorch port's KeepTrack tracker with
`pytracking_tpu.trackers.keep_track`, on the CPU, and of its parameter
modules with the JAX ones.

The family tests' tiny SuperDiMP-kind DiMPnet and the tiny matching net of
test_torch_keep_track.py (256-channel descriptors, which the JAX tracker
assumes), 128x128 samples (9x9 score maps), K = 4 candidates, memory 8.
The JAX tracker runs its device association with frame-shape buckets off;
its draws are fed to the port through `_keep_mask` / `_uniform`.

The seeded tiny net's score maps are smooth, with one local maximum each.
Both trackers therefore add the same fixed pattern, 0.2 cos(2πi/5)
cos(2πj/5) over the score cells, to the classifier's scores, which gives 2-4
candidates per frame. On this sequence (JAX tracker): frame 1 takes DiMP's
localisation (no previous candidates) with a peak of 0.35146, below the
not-found threshold 0.36: not_found, and the search area is rescaled; then
every frame goes through the association (peaks 0.347-0.376), which gives
new object ids on every frame and keeps others, and reselects the
strongest candidate. Limits: flags, replace indices, `num_stored`, the
candidates' validity and the association state equal; memory weights
within 1e-6; boxes within 1e-3 px; filters, memory samples and descriptors
1e-4 relative to their scale.
"""

import dataclasses
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytracking_tpu_torch.trackers import keep_track as t_kt

from test_torch_dimp_family import SUPER, pair
from test_torch_dimp_family_ops import OUT_DIM, _close, _filt, _nchw, _nhwc, _t
from test_torch_keep_track import tiny_tcm_pair

S, K, N_FRAMES = 128, 4, 8
KW = dict(SUPER, image_sample_size=S, max_candidates=K, target_not_found_threshold=0.36,
          local_max_candidate_score_th=0.05, train_skipping=3)
INIT = {"init_bbox": [40.0, 44.0, 20.0, 22.0]}
_cells = np.arange(S // 16 + 1)
BUMP = (0.2 * np.cos(2 * np.pi * _cells / 5)[:, None]
        * np.cos(2 * np.pi * _cells / 5)[None, :]).astype(np.float32)
ASSOC = ("assoc_object_ids", "assoc_selected_oid", "assoc_flag", "assoc_id_cntr",
         "assoc_active", "prev_cand_valid")


def frame(t, H=112, W=144):
    """A red target moving (+2, +3) px per frame and a reddish distractor
    moving left, on a noise background."""
    im = np.random.RandomState(0).randint(0, 120, (H, W, 3)).astype(np.uint8)
    cy, cx = 56 + 2 * t, 52 + 3 * t
    im[max(cy - 10, 0):cy + 10, max(cx - 9, 0):cx + 9] = [220, 60, 60]
    dx = 100 - 2 * t
    im[31:49, dx - 8:dx + 8] = [200, 70, 50]
    return im


def _snapshot(st, out):
    names = ("flag", "num_stored", "prev_ind", "mem_weights", "mem_boxes", "mem_samples",
             "mem_certainties", "target_filter", "prev_cand_desc", "prev_cand_scores",
             "prev_cand_img_coords", "scale_history", "target_not_found_counter",
             "target_scale", "assoc_hist_scores") + ASSOC
    return {"out": out, **{n: np.asarray(getattr(st, n)) for n in names}}


@pytest.fixture(scope="module")
def trace():
    """The JAX tracker's run: (the nets, per frame its draws and snapshot)."""
    from pytracking_tpu.trackers.keep_track import KeepTrackParams, KeepTrackTracker

    mp = pytest.MonkeyPatch()
    mp.setenv("PYTRACKING_TPU_SHAPE_BUCKETS", "0")
    try:
        jnet, variables, tnet = pair("superdimp")
        jtcm, tcm_vars, ttcm = tiny_tcm_pair(K=K, desc=256, image_shape=(S, S))
        jtr = KeepTrackTracker(KeepTrackParams(**KW), jnet, variables, tcm_net=jtcm,
                               tcm_variables=tcm_vars)
        orig = jtr._classify
        bump = jnp.asarray(BUMP)[None, :, :, None]
        jtr._classify = lambda w, f: orig(w, f) + bump
        jtr.initialize(frame(0), INIT)
        frames = [_snapshot(jtr.state, None)]
        for t in range(1, N_FRAMES + 1):
            jitter = jax.random.uniform(jax.random.split(jtr.state.key)[1],
                                        (KW["num_init_random_boxes"], 4))
            out = jtr.track(frame(t))
            frames.append(dict(_snapshot(jtr.state, out), jitter=np.asarray(jitter)))
    finally:
        mp.undo()
    return tnet, ttcm, frames


def _port_tracker(tnet, ttcm, monkeypatch, device_association):
    monkeypatch.setattr(tnet.classifier, "classify",
                        lambda w, f, orig=tnet.classifier.classify: orig(w, f) + _t(BUMP))
    ttr = t_kt.KeepTrackTracker(t_kt.KeepTrackParams(**KW), tnet, ttcm, device="cpu",
                                device_association=device_association)
    drop_key = jax.random.split(jax.random.PRNGKey(0))[1]
    n_drop, prob = dict(KW["augmentation"])["dropout"]

    def keep_mask(shape, p):
        assert tuple(shape) == (n_drop, OUT_DIM, 1, 1) and p == prob
        return _nchw(jax.random.bernoulli(drop_key, 1.0 - p, (n_drop, 1, 1, OUT_DIM))) > 0.5

    ttr._keep_mask = keep_mask
    return ttr


def _check(ts, ref, t, assoc=ASSOC):
    for name in ("flag", "num_stored", "prev_ind", "target_not_found_counter") + assoc:
        np.testing.assert_array_equal(np.asarray(getattr(ts, name)), ref[name],
                                      err_msg=f"{name} at frame {t}")
    np.testing.assert_allclose(ts.mem_weights.numpy(), ref["mem_weights"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.mem_boxes.numpy(), ref["mem_boxes"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(ts.mem_certainties.numpy(), ref["mem_certainties"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(ts.scale_history.numpy(), ref["scale_history"], rtol=1e-5)
    np.testing.assert_allclose(float(ts.target_scale), ref["target_scale"], rtol=1e-5)
    if "assoc_object_ids" in assoc:
        np.testing.assert_allclose(ts.assoc_hist_scores.numpy(), ref["assoc_hist_scores"],
                                   atol=1e-5)
    np.testing.assert_allclose(ts.prev_cand_scores.numpy(), ref["prev_cand_scores"], atol=1e-5)
    np.testing.assert_array_equal(ts.prev_cand_img_coords.numpy(), ref["prev_cand_img_coords"])
    _close(ts.prev_cand_desc.numpy(), ref["prev_cand_desc"])
    _close(_nhwc(ts.mem_samples), ref["mem_samples"])
    _close(ts.target_filter.numpy(), _filt(ref["target_filter"]))


@pytest.mark.parametrize("device_association", [True, False], ids=["device", "split"])
def test_keep_track_trace_matches_jax(trace, monkeypatch, device_association):
    """Init + 8 frames of the port against the JAX tracker's device
    association: with the port's device association, and with its split
    path (the host `CandidateCollection`) against the same JAX run."""
    tnet, ttcm, frames = trace
    ttr = _port_tracker(tnet, ttcm, monkeypatch, device_association)
    ttr.initialize(frame(0), INIT)
    _check(ttr.state, frames[0], 0)
    flags, n_valid, new_ids, cntr = [], [], 0, 0
    for t in range(1, N_FRAMES + 1):
        ref = frames[t]
        ttr._uniform = lambda shape, u=_t(ref["jitter"]): u
        to = ttr.track(frame(t))
        jo = ref["out"]
        assert to["flag"] == jo["flag"], (t, to, jo)
        np.testing.assert_allclose(to["target_bbox"], jo["target_bbox"], atol=1e-3, rtol=0)
        for name in ("max_score", "object_presence_score"):
            assert abs(to[name] - jo[name]) <= 1e-4 * max(1, abs(jo[name])), (t, name)
        if device_association:
            _check(ttr.state, ref, t)
        else:
            # the split path keeps the association in the host's collection
            _check(ttr.state, ref, t, assoc=("prev_cand_valid",))
            cc = ttr.candidate_collection
            n = int(ref["prev_cand_valid"].sum())
            assert [cc.candidates[i].object_id for i in range(n)] == \
                ref["assoc_object_ids"][:n].tolist(), t
            assert cc.object_id_of_selected_candidate == int(ref["assoc_selected_oid"]), t
        flags.append(to["flag"])
        n_valid.append(int(ttr.state.prev_cand_valid.sum()))
        new_ids += t > 1 and int(ref["assoc_id_cntr"]) > cntr
        cntr = int(ref["assoc_id_cntr"])
    # what the trace covers
    assert flags[0] == "not_found" and flags[1:] == ["normal"] * (N_FRAMES - 1), flags
    assert int(frames[1]["target_not_found_counter"]) == 1
    assert min(n_valid) >= 2 and max(n_valid) == K, n_valid
    assert new_ids == N_FRAMES - 1


# ---------------------------------------------------------------- parameter modules

def test_params_dataclass_matches_jax():
    from pytracking_tpu.trackers.keep_track import KeepTrackParams

    ref = [f.name for f in dataclasses.fields(KeepTrackParams)]
    assert [f.name for f in dataclasses.fields(t_kt.KeepTrackParams)] == ref
    assert KeepTrackParams() == KeepTrackParams(**dataclasses.asdict(t_kt.KeepTrackParams()))
    from pytracking_tpu.trackers.dimp import DiMPTracker
    from pytracking_tpu.trackers.keep_track import KeepTrackTracker

    for jcls, tcls in ((DiMPTracker, t_kt.DiMPTracker), (KeepTrackTracker, t_kt.KeepTrackTracker)):
        assert tcls.supports_deferred_classifier_update is \
            jcls.supports_deferred_classifier_update


@pytest.mark.parametrize("name", ["default", "default_fast"])
def test_parameter_module_matches_jax(name, monkeypatch, tmp_path):
    jdefault = importlib.import_module("pytracking_tpu.parameter.keep_track.default")
    made = {}
    monkeypatch.setattr(jdefault, "dimpnet50", lambda: "dimpnet50")
    monkeypatch.setattr(jdefault, "target_candidate_matching_net_resnet50",
                        lambda **k: made.setdefault("tcm", k))
    monkeypatch.setattr(jdefault, "load_or_init_variables", lambda *a, **k: {})
    monkeypatch.setattr(jdefault, "env_settings",
                        lambda: types.SimpleNamespace(network_path=str(tmp_path)))
    spec = importlib.import_module(f"pytracking_tpu.parameter.keep_track.{name}").parameters()
    port = importlib.import_module("pytracking_tpu_torch.parameter.keep_track.default")
    built = {}
    monkeypatch.setattr(port, "dimpnet50", lambda **k: built.setdefault("net", k))
    monkeypatch.setattr(port, "target_candidate_matching_net_resnet50",
                        lambda **k: built.setdefault("tcm", k))
    got = importlib.import_module(
        f"pytracking_tpu_torch.parameter.keep_track.{name}").parameters(device="cpu", seed=3)
    for f in dataclasses.fields(spec.params):
        assert getattr(got.params, f.name) == getattr(spec.params, f.name), f.name
    # both build the matching net at the default module's sample size
    assert made["tcm"]["image_shape"] == (480, 480) == built["tcm"]["image_shape"]
    assert built["net"]["device"] == built["tcm"]["device"] == "cpu"
    assert built["net"]["generator"].initial_seed() == 3
    assert got.tracker_kwargs == {"tcm_net": built["tcm"]}
    assert built["tcm"]["generator"].initial_seed() == 4
