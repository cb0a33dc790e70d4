"""Parity of the PyTorch port's DiMP-family trackers with
`pytracking_tpu.trackers.dimp`, on the CPU: init + 10 frames of PrDiMP-50,
SuperDiMP, SuperDiMP-simple and DiMP-18 (tiny nets: a ResNet with one block
per stage at base width 16, BasicBlocks for the 18-variants, 64-channel
classification features, 96x96 samples, random BatchNorm statistics). The
tracker's other options are in test_torch_dimp_family_options.py.

The port draws the dropout mask and the box jitter through `_keep_mask` /
`_uniform`; here both return the JAX tracker's own draws, from its key with
its splits. The JAX tracker runs with frame-shape buckets off, so both read
the same image (the crop's inside modes use the true size). Limits: flags,
replace indices and `num_stored` equal; memory weights within 1e-6; boxes
within 1e-3 px; filters and memory samples 1e-4 relative to their scale.
"""

import jax
import numpy as np
import pytest

from pytracking_tpu_torch.trackers import dimp as t_dimp

from test_torch_dimp_family_ops import OUT_DIM, _close, _filt, _nchw, _nhwc, _t, tiny_pair

BASE = dict(image_sample_size=96, sample_memory_size=8, net_opt_iter=3, net_opt_update_iter=2,
            net_opt_hn_iter=1,
            augmentation=(("fliplr", True), ("rotate", (10,)), ("blur", ((2, 1),)),
                          ("relativeshift", ((0.6, 0.6),)), ("dropout", (1, 0.2))),
            num_init_random_boxes=3, box_refinement_iter=2, iounet_k=2, train_skipping=4)
# PrDiMP / SuperDiMP's deltas: 'inside_major' crops with a scale change of
# at most 1.5, three refinement steps of 2.5e-3 in the relative box space
SUPER = dict(BASE, search_area_scale=6.0, border_mode="inside_major",
             patch_max_scale_change=1.5, box_refinement_space="relative",
             box_refinement_iter=3, box_refinement_step_length=2.5e-3)

# name: (tiny net, params, frame size (H, W), init box, expected optimiser
# iterations per frame or None). The thresholds sit where the tiny net's
# peaks give normal frames, hard negatives and refits, each peak clear of
# each threshold it meets by far more than float32 rounding.
TRACES = {
    "prdimp50": ("prdimp50", dict(SUPER, score_preprocess="softmax", softmax_reg=None,
                                  target_not_found_threshold=0.05),
                 (104, 120), [40.0, 44.0, 20.0, 22.0], None),
    "superdimp": ("superdimp", dict(SUPER, target_not_found_threshold=0.185),
                  (104, 120), [40.0, 44.0, 20.0, 22.0], None),
    "superdimp_simple": ("simple", dict(SUPER, target_not_found_threshold=0.185),
                         (104, 120), [40.0, 44.0, 20.0, 22.0], None),
    "dimp18": ("dimp18", dict(BASE, target_not_found_threshold=0.185),
               (128, 128), [43.0, 46.0, 18.0, 20.0], None),
}
_PAIRS = {}


def pair(kind):
    if kind not in _PAIRS:
        _PAIRS[kind] = tiny_pair(kind)
    return _PAIRS[kind]


def frame(t, H=128, W=128):
    """A red 20x18 target moving (+2, +3) px per frame towards the lower
    right."""
    im = np.full((H, W, 3), 30, np.uint8)
    cy, cx = 56 + 2 * t, 52 + 3 * t
    im[max(cy - 10, 0):cy + 10, max(cx - 9, 0):cx + 9] = [220, 60, 60]
    return im


def _trackers(kind, kw, monkeypatch):
    from pytracking_tpu.trackers.dimp import DiMPParams, DiMPTracker

    monkeypatch.setenv("PYTRACKING_TPU_SHAPE_BUCKETS", "0")
    jnet, variables, tnet = pair(kind)
    jtr = DiMPTracker(DiMPParams(**kw), jnet, variables)
    ttr = t_dimp.DiMPTracker(t_dimp.DiMPParams(**kw), tnet, device="cpu")
    augs = dict(kw["augmentation"]) if kw.get("use_augmentation", True) else {}
    if "dropout" in augs:
        drop_key = jax.random.split(jax.random.PRNGKey(0))[1]
        n_drop, prob = augs["dropout"]

        def keep_mask(shape, p):
            assert tuple(shape) == (n_drop, OUT_DIM, 1, 1) and p == prob
            keep = jax.random.bernoulli(drop_key, 1.0 - p, (n_drop, 1, 1, OUT_DIM))
            return _nchw(keep) > 0.5

        ttr._keep_mask = keep_mask
    return jtr, ttr


def _feed_jitter(jtr, ttr, kw):
    jitter = jax.random.uniform(jax.random.split(jtr.state.key)[1],
                                (kw["num_init_random_boxes"], 4))
    ttr._uniform = lambda shape, u=_t(jitter): u


def _check_state(ts, js, t):
    assert int(ts.flag) == int(js.flag), t
    assert int(ts.num_stored) == int(js.num_stored), t
    assert int(ts.prev_ind) == int(js.prev_ind), t
    assert ts.frame_num == int(js.frame_num)
    np.testing.assert_allclose(ts.mem_weights.numpy(), js.mem_weights, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.mem_boxes.numpy(), js.mem_boxes, atol=1e-3, rtol=0)
    _close(_nhwc(ts.mem_samples), js.mem_samples)
    _close(ts.target_filter.numpy(), _filt(js.target_filter))


def run_trace(kind, kw, monkeypatch, size=(128, 128), init_bbox=(43.0, 46.0, 18.0, 20.0),
              n=10, on_frame=None):
    """init + n frames on both trackers, each frame held to the limits.
    Returns (the flags, the port's optimiser iterations per frame, the JAX
    and the port's tracker)."""
    jtr, ttr = _trackers(kind, kw, monkeypatch)
    info = {"init_bbox": list(init_bbox)}
    jtr.initialize(frame(0, *size), info)
    ttr.initialize(frame(0, *size), info)
    _close(_nhwc(ttr.state.mem_samples), jtr.state.mem_samples)
    _close(ttr.state.target_filter.numpy(), _filt(jtr.state.target_filter))
    flags, iters = [], []
    for t in range(1, n + 1):
        if kw.get("use_iou_net", True):
            _feed_jitter(jtr, ttr, kw)
        else:
            ttr._uniform = None             # without IoU-Net nothing is drawn
        jo = jtr.track(frame(t, *size))
        to = ttr.track(frame(t, *size))
        assert to["flag"] == jo["flag"], (t, to, jo)
        np.testing.assert_allclose(to["target_bbox"], jo["target_bbox"], atol=1e-3, rtol=0)
        assert abs(to["max_score"] - jo["max_score"]) <= 1e-4 * max(1, abs(jo["max_score"]))
        _check_state(ttr.state, jtr.state, t)
        flags.append(jo["flag"])
        iters.append(ttr._classifier_iterations(t_dimp.FLAG_NAMES.index(to["flag"]),
                                                ttr.state.frame_num))
        if on_frame is not None:
            on_frame(t, jtr, ttr, jo, to)
    return flags, iters, jtr, ttr


@pytest.mark.parametrize("name", list(TRACES))
def test_family_trace_matches_jax(name, monkeypatch):
    kind, kw, size, bbox, expected = TRACES[name]
    flags, iters, _, ttr = run_trace(kind, kw, monkeypatch, size=size, init_bbox=bbox)
    # the trace ran the memory update and at least one refit
    assert int(ttr.state.num_stored) > int(ttr.state.num_init), flags
    assert max(iters) > 0, (flags, iters)
    if expected is not None:
        assert iters == expected, (flags, iters)

