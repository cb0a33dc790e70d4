"""Parity of the PyTorch port's LWL trackers with the JAX ones, on the CPU,
with the tiny nets of test_torch_lwl_ops.py (that of tests/test_lwl.py: a
BasicBlock ResNet of one block per stage at width 8, 64x64 crops, so that
layer4's 2x2 grid takes the antialiased downsample of the scores; memory
4): `LWLTracker` from a mask (feeding itself, and in the harness's
multi-object convention), from a box (the box label encoder),
`LWLMultiObjectTracker` on two objects, `merge_results`; and the LWL
converters. test_torch_rts.py holds RTS and STA on the same sequence.

The sequence: 120x160 frames over a seeded textured background, a red
ellipse (object 1) drifting 2 px down and 3 px right per frame and a green
rectangle (object 2) drifting the other way.

Limits: masks equal except at pixels within 1e-4 (logit) of the threshold;
probabilities and raw logits within 1e-4 of their scale (the largest
magnitude inside the crop, at least 1); boxes within 1e-3 px; memory
weights within 1e-6; `num_stored`, RTS's `lost_counter` and the classifier
memory count equal. The multi-object label map: equal except where JAX's
two largest aggregated probabilities are within 1e-5 (ties between two
objects' near-identical random-net scores), at most 1e-3 of the pixels.
"""

import jax
import numpy as np
import pytest
import torch

from pytracking_tpu_torch.trackers import lwl as t_lwl
from pytracking_tpu_torch.utils import convert_weights as cw

from test_torch_lwl_ops import close, tiny_boxnet_pair, tiny_lwl_pair
from test_torch_lwl_ops import one_thread  # noqa: F401 (autouse: one CPU thread)

H, W = 120, 160
SMALL = dict(image_sample_size=(64, 64), sample_memory_size=4, net_opt_iter=2,
             net_opt_update_iter=1)


def frame(t, blank=()):
    """(image, label map): object 1 an ellipse, object 2 a rectangle; a
    frame in `blank` is uniform grey."""
    rng = np.random.RandomState(0)
    im = rng.randint(0, 90, (H, W, 3)).astype(np.uint8)
    lab = np.zeros((H, W), np.uint8)
    yy, xx = np.mgrid[:H, :W]
    ell = ((yy - 60 - 2 * t) / 14.0) ** 2 + ((xx - 60 - 3 * t) / 10.0) ** 2 <= 1
    im[ell] = [220, 60, 60]
    lab[ell] = 1
    im[30 + t:50 + t, 110 - 2 * t:130 - 2 * t] = [60, 200, 80]
    lab[30 + t:50 + t, 110 - 2 * t:130 - 2 * t] = 2
    if t in blank:
        im = np.full_like(im, 128)
    return im, lab


def _box(mask):
    ys, xs = np.nonzero(mask)
    return [float(xs.min()), float(ys.min()), float(xs.max() - xs.min() + 1),
            float(ys.max() - ys.min() + 1)]


def _check_mask(got, ref, prob):
    """Binary masks equal except within 1e-4 (logit) of the threshold."""
    diff = got != ref
    assert np.all(np.abs(np.asarray(prob)[diff] - 0.5) < 2.5e-5), int(diff.sum())


def _check_scores(got, ref):
    """Within 1e-4 of the largest magnitude inside the crop (not -100)."""
    ref = np.asarray(ref, np.float64)
    inside = ref > -100.0
    scale = max(1.0, np.abs(ref[inside]).max()) if inside.any() else 1.0
    np.testing.assert_allclose(got, ref, atol=1e-4 * scale, rtol=0)


def _check_lwl_state(ts, js, o=0):
    """The port's object `o` against a JAX single-object state."""
    assert ts.num_stored == int(js.num_stored) and ts.frame_num == int(js.frame_num)
    np.testing.assert_allclose(ts.mem_weights[o].numpy(), js.mem_weights, atol=1e-6, rtol=0)
    assert int(ts.prev_ind[o]) == int(js.prev_ind)
    close(ts.target_filter[o:o + 1].numpy().transpose(0, 3, 4, 2, 1), js.target_filter)
    close(np.moveaxis(ts.mem_masks[:, o].numpy(), 0, 0), js.mem_masks)
    close(np.moveaxis(ts.mem_samples[:, o].numpy(), 1, -1), js.mem_samples)
    np.testing.assert_allclose(ts.pos[o].numpy(), js.pos, atol=1e-3, rtol=0)
    np.testing.assert_allclose(ts.target_scale[o].numpy(), js.target_scale, rtol=1e-5)


@pytest.fixture(scope="module")
def lwl_pair():
    return tiny_lwl_pair()


def test_lwl_tracker_from_mask_matches_jax(lwl_pair):
    """Single object, the tracker feeding itself its own probabilities
    (`state.seg_raw`): memory filled at frame 5, replacement by weight after."""
    from pytracking_tpu.trackers.lwl import LWLParams, LWLTracker

    jnet, v, tnet = lwl_pair
    jtr = LWLTracker(LWLParams(**SMALL), jnet, v)
    ttr = t_lwl.LWLTracker(t_lwl.LWLParams(**SMALL), tnet, device="cpu")
    im0, lab0 = frame(0)
    m0 = (lab0 == 1).astype(np.float32)
    info = {"init_bbox": _box(m0), "init_mask": m0}
    oj, ot = jtr.initialize(im0, info), ttr.initialize(im0, info)
    np.testing.assert_array_equal(ot["segmentation"], oj["segmentation"])
    for t in range(1, 9):
        im, _ = frame(t)
        oj, ot = jtr.track(im), ttr.track(im)
        _check_scores(ot["segmentation_raw"], oj["segmentation_raw"])
        _check_mask(ot["segmentation"], oj["segmentation"], oj["segmentation_raw"])
        np.testing.assert_allclose(ot["target_bbox"], oj["target_bbox"], atol=1e-3, rtol=0)
        _check_lwl_state(ttr.state, jtr.state)
    assert ttr.state.num_stored == 4 and ttr.state.frame_num == 9


def test_lwl_tracker_harness_convention_matches_jax(lwl_pair):
    """With object ids the outputs are raw logits and the previous mask
    comes in through `previous_output` (the JAX test's harness loop)."""
    from pytracking_tpu.trackers.lwl import LWLParams, LWLTracker

    jnet, v, tnet = lwl_pair
    kw = dict(SMALL, border_mode="replicate")
    jtr = LWLTracker(LWLParams(**kw), jnet, v)
    ttr = t_lwl.LWLTracker(t_lwl.LWLParams(**kw), tnet, device="cpu")
    im0, lab0 = frame(0)
    m0 = (lab0 == 1).astype(np.float32)
    info = {"init_bbox": _box(m0), "init_mask": m0, "object_ids": ["1"]}
    oj, ot = jtr.initialize(im0, info), ttr.initialize(im0, info)
    np.testing.assert_array_equal(ot["segmentation_raw"], oj["segmentation_raw"])
    prev = {"segmentation_raw": {"1": m0}}
    for t in range(1, 5):
        im, _ = frame(t)
        oj = jtr.track(im, {"previous_output": prev})
        ot = ttr.track(im, {"previous_output": prev})
        _check_scores(ot["segmentation_raw"], oj["segmentation_raw"])
        raw = np.asarray(oj["segmentation_raw"])
        prob = 0.5 * (1 + np.tanh(0.5 * raw))
        _check_mask(ot["segmentation"], oj["segmentation"], prob)
        np.testing.assert_allclose(ot["target_bbox"], oj["target_bbox"], atol=1e-3, rtol=0)
        prev = {"segmentation_raw": {"1": prob}}
    merged_j = jtr.merge_results({"1": oj})
    merged_t = ttr.merge_results({"1": ot})
    _check_mask(merged_t["segmentation"], merged_j["segmentation"], prob)


def test_merge_results_matches_jax(lwl_pair):
    """Host soft aggregation of three objects, one given by its binary
    segmentation only."""
    from pytracking_tpu.trackers.lwl import LWLParams, LWLTracker

    jnet, v, tnet = lwl_pair
    rng = np.random.RandomState(3)
    outs = {"1": {"segmentation_raw": rng.randn(H, W).astype(np.float32) * 20,
                  "target_bbox": [1.0, 2.0, 3.0, 4.0]},
            "3": {"segmentation_raw": rng.randn(H, W).astype(np.float32) * 20},
            "4": {"segmentation": (rng.rand(H, W) > 0.7).astype(np.uint8)}}
    ref = LWLTracker(LWLParams(**SMALL), jnet, v).merge_results(outs)
    got = t_lwl.LWLTracker(t_lwl.LWLParams(**SMALL), tnet, device="cpu").merge_results(outs)
    np.testing.assert_array_equal(got["segmentation"], ref["segmentation"])
    assert list(got["segmentation_raw"]) == list(ref["segmentation_raw"])
    for k in ref["segmentation_raw"]:
        np.testing.assert_allclose(got["segmentation_raw"][k], ref["segmentation_raw"][k],
                                   atol=1e-6, rtol=0)
    assert got["target_bbox"] == ref["target_bbox"]


def test_lwl_tracker_from_box_matches_jax():
    """No init mask: the box label encoder and the decoder give it."""
    from pytracking_tpu.trackers.lwl import LWLParams, LWLTracker

    jnet, v, tnet = tiny_boxnet_pair()
    jtr = LWLTracker(LWLParams(**SMALL), jnet, v)
    ttr = t_lwl.LWLTracker(t_lwl.LWLParams(**SMALL), tnet, device="cpu")
    im0, lab0 = frame(0)
    info = {"init_bbox": _box(lab0 == 1)}
    oj, ot = jtr.initialize(im0, info), ttr.initialize(im0, info)
    np.testing.assert_array_equal(ot["segmentation"], oj["segmentation"])
    assert 0 < oj["segmentation"].sum() < H * W
    for t in range(1, 6):
        im, _ = frame(t)
        oj, ot = jtr.track(im), ttr.track(im)
        _check_scores(ot["segmentation_raw"], oj["segmentation_raw"])
        _check_mask(ot["segmentation"], oj["segmentation"], oj["segmentation_raw"])
        np.testing.assert_allclose(ot["target_bbox"], oj["target_bbox"], atol=1e-3, rtol=0)
        _check_lwl_state(ttr.state, jtr.state)


def test_multi_object_tracker_matches_jax(lwl_pair):
    """Both objects in one batched step against the JAX vmapped step; the
    merge on the device."""
    from pytracking_tpu.trackers.lwl import LWLMultiObjectTracker, LWLParams

    jnet, v, tnet = lwl_pair
    jtr = LWLMultiObjectTracker(LWLParams(**SMALL), jnet, v)
    ttr = t_lwl.LWLMultiObjectTracker(t_lwl.LWLParams(**SMALL), tnet, device="cpu")
    im0, lab0 = frame(0)
    info = {"init_mask": lab0, "object_ids": ["1", "2"]}
    jtr.initialize(im0, info)
    ttr.initialize(im0, info)
    ties = 0
    for t in range(1, 7):
        im, _ = frame(t)
        oj, ot = jtr.track(im), ttr.track(im)
        agg = np.stack([np.asarray(oj["segmentation_raw"][k]) for k in ("1", "2")])
        for k in ("1", "2"):
            np.testing.assert_allclose(ot["segmentation_raw"][k], oj["segmentation_raw"][k],
                                       atol=1e-4, rtol=0)
            np.testing.assert_allclose(ot["target_bbox"][k], oj["target_bbox"][k], atol=1e-3,
                                       rtol=0)
        top2 = np.sort(np.concatenate([1 - agg.sum(0, keepdims=True), agg]), axis=0)[-2:]
        tie = top2[1] - top2[0] < 1e-5
        diff = ot["segmentation"] != oj["segmentation"]
        assert not np.any(diff & ~tie), int((diff & ~tie).sum())
        ties += int(diff.sum())
        assert set(np.unique(ot["segmentation"])) <= {0, 1, 2}
        assert np.all(agg.sum(0) <= 1 + 1e-6)
        for o in range(2):
            js = jax.tree_util.tree_map(lambda x, o=o: np.asarray(x)[o], jtr.states)
            _check_lwl_state(ttr.states, js, o)
    assert ties <= 1e-3 * 6 * H * W, ties        # near-ties are rare


def test_batched_step_equals_single_steps(lwl_pair):
    """One batched step of two objects equals two single-object steps from
    the same states and inputs."""
    _, _, tnet = lwl_pair
    mt = t_lwl.LWLMultiObjectTracker(t_lwl.LWLParams(**SMALL), tnet, device="cpu")
    im0, lab0 = frame(0)
    mt.initialize(im0, {"init_mask": lab0, "object_ids": ["1", "2"]})
    for t in (1, 2, 3):                          # frame 3 updates the memory and refits
        mt.track(frame(t)[0])
    impl = mt._impl
    im = impl._image_tensor(frame(4)[0])
    prev = mt._prev_probs.clone()
    states = mt.states

    singles = [states.select(o) for o in range(2)]
    with torch.no_grad():
        _, both = impl._step(states, im, prev)
        for o in range(2):
            _, one = impl._step(singles[o], im, prev[o:o + 1])
            raw, ref = one["segmentation_raw"][0], both["segmentation_raw"][o]
            assert torch.equal(one["segmentation"][0], both["segmentation"][o])
            scale = max(1.0, float(ref[ref > -100].abs().max()))
            assert float((raw - ref).abs().max()) <= 1e-4 * scale
            torch.testing.assert_close(one["target_bbox"][0], both["target_bbox"][o],
                                       rtol=0, atol=1e-3)


@pytest.mark.parametrize("which", ["lwl", "boxnet"])
def test_tiny_converters_use_every_leaf(which):
    """Each converter maps every flax leaf onto exactly the net's keys, and
    raises on an extra leaf."""
    pair, convert = {"lwl": (tiny_lwl_pair, cw.lwtlnet_from_flax),
                     "boxnet": (tiny_boxnet_pair, cw.lwtlboxnet_from_flax)}[which]
    _, v, tnet = pair()
    assert set(convert(v, tnet)) == set(tnet.state_dict())
    extra = {"params": {**v["params"], "stray": {"kernel": np.zeros((1, 1, 1, 1), np.float32)}},
             "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError):
        convert(extra, tnet)
