"""Parity of the PyTorch port's RTS tracker and STA net with the JAX ones, on
the CPU, with the tiny nets of test_torch_lwl_ops.py (those of
tests/test_rts.py and tests/test_lwl.py:100, the RTS classifier in RTS-50's
stride-2 layout), on test_torch_lwl.py's sequence: `RTSTracker` started
from a box through STA, with frames where the classifier loses and
re-finds the target; the STA forward; RTS's fused segmentation; the STA
and RTS converters. Limits as in test_torch_lwl.py.

RTS's thresholds are picked from the JAX run's classifier peaks (the seeded
tiny net's are 0.0642, 0.0642, 0.0963, 0.0639, 0.0639, 0.0933, ... with
frames 4 and 5 blanked to grey): not-found 0.064 and too-small 0.08 give
found frames 1-3, lost frames 4-5 (counter 1, 2; the search area rescaled
from the history, no mask update) and the target re-found on frame 6; the
nearest peak is 1.4e-4 from a threshold, the two trackers' peaks agree to
1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytracking_tpu_torch.trackers import rts as t_rts
from pytracking_tpu_torch.utils import convert_weights as cw

from test_torch_dimp_family_ops import _filt, _nchw, _t
from test_torch_lwl import SMALL, _box, _check_lwl_state, _check_mask, _check_scores, frame
from test_torch_lwl_ops import D, K, _enc, close, tiny_rts_pair, tiny_sta_pair
from test_torch_lwl_ops import one_thread  # noqa: F401 (autouse: one CPU thread)

RTS_KW = dict(SMALL, sta_image_sample_size=(64, 64), clf_sample_memory_size=6,
              clf_net_opt_iter=2, clf_net_opt_update_iter=1, train_skipping=2,
              clf_train_skipping=2, clf_target_not_found_threshold=0.064,
              clf_target_not_found_threshold_too_small=0.08)
RTS_BLANK = (4, 5)
RTS_LOST = [0, 0, 0, 1, 2, 0, 0, 0, 0, 0]


def test_rts_tracker_from_box_matches_jax():
    """RTS from a box through STA; frames 4-5 grey: lost (rescaled from the
    history, no mask update), re-found at frame 6."""
    from pytracking_tpu.trackers.rts import RTSParams, RTSTracker

    jnet, v, tnet = tiny_rts_pair()
    sj, sv, st = tiny_sta_pair()
    jtr = RTSTracker(RTSParams(**RTS_KW), jnet, v, sta_net=sj, sta_variables=sv)
    ttr = t_rts.RTSTracker(t_rts.RTSParams(**RTS_KW), tnet, device="cpu", sta_net=st)
    im0, lab0 = frame(0)
    info = {"init_bbox": _box(lab0 == 1)}
    oj, ot = jtr.initialize(im0, info), ttr.initialize(im0, info)
    np.testing.assert_array_equal(ot["segmentation"], oj["segmentation"])
    assert 0 < oj["segmentation"].sum()
    lost = []
    for t in range(1, 11):
        im, _ = frame(t, RTS_BLANK)
        oj, ot = jtr.track(im), ttr.track(im)
        js, ts = jtr.state, ttr.state
        _check_scores(ot["segmentation_raw"], oj["segmentation_raw"])
        _check_mask(ot["segmentation"], oj["segmentation"], oj["segmentation_raw"])
        np.testing.assert_allclose(ot["target_bbox"], oj["target_bbox"], atol=1e-3, rtol=0)
        assert int(ts.lost_counter) == int(js.lost_counter) == ot["lost_counter"]
        assert int(ts.clf_num_stored) == int(js.clf_num_stored)
        assert int(ts.scale_hist_len) == int(js.scale_hist_len)
        np.testing.assert_allclose(ts.clf_mem_weights.numpy(), js.clf_mem_weights, atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(ts.scale_history.numpy(), js.scale_history, rtol=1e-5)
        close(ts.clf_filter.numpy(), _filt(js.clf_filter))
        close(ts.clf_mem_labels.numpy(), np.asarray(js.clf_mem_labels)[:, 0])
        assert abs(ot["clf_max_score"] - float(js.clf_max_score)) < 1e-6
        _check_lwl_state(ts, js)
        lost.append(ot["lost_counter"])
    assert lost == RTS_LOST, lost


# ---------------------------------------------------------------- nets

def test_sta_forward_matches_jax():
    jnet, v, tnet = tiny_sta_pair()
    rng = np.random.RandomState(13)
    im = rng.rand(1, 1, 64, 64, 3).astype(np.float32) * 255
    bb = np.array([[[14.0, 18.0, 26.0, 22.0]]], np.float32)
    ref = jax.jit(lambda v, a, b: jnet.apply(v, a, b, train=False))(v, jnp.asarray(im),
                                                                    jnp.asarray(bb))
    with torch.no_grad():
        got = tnet(_t(np.moveaxis(im, -1, 2)), _t(bb))
    for a, b in zip(got, ref):
        assert a.shape == (1, 1, 64, 64)
        close(a.numpy(), b)


def test_rts_fused_segmentation_matches_jax():
    """segment_target_with_clf: the /32 score encoding resized up to the
    target model's grid and fused before the decoder."""
    jnet, v, tnet = tiny_rts_pair()
    rng = np.random.RandomState(12)
    im = rng.rand(1, 64, 64, 3).astype(np.float32) * 255
    filt = rng.randn(1, 3, 3, D, K).astype(np.float32) * 0.1
    cfilt = rng.randn(1, 4, 4, D, 1).astype(np.float32) * 0.1

    def forward(m, im, filt, cfilt):
        bf = m.extract_backbone(im)
        score = m.clf_classify(cfilt, m.extract_classification_feat(bf))
        x = m.extract_target_model_features(bf)
        return score, m.segment_target_with_clf(filt, x[:, None], bf, score[None, ..., 0],
                                                (64, 64))

    score, (ref, ref_enc) = jax.jit(lambda v, *a: jnet.apply(v, *a, method=forward))(
        v, jnp.asarray(im), jnp.asarray(filt), jnp.asarray(cfilt))
    with torch.no_grad():
        tbf = tnet.extract_backbone(_nchw(im))
        tx = tnet.extract_target_model_features(tbf)
        tcx = tnet.extract_classification_feat(tbf)
        tscore = tnet.clf_classify(_t(_filt(cfilt)), tcx)
        got, enc = tnet.segment_target_with_clf(_t(filt.transpose(0, 4, 3, 1, 2)), tx[None],
                                                tbf, tscore, (64, 64))
    assert tcx.shape[-2:] == (2, 2) and tscore.shape[-2:] == (3, 3)
    close(tscore.numpy()[0, 0], np.asarray(score)[0, ..., 0])
    close(got[0].numpy(), ref)
    close(_enc(enc), ref_enc)


@pytest.mark.parametrize("which", ["sta", "rts"])
def test_tiny_converters_use_every_leaf(which):
    """Each converter maps every flax leaf onto exactly the net's keys, and
    raises on an extra leaf."""
    pair, convert = {"sta": (tiny_sta_pair, cw.stanet_from_flax),
                     "rts": (tiny_rts_pair, cw.rtsnet_from_flax)}[which]
    _, v, tnet = pair()
    assert set(convert(v, tnet)) == set(tnet.state_dict())
    extra = {"params": {**v["params"], "stray": {"kernel": np.zeros((1, 1, 1, 1), np.float32)}},
             "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError):
        convert(extra, tnet)
