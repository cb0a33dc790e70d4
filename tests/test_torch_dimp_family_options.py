"""Parity of the PyTorch port's DiMP tracker options with
`pytracking_tpu.trackers.dimp`, on the CPU: init + 10 frames of the tiny
nets of test_torch_dimp_family.py in the VOT2018 flag regime (windowed
output, hard negatives without the window), without IoU-Net (with exp
scores), with `update_classifier=False`, with `output_not_found_box` and
no augmentation, with softmax_reg and the uncertain / hard-sample score
thresholds, and with the deferred classifier update (`update_classifier_deferred`
against the JAX tracker's `_update_classifier_deferred` on the
train_skipping cadence), masked by the flag and with plain localisation.
Limits as in test_torch_dimp_family.py.
"""

import numpy as np
import pytest

from test_torch_dimp_family import BASE, SUPER, run_trace
from test_torch_dimp_family_ops import _close, _filt

# the VOT2018 regime of dimp50_vot18 / prdimp50_vot18
VOT18 = dict(window_output=True, perform_hn_without_windowing=True,
             target_not_found_threshold=0.0, hard_negative_threshold=0.45,
             init_samples_minimum_weight=0.0, distractor_threshold=100.0,
             displacement_scale=0.7)
# the option regimes, each on one net, on 128x128 frames
OPTIONS = {
    "vot18_windowed": ("superdimp", dict(BASE, **VOT18)),
    "no_iou_net_exp_scores": ("superdimp", dict(BASE, use_iou_net=False, score_preprocess="exp",
                                                target_not_found_threshold=1.25,
                                                distractor_threshold=0.97)),
    "no_classifier_update": ("dimp18", dict(BASE, update_classifier=False,
                                            target_not_found_threshold=0.185)),
    "not_found_box_no_augmentation": ("dimp18", dict(BASE, output_not_found_box=True,
                                                     use_augmentation=False,
                                                     target_not_found_threshold=0.362)),
    "softmax_reg_thresholds": (
        "prdimp50", dict(SUPER, score_preprocess="softmax", softmax_reg=1.0,
                         target_not_found_threshold=0.02, uncertain_threshold=0.1178,
                         hard_sample_threshold=0.13, update_scale_when_uncertain=False,
                         use_iounet_pos_for_learning=False)),
    "deferred_update": ("dimp18", dict(BASE, defer_classifier_update=True,
                                       target_not_found_threshold=0.185)),
    "deferred_update_plain_localization": ("dimp18", dict(BASE, defer_classifier_update=True,
                                                          advanced_localization=False)),
}


def _deferred_hook(filters):
    """After each frame on the train_skipping cadence: the deferred update
    on both trackers, the filters held to the limit."""
    def hook(t, jtr, ttr, jo, to):
        if (ttr.state.frame_num - 1) % ttr.params.train_skipping:
            return
        before = ttr.state.target_filter.clone()
        jtr.state = jtr._update_classifier_deferred(jtr.state)
        ttr.update_classifier_deferred()
        _close(ttr.state.target_filter.numpy(), _filt(jtr.state.target_filter))
        filters.append((to["flag"], bool((ttr.state.target_filter != before).any())))
    return hook


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_trace_matches_jax(name, monkeypatch):
    kind, kw = OPTIONS[name]
    deferred = []
    hook = _deferred_hook(deferred) if kw.get("defer_classifier_update") else None
    flags, iters, jtr, ttr = run_trace(kind, kw, monkeypatch, on_frame=hook)
    st = ttr.state
    if name == "vot18_windowed":
        assert "hard_negative" in flags and "not_found" not in flags, flags
    elif name == "no_iou_net_exp_scores":
        # the crop scale is the target scale: the size stays the initial one's
        # multiple of the scale
        np.testing.assert_allclose((st.target_sz / st.target_scale).numpy(),
                                   st.base_target_sz.numpy(), rtol=1e-6)
        assert max(iters) > 0, (flags, iters)
    elif name == "no_classifier_update":
        # no memory update; the filter is the initial one
        assert int(st.num_stored) == int(st.num_init), flags
        assert "hard_negative" in flags, flags
    elif name == "not_found_box_no_augmentation":
        assert int(st.num_init) == 1
        assert {"not_found", "normal"} <= set(flags), flags
    elif name == "softmax_reg_thresholds":
        assert {"uncertain", "hard_negative", "normal"} <= set(flags), flags
    elif name == "deferred_update":
        # the step never refits; the deferred update is masked by the last flag
        assert set(iters) != {0}, iters
        assert all(changed == (flag not in ("not_found", "uncertain"))
                   for flag, changed in deferred), deferred
        assert {changed for _, changed in deferred} == {True, False}, deferred
    elif name == "deferred_update_plain_localization":
        assert set(flags) == {"normal"}
        assert deferred and all(changed for _, changed in deferred), deferred
