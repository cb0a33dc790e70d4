"""Parity of the PyTorch port's KeepTrack modules with the JAX package, on the
CPU: Sinkhorn and optimal transport, the SuperGlue matcher with invalid
slots, the descriptor extractor at the border, the top-K candidates, the
device association (against the JAX one and the port's host
`CandidateCollection`, over seeded random candidate sequences), the
search-area rescaling, the certainty-weighted memory and `tcmnet_from_flax`.

Same numpy inputs from a seed through the JAX function and the port's;
weights from the JAX `init` (random BatchNorm statistics) converted with
`tcmnet_from_flax`. Float32. Tolerances: modules 1e-4 relative to the
larger of 1 and the output's largest magnitude; memory weights within 1e-6;
flags, replace indices, slots and object ids equal.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytracking_tpu_torch.models.backbones import resnet as t_resnet
from pytracking_tpu_torch.models.tcm import superglue as t_sg
from pytracking_tpu_torch.models.tcm import target_candidate_matching as t_tcm
from pytracking_tpu_torch.trackers import keep_track as t_kt
from pytracking_tpu_torch.utils.convert_weights import tcmnet_from_flax

from test_torch_dimp_family_ops import _close, _init_numpy, _nchw, _t, perturb_batch_stats

DESC = 64
KENC = (16, 32)


def jax_tiny_tcm(desc=DESC, image_shape=(96, 96)):
    """ResNet with one BasicBlock per stage at base width 8 (layer3: 32
    channels), `desc`-channel descriptors, a (16, 32) keypoint encoder, one
    ('self', 'cross') pair and 5 Sinkhorn passes."""
    from pytracking_tpu.models.backbones.resnet import ResNet
    from pytracking_tpu.models.tcm.superglue import SuperGlueMatcher
    from pytracking_tpu.models.tcm.target_candidate_matching import (
        DescriptorExtractor, TargetCandidateMatchingNetwork)

    return TargetCandidateMatchingNetwork(
        feature_extractor=ResNet(block="basic", layers=(1, 1, 1, 1), output_layers=("layer3",),
                                 base_width=8),
        descriptor_extractor=DescriptorExtractor(descriptor_dim=desc, kernel_size=4),
        matcher=SuperGlueMatcher(input_dim=desc, descriptor_dim=desc, keypoint_encoder=KENC,
                                 num_gnn_layers=1, num_sinkhorn_iterations=5,
                                 image_shape=image_shape))


def torch_tiny_tcm(desc=DESC, image_shape=(96, 96)):
    return t_tcm.TargetCandidateMatchingNetwork(
        t_resnet.ResNet(layers=(1, 1, 1, 1), output_layers=("layer3",), base_width=8,
                        block="basic"),
        t_tcm.DescriptorExtractor(32, descriptor_dim=desc, kernel_size=4),
        t_sg.SuperGlueMatcher(input_dim=desc, descriptor_dim=desc, keypoint_encoder=KENC,
                              num_gnn_layers=1, num_sinkhorn_iterations=5,
                              image_shape=image_shape)).eval()


def tiny_tcm_pair(K=4, seed=1, desc=DESC, image_shape=(96, 96)):
    """(jax TCM net, its flax variables as numpy, the port's net)."""
    jnet = jax_tiny_tcm(desc, image_shape)
    z = jnp.zeros
    variables = jax.jit(lambda k: jnet.init(
        k, z((1, 96, 96, 3)), z((1, 96, 96, 3)), z((1, K, 2), jnp.int32),
        z((1, K, 2), jnp.int32), z((1, K, 2)), z((1, K, 2)), z((1, K)), z((1, K)),
        train=False))(jax.random.PRNGKey(seed))
    variables = perturb_batch_stats(jax.tree_util.tree_map(np.asarray, dict(variables)),
                                    seed + 7)
    variables["params"]["matcher"]["bin_score"] = np.float32(0.7)
    tnet = torch_tiny_tcm(desc, image_shape)
    tnet.load_state_dict(tcmnet_from_flax(variables, tnet))
    return jnet, variables, tnet


@pytest.fixture(scope="module")
def tcm_pair():
    return tiny_tcm_pair()


# ---------------------------------------------------------------- SuperGlue

@pytest.mark.parametrize("iters", [1, 10, 30])
def test_log_optimal_transport_matches_jax(iters):
    from pytracking_tpu.models.tcm.superglue import log_optimal_transport

    scores = np.random.RandomState(iters).randn(2, 4, 5).astype(np.float32) * 3
    ref = log_optimal_transport(jnp.asarray(scores), jnp.asarray(1.3), iters)
    got = t_sg.log_optimal_transport(_t(scores), torch.tensor(1.3), iters)
    assert tuple(got.shape) == (2, 5, 6)
    _close(got.numpy(), ref)


def _matcher_inputs(K, seed):
    rng = np.random.RandomState(seed)
    c0, c1 = (rng.rand(1, K, 2).astype(np.float32) * 96 for _ in range(2))
    d0, d1 = (rng.randn(1, K, DESC).astype(np.float32) for _ in range(2))
    s0, s1 = (rng.rand(1, K).astype(np.float32) for _ in range(2))
    v0 = np.array([[True] * (K - 1) + [False]])
    v1 = np.array([[True, True] + [False] * (K - 2)])
    return c0, c1, d0, d1, s0, s1, v0, v1


@pytest.mark.parametrize("input_dim", [DESC, 48], ids=["no_proj", "input_proj"])
def test_superglue_matcher_with_invalid_slots_matches_jax(input_dim):
    from pytracking_tpu.models.tcm.superglue import SuperGlueMatcher

    K = 5
    c0, c1, d0, d1, s0, s1, v0, v1 = _matcher_inputs(K, 3)
    d0, d1 = d0[..., :input_dim], d1[..., :input_dim]
    kw = dict(input_dim=input_dim, descriptor_dim=DESC, keypoint_encoder=KENC,
              num_gnn_layers=2, num_sinkhorn_iterations=7, image_shape=(96, 80))
    jm = SuperGlueMatcher(**kw)
    jin = [jnp.asarray(x) for x in (c0, c1, d0, d1, s0, s1)]
    variables = _init_numpy(jm, *jin)
    tm = t_sg.SuperGlueMatcher(**kw).eval()
    tm.load_state_dict(tcmnet_from_flax(variables, tm))
    ref = jm.apply(variables, *jin, valid0=jnp.asarray(v0), valid1=jnp.asarray(v1))
    with torch.no_grad():
        got = tm(*(_t(x) for x in (c0, c1, d0, d1, s0, s1)), valid0=torch.from_numpy(v0),
                 valid1=torch.from_numpy(v1))
    for name in ("log_assignment", "matches0_prob", "similarity"):
        _close(got[name].numpy(), ref[name])
    # invalid slots go to the dustbin
    p = got["matches0_prob"].numpy()[0]
    assert p[K - 1].max() < 1e-3 and p[:, 2:].max() < 1e-3


def test_attention_head_split_is_head_index_fastest():
    """Channel c of a projection belongs to head c % heads: permuting the
    channels within each head's set leaves the output unchanged, permuting
    across heads changes it."""
    torch.manual_seed(0)
    x, y = torch.randn(1, 3, 16), torch.randn(1, 5, 16)
    ch = torch.arange(16)
    within = torch.cat([ch[c::4][torch.randperm(4)] for c in range(4)])
    order = torch.empty_like(ch)
    order[torch.cat([ch[c::4] for c in range(4)])] = within
    across = ch.clone()
    across[[0, 1]] = across[[1, 0]]

    def permuted(order):
        m = t_sg.MultiHeadedAttention(4, 16).eval()
        torch.manual_seed(1)
        for lin in (m.proj_q, m.proj_k, m.proj_v, m.merge):
            torch.nn.init.normal_(lin.weight)
            torch.nn.init.normal_(lin.bias)
        with torch.no_grad():
            base = m(x, y, y)
            for proj in (m.proj_q, m.proj_k, m.proj_v):
                proj.weight.copy_(proj.weight[order])
                proj.bias.copy_(proj.bias[order])
            m.merge.weight.copy_(m.merge.weight[:, order])
            return base, m(x, y, y)

    base, same = permuted(order)
    _close(same.numpy(), base.numpy(), atol=1e-5)
    base, other = permuted(across)
    assert (other - base).abs().max() > 1e-2


# ---------------------------------------------------------------- descriptors

def test_descriptor_extractor_at_the_border_matches_jax():
    from pytracking_tpu.models.tcm.target_candidate_matching import DescriptorExtractor

    feat = np.random.RandomState(4).randn(2, 6, 5, 8).astype(np.float32)
    # the conv's output is 7x6; coordinates on and past its last row/column
    coords = np.array([[[0, 0], [6, 5], [7, 6], [-2, 3]],
                       [[3, 4], [9, -1], [6, 0], [2, 5]]], np.int32)
    jm = DescriptorExtractor(descriptor_dim=16, kernel_size=4)
    variables = _init_numpy(jm, jnp.asarray(feat), jnp.asarray(coords))
    tm = t_tcm.DescriptorExtractor(8, descriptor_dim=16, kernel_size=4)
    tm.load_state_dict(tcmnet_from_flax(variables, tm))
    ref = jm.apply(variables, jnp.asarray(feat), jnp.asarray(coords))
    with torch.no_grad():
        got = tm(_nchw(feat), torch.from_numpy(coords))
    assert tuple(got.shape) == (2, 4, 16)
    _close(got.numpy(), ref)


def test_tcm_net_descriptors_and_match_match_jax(tcm_pair):
    jnet, variables, tnet = tcm_pair
    im = np.random.RandomState(5).rand(1, 96, 96, 3).astype(np.float32) * 255
    coords = np.array([[[0, 0], [3, 4], [6, 6], [2, 1]]], np.int32)
    jf = jnet.apply(variables, jnp.asarray(im), method=lambda m, x: m.extract_backbone(x))
    jd = jnet.apply(variables, jf, jnp.asarray(coords),
                    method=lambda m, f, c: m.get_descriptors(f, c))
    with torch.no_grad():
        tf = tnet.extract_backbone(_nchw(im))
        td = tnet.get_descriptors(tf, torch.from_numpy(coords))
    _close(td.numpy(), jd)
    c0, c1, d0, d1, s0, s1, v0, v1 = _matcher_inputs(4, 6)
    ref = jnet.apply(variables, *(jnp.asarray(x) for x in (c0, c1, d0)), jd,
                     *(jnp.asarray(x) for x in (s0, s1)),
                     method=lambda m, a, b, x, y, u, w: m.match(
                         a, b, x, y, u, w, valid0=jnp.asarray(v0), valid1=jnp.asarray(v1)))
    with torch.no_grad():
        got = tnet.match(*(_t(x) for x in (c0, c1, d0)), td, _t(s0), _t(s1),
                         torch.from_numpy(v0), torch.from_numpy(v1))
    _close(got["log_assignment"].numpy(), ref["log_assignment"])


def test_tcm_converter_uses_every_leaf_and_raises(tcm_pair):
    _, variables, tnet = tcm_pair
    sd = tcmnet_from_flax(variables, tnet)
    assert set(sd) == set(tnet.state_dict())
    assert float(sd["matcher.bin_score"]) == pytest.approx(0.7)
    params = dict(variables["params"])
    params["matcher"] = {**params["matcher"], "stray": {"bias": np.zeros(3, np.float32)}}
    with pytest.raises(KeyError, match="flax leaves without a torch key"):
        tcmnet_from_flax({"params": params, "batch_stats": variables["batch_stats"]}, tnet)
    params["matcher"] = {k: v for k, v in variables["params"]["matcher"].items()
                         if k != "bin_score"}
    with pytest.raises(KeyError, match="torch keys without a flax leaf"):
        tcmnet_from_flax({"params": params, "batch_stats": variables["batch_stats"]}, tnet)


def test_full_width_tcm_keys_match_jax(monkeypatch):
    from pytracking_tpu.models.tcm.target_candidate_matching import \
        target_candidate_matching_net_resnet50

    K, s = 10, 480
    jnet = target_candidate_matching_net_resnet50(image_shape=(s, s))
    z = jnp.zeros
    shapes = jax.eval_shape(lambda k: jnet.init(
        k, z((1, s, s, 3)), z((1, s, s, 3)), z((1, K, 2), jnp.int32), z((1, K, 2), jnp.int32),
        z((1, K, 2)), z((1, K, 2)), z((1, K)), z((1, K))), jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32), shapes)
    monkeypatch.setattr(t_tcm, "init_weights", lambda net, generator: net)
    with torch.device("meta"):
        tnet = t_tcm.target_candidate_matching_net_resnet50(device="meta",
                                                            image_shape=(s, s))
    tcmnet_from_flax(variables, tnet)


# ---------------------------------------------------------------- candidates

def _jax_top_k(scores, K, th):
    """The JAX tracker's candidate extraction (part 1), on one map."""
    from jax import lax

    s = jnp.asarray(scores)
    pooled = lax.reduce_window(s, -jnp.inf, lax.max, (5, 5), (1, 1), "SAME")
    flat = jnp.where(((s == pooled) & (s > th)).reshape(-1), s.reshape(-1), -jnp.inf)
    topv, topi = lax.top_k(flat, K)
    valid = jnp.isfinite(topv)
    w = s.shape[1]
    coords = jnp.stack([(topi // w).astype(jnp.float32), (topi % w).astype(jnp.float32)], -1)
    return np.asarray(jnp.where(valid, topv, 0.0)), np.asarray(coords), np.asarray(valid)


TOPK_CASES = {
    "fewer_peaks_than_k": 0,
    "ties": 1,
    "no_peak": 2,
    "many_peaks": 3,
}


@pytest.mark.parametrize("case", list(TOPK_CASES))
def test_top_k_candidates_match_jax(case):
    rng = np.random.RandomState(TOPK_CASES[case])
    s = np.full((11, 13), 0.01, np.float32)
    if case == "fewer_peaks_than_k":
        s[2, 3], s[8, 10], s[5, 7] = 0.5, 0.3, 0.2
    elif case == "ties":
        s[1, 1] = s[1, 9] = s[8, 4] = 0.4
        s[8, 11] = 0.6
        s[0, 12] = 0.4
    elif case == "many_peaks":
        s = rng.rand(11, 13).astype(np.float32)
    got = t_kt.top_k_peaks(torch.from_numpy(s), 6, 0.05)
    ref = _jax_top_k(s, 6, 0.05)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)
    assert int(got[2].sum()) == {"fewer_peaks_than_k": 3, "ties": 5, "no_peak": 0,
                                 "many_peaks": 6}[case]


# ---------------------------------------------------------------- association

K_ASSOC = 5


def _fields(cls):
    return {f.name: None for f in dataclasses.fields(cls)}


def _jax_assoc_state():
    from pytracking_tpu.trackers.keep_track import KeepTrackState

    return KeepTrackState(**_fields(KeepTrackState)).replace(
        assoc_object_ids=jnp.full((K_ASSOC,), -1, jnp.int32),
        assoc_hist_scores=jnp.zeros((K_ASSOC,)), assoc_selected_oid=jnp.asarray(0, jnp.int32),
        assoc_certain=jnp.asarray(True), assoc_flag=jnp.asarray(0, jnp.int32),
        assoc_id_cntr=jnp.asarray(0, jnp.int32), assoc_active=jnp.asarray(False),
        frame_num=jnp.asarray(1, jnp.int32))


def _torch_assoc_state():
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    return t_kt.KeepTrackState(**{**_fields(t_kt.KeepTrackState), **dict(
        assoc_object_ids=torch.full((K_ASSOC,), -1, dtype=torch.int32),
        assoc_hist_scores=torch.zeros(K_ASSOC), assoc_selected_oid=i32(0),
        assoc_certain=torch.tensor(True), assoc_flag=i32(0), assoc_id_cntr=i32(0),
        assoc_active=torch.tensor(False), frame_num=1)})


def _random_frame(rng):
    """Part 1's candidate arrays for one frame: scores sorted, around the
    association's thresholds (0.2, 0.25, 0.75), matches into the previous
    slots or none, match scores around 0.6 and 0.85."""
    n = rng.choice([0, 1, 2, 3, 4, 5], p=[0.05, 0.2, 0.25, 0.2, 0.15, 0.15])
    levels = np.array([0.1, 0.19, 0.22, 0.26, 0.3, 0.5, 0.74, 0.8, 0.9])
    scores = np.sort(rng.choice(levels, n) + rng.rand(n) * 1e-3)[::-1]
    cand_scores = np.zeros(K_ASSOC, np.float32)
    cand_scores[:n] = scores
    valid = np.arange(K_ASSOC) < n
    matches = np.where(rng.rand(K_ASSOC) < 0.8, rng.randint(0, K_ASSOC, K_ASSOC), -1)
    match_scores = rng.choice([0.3, 0.59, 0.61, 0.7, 0.84, 0.86, 0.95], K_ASSOC)
    coords = rng.randint(0, 18, (K_ASSOC, 2)).astype(np.float32)
    max_score = float(scores[0]) if n else float(rng.rand() * 0.04)
    if rng.rand() < 0.1:
        max_score = 0.03                      # below the candidate threshold
    return dict(cand_scores=cand_scores, cand_coords=coords, cand_valid=valid,
                matches=matches.astype(np.int64), match_scores=match_scores.astype(np.float32),
                max_score=np.float32(max_score), default_disp=rng.randn(2).astype(np.float32),
                default_flag=np.int32(rng.choice([0, 1, 2, 3])),
                prev_frame_gap=1 if rng.rand() < 0.9 else 2)


def test_device_association_matches_jax_and_candidate_collection():
    """50 seeded sequences of 8 frames: the port's `_associate_device`
    against the JAX one and against the port's host `CandidateCollection`
    (the split path's `_associate_host`): the association state, the
    selected slot, flag, candidate score and object-0 decision equal."""
    from pytracking_tpu.trackers.keep_track import KeepTrackParams, KeepTrackTracker

    params = KeepTrackParams(max_candidates=K_ASSOC)
    jself = types.SimpleNamespace(params=params)
    jassoc = jax.jit(lambda st, p1: KeepTrackTracker._associate_device(jself, st, p1))
    tself = types.SimpleNamespace(params=t_kt.KeepTrackParams(max_candidates=K_ASSOC),
                                  device=torch.device("cpu"), candidate_collection=None)
    n_cases = {"create": 0, "update": 0, "selected": 0, "lost": 0, "new_id": 0}
    for seq in range(50):
        rng = np.random.RandomState(100 + seq)
        js, ts = _jax_assoc_state(), _torch_assoc_state()
        tself.candidate_collection = None
        for t in range(2, 10):
            fr = _random_frame(rng)
            gap = fr["prev_frame_gap"]
            js = js.replace(frame_num=jnp.asarray(t, jnp.int32))
            ts = dataclasses.replace(ts, frame_num=t)
            jp1 = {k: jnp.asarray(v) for k, v in fr.items()}
            tp1 = {k: (v if k == "prev_frame_gap" else torch.from_numpy(np.asarray(v)))
                   for k, v in fr.items()}
            ids_before = int(ts.assoc_id_cntr)
            js, j_coord, j_grid, j_flag, j_score, j_obj0 = jassoc(js, jp1)
            ts, t_coord, t_grid, t_flag, t_score, t_obj0 = \
                t_kt.KeepTrackTracker._associate_device(tself, ts, tp1)
            where = (seq, t)
            for name in ("assoc_object_ids", "assoc_selected_oid", "assoc_flag",
                         "assoc_id_cntr", "assoc_active", "assoc_certain"):
                np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                              np.asarray(getattr(js, name)), err_msg=str(where))
            np.testing.assert_allclose(ts.assoc_hist_scores.numpy(), js.assoc_hist_scores,
                                       atol=1e-7)
            assert bool(t_grid) == bool(j_grid) and int(t_flag) == int(j_flag), where
            assert bool(t_obj0) == bool(j_obj0), where
            np.testing.assert_array_equal(t_coord.numpy(), np.asarray(j_coord), err_msg=str(where))
            assert float(t_score) == float(j_score), where

            # the host's CandidateCollection on the same arrays
            cid, flag, obj0 = t_kt.KeepTrackTracker._associate_host(tself, fr, t, gap)
            assert (cid is not None) == bool(t_grid), where
            assert (int(fr["default_flag"]) if flag is None else flag) == int(t_flag), where
            assert obj0 == bool(t_obj0), where
            if cid is not None:
                assert np.array_equal(fr["cand_coords"][cid], t_coord.numpy()), where
            cc = tself.candidate_collection
            if cc is not None:
                n = int(fr["cand_valid"].sum())
                ids = [cc.candidates[i].object_id for i in range(n)]
                assert ids == ts.assoc_object_ids[:n].tolist(), where
                assert cc.object_id_of_selected_candidate == int(ts.assoc_selected_oid), where
            do_update = bool(ts.assoc_active) and cc is not None and int(ts.assoc_id_cntr) > 0
            n_cases["create" if not bool(t_grid) and flag is None else "update"] += 1
            n_cases["selected"] += bool(t_grid)
            n_cases["lost"] += int(t_flag) == t_kt.FLAG_NOT_FOUND and do_update
            n_cases["new_id"] += bool(t_grid) and int(ts.assoc_id_cntr) > ids_before
    # the sequences exercise every branch
    assert min(n_cases.values()) >= 5, n_cases


# ---------------------------------------------------------------- rescaling and memory

def _bare(cls, **attrs):
    obj = object.__new__(cls)
    obj.__dict__.update(attrs)
    return obj


def test_search_area_rescaling_matches_jax():
    """120 frames of found / lost with random scales: the history (newest
    last), its length, the lost counter and the scale after a lost frame
    (the reverse-rank mean) against the JAX `lax.cond` of
    `_push_scale_history` / `_search_area_rescaling`."""
    from pytracking_tpu.trackers.keep_track import KeepTrackState, KeepTrackTracker

    rng = np.random.RandomState(7)
    jtr = _bare(KeepTrackTracker)
    ttr = _bare(t_kt.KeepTrackTracker, device=torch.device("cpu"))
    js = KeepTrackState(**_fields(KeepTrackState)).replace(
        target_scale=jnp.asarray(1.0), scale_history=jnp.zeros(60),
        scale_history_n=jnp.asarray(0, jnp.int32),
        target_not_found_counter=jnp.asarray(0, jnp.int32))
    ts = t_kt.KeepTrackState(**{**_fields(t_kt.KeepTrackState), **dict(
        target_scale=torch.tensor(1.0), scale_history=torch.zeros(60),
        scale_history_n=torch.tensor(0, dtype=torch.int32),
        target_not_found_counter=torch.tensor(0, dtype=torch.int32))})
    lost_runs = 0
    found_seq = [False] + [rng.rand() < 0.6 for _ in range(119)]
    for t, found in enumerate(found_seq):
        scale = np.float32(rng.rand() * 2 + 0.5)
        js = js.replace(target_scale=jnp.asarray(scale))
        ts = dataclasses.replace(ts, target_scale=torch.tensor(scale))
        js = jax.lax.cond(found, jtr._push_scale_history, jtr._search_area_rescaling, js)
        ts = ttr._rescale_search_area(ts, torch.tensor(found))
        np.testing.assert_array_equal(ts.scale_history.numpy(), js.scale_history, err_msg=str(t))
        assert int(ts.scale_history_n) == int(js.scale_history_n)
        assert int(ts.target_not_found_counter) == int(js.target_not_found_counter)
        np.testing.assert_allclose(float(ts.target_scale), float(js.target_scale), rtol=1e-6)
        lost_runs += int(ts.target_not_found_counter) >= 3
    assert int(ts.scale_history_n) == 60 and lost_runs > 0


@pytest.mark.parametrize("use_certainty", [True, False], ids=["certainty", "weight"])
def test_certainty_memory_matches_jax(use_certainty):
    """30 masked memory updates with random certainties and learning rates
    (M = 8, 3 initial samples): the replaced slot (argmin of certainty x
    weight from the first non-initial slot), weights, certainties and
    samples against the JAX `_update_memory_certainty`."""
    from pytracking_tpu.trackers.keep_track import (KeepTrackParams, KeepTrackState,
                                                    KeepTrackTracker)

    M, n_init, C = 8, 3, 4
    kw = dict(sample_memory_size=M, use_certainty_for_weight_computation=use_certainty)
    jtr = _bare(KeepTrackTracker, params=KeepTrackParams(**kw))
    ttr = _bare(t_kt.KeepTrackTracker, params=t_kt.KeepTrackParams(**kw),
                device=torch.device("cpu"))
    rng = np.random.RandomState(8)
    w0 = np.where(np.arange(M) < n_init, 1.0 / n_init, 0.0).astype(np.float32)
    c0 = (np.arange(M) < n_init).astype(np.float32)
    js = KeepTrackState(**_fields(KeepTrackState)).replace(
        mem_samples=jnp.zeros((M, 2, 3, C)), mem_boxes=jnp.zeros((M, 4)),
        mem_weights=jnp.asarray(w0), mem_certainties=jnp.asarray(c0),
        num_stored=jnp.asarray(n_init, jnp.int32), num_init=jnp.asarray(n_init, jnp.int32),
        prev_ind=jnp.asarray(-1, jnp.int32))
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    ts = t_kt.KeepTrackState(**{**_fields(t_kt.KeepTrackState), **dict(
        mem_samples=torch.zeros((M, C, 2, 3)), mem_boxes=torch.zeros((M, 4)),
        mem_weights=torch.from_numpy(w0.copy()), mem_certainties=torch.from_numpy(c0.copy()),
        num_stored=i32(n_init), num_init=i32(n_init), prev_ind=i32(-1))})
    slots = set()
    for t in range(30):
        sample = rng.randn(2, 3, C).astype(np.float32)
        box = rng.rand(4).astype(np.float32) * 50
        lr = np.float32(rng.choice([0.01, 0.02]))
        do = bool(rng.rand() < 0.8)
        cert = np.float32(rng.rand())
        js = jtr._update_memory_certainty(js, jnp.asarray(sample), jnp.asarray(box),
                                          jnp.asarray(lr), jnp.asarray(do), jnp.asarray(cert))
        ts = ttr._update_memory_certainty(ts, _nchw(sample), _t(box), torch.tensor(lr),
                                          torch.tensor(do), torch.tensor(cert))
        assert int(ts.prev_ind) == int(js.prev_ind) and int(ts.num_stored) == int(js.num_stored)
        np.testing.assert_allclose(ts.mem_weights.numpy(), js.mem_weights, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(ts.mem_certainties.numpy(), js.mem_certainties)
        np.testing.assert_array_equal(ts.mem_samples.numpy(),
                                      np.moveaxis(np.asarray(js.mem_samples), -1, 1))
        slots.add(int(ts.prev_ind))
    assert len(slots) >= 4, slots
