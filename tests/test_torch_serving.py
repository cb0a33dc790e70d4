"""The port's batched multi-stream server (`pytracking_tpu_torch/parallel/
serving.py`, the DiMP tracker's stream-axis step `_step_streams`) against the
JAX package's `BatchedTrackerServer` and against single-stream port
trackers, on the CPU.

Nets: the tiny DiMP of test_torch_dimp.py (`jax_tiny_dimpnet`, converted
with `dimpnet_from_flax`) and the tiny PrDiMP (Newton optimiser) of
test_torch_dimp_family_ops.py. Parameters: test_serving.py's `_params()`
(96x96 samples, memory 8, train_skipping 3, so 7 frames span two ticks);
its forced thresholds make every frame normal, and the cases named
`hard_negatives` set the not-found threshold to 0.2 instead, where the
three streams (each its own texture, colour, size and motion on 128x128
frames) give normal and hard-negative frames, mixed within a frame.

Against the JAX server each port step starts from the JAX server's state
(converted) and takes the JAX streams' own jitter draws (each stream's key,
split as the JAX tracker splits it): run free, the random tiny net's
IoU-Net ascent amplifies float32 rounding about threefold per frame (2e-5
px after one frame, 5e-3 after seven), which would measure the loop, not
the port. Limits: flags, replace indices and `num_stored` equal; boxes
within 1e-3 px; score peaks 1e-4; memory weights 1e-6; filters after each
step (and tick) within 1e-4 of their scale. The bf16 servers (every weight
rounded through bf16) are held to the same limits, the JAX one compiled
with XLA's excess precision off, as in test_torch_dimp_bf16.py.

Against single port trackers no draw is replayed: the server's one draw per
step, expanded over the streams, is what each single tracker's generator,
seeded alike, draws.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pytracking_tpu_torch.parallel.serving import BatchedTrackerServer
from pytracking_tpu_torch.trackers import dimp as t_dimp

from test_torch_dimp import _close, _t
from test_torch_dimp import nets  # noqa: F401 (fixture: the tiny DiMP pair)
from test_torch_dimp_family_ops import tiny_pair
from test_torch_lwl_ops import one_thread  # noqa: F401 (autouse: one CPU thread)
from tests.test_serving import _params

B, T = 3, 7
HARD_NEGATIVES = dict(target_not_found_threshold=0.2, distractor_threshold=0.8,
                      hard_negative_threshold=0.5)
# PrDiMP's deltas (test_torch_dimp_family.py SUPER): 'inside_major' crops,
# three relative-space steps of 2.5e-3, softmax scores
RELATIVE = dict(search_area_scale=6.0, border_mode="inside_major", patch_max_scale_change=1.5,
                box_refinement_space="relative", box_refinement_iter=3,
                box_refinement_step_length=2.5e-3, score_preprocess="softmax",
                target_not_found_threshold=0.05, distractor_threshold=0.8,
                hard_negative_threshold=0.5)
_BG = [np.random.RandomState(b).randint(0, 60, (128, 128, 3)).astype(np.uint8) for b in range(B)]
_SIZE = [(20, 18), (16, 24), (24, 20)]
_COLOUR = [(220, 60, 60), (60, 200, 90), (230, 220, 40)]


def frame(b, t):
    """Stream b's frame t: a target of its own size and colour on its own
    texture, moving (+2, 3 - b) px per frame."""
    im = _BG[b].copy()
    h, w = _SIZE[b]
    cy, cx = 50 + 6 * b + 2 * t, 48 + 5 * b + (3 - b) * t
    im[cy - h // 2:cy + h // 2, cx - w // 2:cx + w // 2] = _COLOUR[b]
    return im


def init_box(b):
    h, w = _SIZE[b]
    return [48.0 + 5 * b - w // 2, 50.0 + 6 * b - h // 2, float(w), float(h)]


def batch(t):
    return np.stack([frame(b, t) for b in range(B)])


def _kw(**kw):
    """test_serving.py's `_params()` fields with `kw` over them."""
    return dict(dataclasses.asdict(_params()), **kw)


def _no_defer(cls):
    return type("NoDefer" + cls.__name__, (cls,), {"supports_deferred_classifier_update": False})


def _exact(jitted):
    """A jitted function compiled with XLA's excess precision off (bf16
    results rounded where the op-by-op computation rounds them)."""
    compiled = {}

    def call(*args):
        if "fn" not in compiled:
            compiled["fn"] = jitted.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return compiled["fn"](*args)
    return call


def _servers(pair, kw, monkeypatch, defer=True, bf16=False):
    """The JAX server and the port's (CPU) with the same params and weights."""
    from pytracking_tpu.parallel.serving import BatchedTrackerServer as JServer
    from pytracking_tpu.trackers.dimp import DiMPParams, DiMPTracker

    monkeypatch.setenv("PYTRACKING_TPU_SHAPE_BUCKETS", "0")
    jnet, variables, tnet = pair
    jcls, tcls = DiMPTracker, t_dimp.DiMPTracker
    if not defer:
        jcls, tcls = _no_defer(jcls), _no_defer(tcls)
    js = JServer(jcls, DiMPParams(**kw), jnet, variables, bf16=bf16)
    if bf16 is not False:
        for obj in (js, js.tracker):
            for name in [n for n in vars(obj) if n.startswith("_jit") and vars(obj)[n]]:
                setattr(obj, name, _exact(getattr(obj, name)))
    ts = BatchedTrackerServer(tcls, t_dimp.DiMPParams(**kw), tnet, device="cpu", bf16=bf16)
    assert js._deferred == ts._deferred == defer
    frames0 = [frame(b, 0) for b in range(B)]
    js.initialize(frames0, [init_box(b) for b in range(B)])
    ts.initialize(frames0, [init_box(b) for b in range(B)])
    return js, ts


def port_state(js) -> t_dimp.BatchedDiMPState:
    """The JAX server's stacked state as the port's (layouts converted,
    every tensor a fresh copy: the port writes its memory in place)."""
    def t(x, *perm):
        x = np.asarray(x)
        return torch.from_numpy(np.ascontiguousarray(x.transpose(*perm) if perm else x))

    return t_dimp.BatchedDiMPState(
        pos=t(js.pos), target_sz=t(js.target_sz), target_scale=t(js.target_scale),
        base_target_sz=t(js.base_target_sz), image_sz=t(js.image_sz),
        min_scale=t(js.min_scale), max_scale=t(js.max_scale),
        target_filter=t(np.asarray(js.target_filter)[:, 0], 0, 4, 3, 1, 2),
        mem_samples=t(js.mem_samples, 1, 0, 4, 2, 3), mem_boxes=t(js.mem_boxes, 1, 0, 2),
        mem_weights=t(js.mem_weights, 1, 0), num_stored=t(js.num_stored),
        num_init=t(js.num_init), prev_ind=t(js.prev_ind), iou_mod3=t(js.iou_mod3[:, 0]),
        iou_mod4=t(js.iou_mod4[:, 0]), frame_num=int(js.frame_num[0]), flag=t(js.flag),
        max_score=t(js.max_score))


def _filters(jst):
    return np.asarray(jst.target_filter)[:, 0].transpose(0, 4, 3, 1, 2)


def check_against_jax(ts, js, tboxes, jboxes, step):
    st, jst = ts.states, js.states
    np.testing.assert_array_equal(ts.flags, np.asarray(jst.flag), err_msg=str(step))
    np.testing.assert_allclose(tboxes, np.asarray(jboxes), atol=1e-3, rtol=0, err_msg=str(step))
    np.testing.assert_allclose(ts.max_scores, np.asarray(jst.max_score), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(st.num_stored.numpy(), np.asarray(jst.num_stored))
    np.testing.assert_array_equal(st.prev_ind.numpy(), np.asarray(jst.prev_ind))
    np.testing.assert_allclose(st.mem_weights.numpy().T, np.asarray(jst.mem_weights),
                               atol=1e-6, rtol=0)
    _close(st.target_filter.numpy(), _filters(jst))
    assert st.frame_num == int(jst.frame_num[0])


def run_against_jax(js, ts, n=T):
    """n steps, each port step from the JAX server's state with the JAX
    streams' jitter draws; every step held to the limits. Returns the
    flags per step (n, B)."""
    K = ts.params.num_init_random_boxes
    _close(ts.states.target_filter.numpy(), _filters(js.states))
    _close(ts.states.mem_samples.numpy().transpose(1, 0, 3, 4, 2),
           np.asarray(js.states.mem_samples))
    flags = []
    for t in range(1, n + 1):
        keys = js.states.key
        jitter = torch.stack([_t(jax.random.uniform(jax.random.split(keys[b])[1], (K, 4)))
                              for b in range(B)])
        ts._uniform = lambda shape, u=jitter: u
        ts.states = port_state(js.states)
        jboxes = js.track(batch(t))
        tboxes = ts.track(batch(t))
        check_against_jax(ts, js, tboxes, jboxes, t)
        flags.append(ts.flags.tolist())
    return np.array(flags)


# ---------------------------------------------------------------- against JAX

@pytest.mark.parametrize("case", ["forced_normal", "hard_negatives"])
def test_deferred_server_matches_jax_server(nets, case, monkeypatch):
    """The deferred server (the light step, the tick at frames 4 and 7)
    against the JAX server. With the forced thresholds every frame is
    normal; at not-found 0.2 the hard negatives' refits wait for the tick
    on both sides."""
    kw = _kw() if case == "forced_normal" else _kw(**HARD_NEGATIVES)
    js, ts = _servers(nets, kw, monkeypatch)
    flags = run_against_jax(js, ts)
    if case == "forced_normal":
        assert (flags == t_dimp.FLAG_NORMAL).all()
    else:
        assert (flags == t_dimp.FLAG_HARD_NEG).any() and (flags == t_dimp.FLAG_NORMAL).any()


def test_non_deferring_server_matches_jax_server(nets, monkeypatch):
    """A class without the deferred update: the fused refit per frame, each
    stream's count chosen on the host (hard negative, periodic or none)
    against the JAX server's per-stream lax.switch; some frame refits a
    subset of the streams (the periodic count 2, the hard-negative count 1)."""
    js, ts = _servers(nets, _kw(net_opt_update_iter=2, **HARD_NEGATIVES), monkeypatch,
                      defer=False)
    calls = []
    refit = ts.tracker._refit_streams

    def counting(state, num_iter, streams=None, mask_by_flag=False):
        calls.append((num_iter, None if streams is None else streams.tolist()))
        return refit(state, num_iter, streams, mask_by_flag)

    monkeypatch.setattr(ts.tracker, "_refit_streams", counting)
    flags = run_against_jax(js, ts)
    assert (flags == t_dimp.FLAG_HARD_NEG).any() and (flags == t_dimp.FLAG_NORMAL).any()
    assert any(streams is not None for _, streams in calls), calls


def test_bf16_server_matches_jax_bf16_server(nets, monkeypatch):
    """The default server (bf16) against the JAX server's bf16 default:
    both round every float32 weight through bf16 and compute in float32,
    the BatchNorms' multipliers in bf16; the caller's net keeps its
    weights."""
    monkeypatch.delenv("PYTRACKING_TPU_SERVING_BF16", raising=False)
    tnet = nets[2]
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    js, ts = _servers(nets, _kw(**HARD_NEGATIVES), monkeypatch, bf16=None)
    assert ts.bf16 and ts.tracker.net is not tnet
    for k, v in tnet.state_dict().items():
        assert torch.equal(v, before[k]), k
    w = ts.tracker.net.state_dict()["feature_extractor.conv1.weight"]
    assert torch.equal(w, w.to(torch.bfloat16).float())
    run_against_jax(js, ts)


def test_relative_space_newton_server_matches_jax_server(monkeypatch):
    """PrDiMP on the stream axis: 'inside_major' crops, the ascent in the
    relative box space, softmax scores and the Newton refit, deferred."""
    js, ts = _servers(tiny_pair("prdimp50"), _kw(**RELATIVE), monkeypatch)
    assert type(ts.tracker.net.classifier.filter_optimizer).__name__ == \
        "PrDiMPSteepestDescentNewton"
    run_against_jax(js, ts)


# ---------------------------------------------------------------- against single trackers

def _singles(tnet, kw, cls=t_dimp.DiMPTracker):
    singles = [cls(t_dimp.DiMPParams(**kw), tnet, device="cpu") for _ in range(B)]
    for b, tr in enumerate(singles):
        tr.initialize(frame(b, 0), {"init_bbox": init_box(b)})
    return singles


@pytest.mark.parametrize("case", ["deferred_singles", "fused_singles_no_hard_negatives",
                                  "fused_server_fused_singles"])
def test_server_matches_single_trackers(nets, case):
    """B single port trackers with their own generators against the server,
    7 frames, each single step from the server's stream state (copied; run
    free, the loop's float32 drift passes 1e-3 px by frame 5, as against
    JAX); no draw is copied across:
      deferred_singles: the deferred server against single trackers in
        deferred mode, each refitting at the tick (`update_classifier_deferred`),
        at not-found 0.2: the hard negatives' refits wait for the tick;
      fused_singles_no_hard_negatives: the deferred server against fused
        single trackers with every frame normal: the same cadence;
      fused_server_fused_singles: the non-deferring server against fused
        single trackers at not-found 0.2 (hard negatives refit at once).
    Flags equal, boxes within 1e-3 px, filters 1e-4 of scale."""
    tnet = nets[2]
    defer = case != "fused_server_fused_singles"
    kw = _kw() if case == "fused_singles_no_hard_negatives" else _kw(**HARD_NEGATIVES)
    single_kw = dict(kw, defer_classifier_update=case == "deferred_singles")
    cls = t_dimp.DiMPTracker if defer else _no_defer(t_dimp.DiMPTracker)
    server = BatchedTrackerServer(cls, t_dimp.DiMPParams(**kw), tnet, device="cpu", bf16=False)
    server.initialize([frame(b, 0) for b in range(B)], [init_box(b) for b in range(B)])
    singles = _singles(tnet, single_kw)
    flags = []
    for t in range(1, T + 1):
        for b, tr in enumerate(singles):
            tr.state = t_dimp.DiMPTracker.stream_state(server.states, b)
        boxes = server.track(batch(t))
        for b, tr in enumerate(singles):
            out = tr.track(frame(b, t))
            if case == "deferred_singles" and (tr.state.frame_num - 1) % kw["train_skipping"] == 0:
                tr.update_classifier_deferred()
            assert t_dimp.FLAG_NAMES[server.flags[b]] == out["flag"], (t, b)
            np.testing.assert_allclose(boxes[b], out["target_bbox"], atol=1e-3, rtol=0)
            single = t_dimp.DiMPTracker.stream_state(server.states, b)
            _close(single.target_filter.numpy(), tr.state.target_filter.numpy())
            assert int(single.prev_ind) == int(tr.state.prev_ind)
        flags.append(server.flags.tolist())
    flags = np.array(flags)
    if case == "fused_singles_no_hard_negatives":
        assert (flags == t_dimp.FLAG_NORMAL).all()
    else:
        assert (flags == t_dimp.FLAG_HARD_NEG).any() and (flags == t_dimp.FLAG_NORMAL).any()


@pytest.mark.parametrize("defer", [True, False], ids=["deferred", "non_deferring"])
def test_scan_track_matches_stepwise(nets, defer, monkeypatch):
    """`scan_track` over (T, B, H, W, 3) against T calls of `track`: the
    same boxes and filters; in deferred mode one readback for the whole
    sequence, a non-deferring class one per frame."""
    tnet = nets[2]
    cls = t_dimp.DiMPTracker if defer else _no_defer(t_dimp.DiMPTracker)
    kw = _kw(**HARD_NEGATIVES)
    servers = []
    for _ in range(2):
        s = BatchedTrackerServer(cls, t_dimp.DiMPParams(**kw), tnet, device="cpu", bf16=False)
        s.initialize([frame(b, 0) for b in range(B)], [init_box(b) for b in range(B)])
        servers.append(s)
    step_boxes = np.stack([servers[0].track(batch(t)) for t in range(1, T + 1)])
    reads = []
    read = BatchedTrackerServer._read
    monkeypatch.setattr(BatchedTrackerServer, "_read",
                        lambda self, out: reads.append(1) or read(self, out))
    scan_boxes = servers[1].scan_track(torch.from_numpy(np.stack([batch(t)
                                                                  for t in range(1, T + 1)])))
    assert len(reads) == (1 if defer else T)
    np.testing.assert_array_equal(scan_boxes, step_boxes)
    np.testing.assert_array_equal(servers[1].states.target_filter.numpy(),
                                  servers[0].states.target_filter.numpy())
    assert servers[1].states.frame_num == servers[0].states.frame_num == T + 1


@pytest.mark.parametrize("kind", ["gn", "newton", "simple"])
def test_optimiser_over_streams_matches_single_streams(kind):
    """The three DiMP-family filter optimisers with S = 3 sequences (one
    convolution per sequence) against three S = 1 calls, with sample
    weights, 2 iterations: the same filters to float32 rounding."""
    from pytracking_tpu_torch.models.classifier.optimizer import (DiMPSteepestDescentGN,
                                                                  PrDiMPSteepestDescentNewton)
    from pytracking_tpu_torch.models.classifier.residual_modules import GNSteepestDescentDiMP
    from test_torch_dimp_family_ops import GN_KW, NEWTON_KW, SIMPLE_KW

    opt = {"gn": lambda: DiMPSteepestDescentGN(**GN_KW),
           "newton": lambda: PrDiMPSteepestDescentNewton(**NEWTON_KW),
           "simple": lambda: GNSteepestDescentDiMP(**SIMPLE_KW)}[kind]()
    rng = np.random.RandomState(5)
    N, S, C = 6, 3, 16
    feat = torch.from_numpy(rng.randn(N, S, C, 6, 6).astype(np.float32) * 0.1)
    bb = torch.from_numpy(np.concatenate([rng.rand(N, S, 2) * 40 + 20, rng.rand(N, S, 2) * 20 + 16],
                                         -1).astype(np.float32))
    sw = torch.from_numpy(rng.rand(N, S).astype(np.float32))
    w0 = torch.from_numpy(rng.randn(S, 1, C, 4, 4).astype(np.float32) * 0.05)
    with torch.no_grad():
        got = opt(w0, feat, bb, sample_weight=sw, num_iter=2)
        for s in range(S):
            ref = opt(w0[s:s + 1], feat[:, s:s + 1], bb[:, s:s + 1],
                      sample_weight=sw[:, s:s + 1], num_iter=2)
            _close(got[s:s + 1].numpy(), ref.numpy(), atol=1e-6)


@pytest.mark.parametrize("part", ["localize", "refine", "memory", "memory_replace_key"])
def test_one_stream_wrappers_match_the_stream_axis(nets, part):
    """The single tracker's one-stream wrappers, which KYS and KeepTrack
    call (`_localize`, `_refine_target_box`, `_update_memory_masked` with
    and without KeepTrack's replace key), against stream b of the
    stream-axis methods on 3 stacked streams: flags, replace slots and
    counts equal; translations, boxes and memory to float32 rounding."""
    tr = t_dimp.DiMPTracker(t_dimp.DiMPParams(**_kw(**HARD_NEGATIVES)), nets[2], device="cpu")
    states = []
    for b in range(B):
        tr.initialize(frame(b, 0), {"init_bbox": init_box(b)})
        states.append(tr.state)
    stacked = t_dimp.DiMPTracker.stack_states(states)
    rng = np.random.RandomState(7)
    sample_pos = stacked.pos + torch.from_numpy(rng.randn(B, 2).astype(np.float32))
    sample_scale = stacked.target_scale * torch.from_numpy(rng.uniform(0.9, 1.1, B)
                                                           .astype(np.float32))
    if part == "localize":
        scores = torch.from_numpy(rng.rand(B, 7, 7).astype(np.float32) * 0.3)
        scores[0, 3, 3], scores[1, 1, 5], scores[1, 5, 1], scores[2, 4, 2] = 1.0, 0.9, 0.85, 0.6
        got = tr._localize_streams(stacked, scores, sample_pos, sample_scale)
        for b in range(B):
            ref = tr._localize(t_dimp.DiMPTracker.stream_state(stacked, b), scores[b],
                               sample_pos[b], sample_scale[b])
            np.testing.assert_allclose(got[0][b].numpy(), ref[0].numpy(), atol=1e-5, rtol=0)
            assert int(got[1][b]) == int(ref[1]) and float(got[2][b]) == float(ref[2])
        assert len({int(f) for f in got[1]}) > 1, got[1]
    elif part == "refine":
        with torch.no_grad():
            feat = tr.net.extract_backbone(torch.from_numpy(
                rng.rand(B, 3, 96, 96).astype(np.float32) * 255))
        jitter = torch.from_numpy(rng.rand(B, 2, 4).astype(np.float32))
        found = torch.tensor([True, True, False])
        got = tr._refine_streams(stacked, feat, sample_pos, sample_scale, found, True,
                                 lambda shape: jitter)
        for b in range(B):
            tr._uniform = lambda shape, u=jitter[b]: u
            ref = tr._refine_target_box(t_dimp.DiMPTracker.stream_state(stacked, b),
                                        {k: v[b:b + 1] for k, v in feat.items()},
                                        sample_pos[b], sample_scale[b], found[b])
            for x, name in zip(got, ("pos", "target_sz", "target_scale")):
                np.testing.assert_allclose(x[b].numpy(), getattr(ref, name).numpy(),
                                           atol=1e-3, rtol=0, err_msg=name)
    else:
        M = stacked.mem_weights.shape[0]
        w = rng.rand(M, B).astype(np.float32) + 0.1
        stacked.mem_weights = torch.from_numpy(w / w.sum(0))
        stacked.num_stored = torch.tensor([M, M, 2], dtype=torch.int32)
        stacked.prev_ind = torch.tensor([-1, 3, 5], dtype=torch.int32)
        sample = torch.from_numpy(rng.randn(*stacked.mem_samples.shape[1:]).astype(np.float32))
        box = torch.from_numpy(rng.rand(B, 4).astype(np.float32) * 30)
        lr = torch.tensor([0.01, 0.02, 0.01])
        do_update = torch.tensor([True, True, False])
        key = torch.from_numpy(rng.rand(M, B).astype(np.float32)) \
            if part == "memory_replace_key" else None
        singles = [t_dimp.DiMPTracker.stream_state(stacked, b) for b in range(B)]
        new = tr._update_memory_streams(stacked, sample, box, lr, do_update, key)
        for b, single in enumerate(singles):
            ref = tr._update_memory_masked(single, sample[b], box[b], lr[b], do_update[b],
                                           None if key is None else key[:, b])
            assert int(new["prev_ind"][b]) == int(ref.prev_ind), b
            assert int(new["num_stored"][b]) == int(ref.num_stored), b
            np.testing.assert_allclose(new["mem_weights"][:, b].numpy(), ref.mem_weights.numpy(),
                                       atol=1e-7, rtol=0)
            assert torch.equal(stacked.mem_samples[:, b], ref.mem_samples), b
            assert torch.equal(stacked.mem_boxes[:, b], ref.mem_boxes), b


# ---------------------------------------------------------------- the interface

def test_unequal_frame_sizes_raise(nets):
    server = BatchedTrackerServer(t_dimp.DiMPTracker, t_dimp.DiMPParams(**_kw()), nets[2],
                                  device="cpu", bf16=False)
    with pytest.raises(ValueError, match="differ in size"):
        server.initialize([frame(0, 0), frame(1, 0)[:120]], [init_box(0), init_box(1)])
    server.initialize([frame(0, 0), frame(1, 0)], [init_box(0), init_box(1)])
    with pytest.raises(ValueError, match="for 2 streams"):
        server.track(batch(1))


def test_server_refuses_a_tracker_with_another_step(nets):
    """KeepTrack subclasses the DiMP tracker with a step of its own (the
    candidate association) and gives no stream-axis step for it, so the
    server refuses it."""
    from pytracking_tpu_torch.trackers.keep_track import KeepTrackTracker

    with pytest.raises(NotImplementedError, match="no stream-axis counterpart"):
        BatchedTrackerServer(KeepTrackTracker, t_dimp.DiMPParams(**_kw()), nets[2], device="cpu")


def test_stack_and_stream_state_round_trip(nets):
    """`stack_states` then `stream_state` gives each stream's state back,
    as copies."""
    singles = _singles(nets[2], _kw())
    stacked = t_dimp.DiMPTracker.stack_states([tr.state for tr in singles])
    assert stacked.mem_samples.shape[:2] == (8, B)
    for b, tr in enumerate(singles):
        back = t_dimp.DiMPTracker.stream_state(stacked, b)
        for f in dataclasses.fields(back):
            x, y = getattr(back, f.name), getattr(tr.state, f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), f.name
                assert x.data_ptr() != y.data_ptr(), f.name
            else:
                assert x == y
