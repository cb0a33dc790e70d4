"""The port's batched server (`pytracking_tpu_torch/parallel/serving.py`) on
ToMP, TaMOs and KYS, each through its class's stream-axis step, against the
JAX package's `BatchedTrackerServer` (which vmaps each tracker's step) and
against single-stream port trackers, on the CPU.

Nets: the tiny ToMP of test_torch_tomp.py (d = 64, 6x6 grid, 96x96
samples), the tiny TaMOs of test_torch_tamos.py (d = 32, 4x6 grid, K = 3
slots) and a TaMOs of one 32-wide head on an 8x12 grid, whose encoder
(L = 288, head dim 32) takes the fused attention's route (on the CPU its
plain version), and the tiny KYS of test_torch_kys.py; weights converted
from the JAX `net.init`. Three streams, each its own target (size, colour,
motion) on its own texture; every stream is initialised as the JAX server
initialises it, `{"init_bbox": box}` (TaMOs: single-object mode, K slots).
The JAX trackers run without frame-shape buckets.

Each JAX server runs once per module (f32 and bf16), its boxes and states
recorded after every step; the port's servers run free from their own
initialisation (ToMP and TaMOs draw nothing; KYS takes the JAX streams' box
jitter, each stream's key split as the JAX tracker splits it, and the JAX
dropout mask at initialisation). KYS ticks (train_skipping 4) after the
fourth step. Limits against JAX: flags and stored counts equal; boxes within
1e-3 px; memory, filters and the propagation state within 1e-4 of their
scale. The bf16 servers (every float32 weight rounded through bf16 on both
sides, the JAX one compiled with XLA's excess precision off) are held to
the same limits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytracking_tpu_torch.models.transformer import got_filter_predictor as t_got
from pytracking_tpu_torch.models.transformer import transformer as t_transformer
from pytracking_tpu_torch.parallel.serving import BatchedTrackerServer
from pytracking_tpu_torch.trackers import kys as t_kys
from pytracking_tpu_torch.trackers import tamos as t_tamos
from pytracking_tpu_torch.trackers import tomp as t_tomp
from pytracking_tpu_torch.utils.convert_weights import tamosnet_from_flax

from test_torch_dimp_family import BASE
from test_torch_dimp_family_ops import OUT_DIM, _nchw
from test_torch_lwl_ops import one_thread  # noqa: F401 (autouse: one CPU thread)
from test_torch_serving import _exact

B, T = 3, 6
_SIZE = [(20, 18), (16, 24), (24, 20)]
_COLOUR = [(220, 60, 60), (60, 200, 90), (230, 220, 40)]


def frame(b, t, H=128, W=128):
    """Stream b's frame t: a target of its own size and colour on its own
    texture, moving (+2, 3 - b) px per frame."""
    im = np.random.RandomState(b).randint(0, 60, (H, W, 3)).astype(np.uint8)
    h, w = _SIZE[b]
    cy, cx = 50 + 6 * b + 2 * t, 48 + 5 * b + (3 - b) * t
    im[cy - h // 2:cy + h // 2, cx - w // 2:cx + w // 2] = _COLOUR[b]
    return im


def init_box(b):
    h, w = _SIZE[b]
    return [48.0 + 5 * b - w // 2, 50.0 + 6 * b - h // 2, float(w), float(h)]


# ---------------------------------------------------------------- the families

TOMP_NOT_FOUND = 10.5


def _tomp():
    from pytracking_tpu.trackers.tomp import ToMPParams, ToMPTracker
    from test_torch_tomp import nets

    kw = dict(train_feature_size=6, target_not_found_threshold=TOMP_NOT_FOUND, conf_ths=9.0)
    return nets.__wrapped__(), (ToMPTracker, ToMPParams), (t_tomp.ToMPTracker, t_tomp.ToMPParams), \
        kw, (128, 128)


def _tamos_pair(feat, nhead, seed):
    """test_torch_tamos.py's tiny TaMOs (d = 32, K = 3) on a `feat` grid with
    `nhead` heads: (jax net, its variables as numpy, the port's net)."""
    from pytracking_tpu.models.backbones.resnet import ResNet
    from pytracking_tpu.models.classifier.features import ResidualBottleneck
    from pytracking_tpu.models.tracking.tamosnet import FPN, TaMOsNet
    from pytracking_tpu.models.transformer.got_filter_predictor import GOTFilterPredictor
    from pytracking_tpu.models.transformer.heads import DenseBoxRegressor, LinearFilterClassifier
    from pytracking_tpu.models.transformer.transformer import Transformer
    import test_torch_tamos as tt

    d, K = tt.D_MODEL, tt.K
    jnet = TaMOsNet(
        feature_extractor=ResNet(block="bottleneck", layers=(1, 1, 1, 1),
                                 output_layers=("layer2", "layer3"), base_width=8),
        head_feature_extractor=ResidualBottleneck(feature_dim=16, num_blocks=0, l2norm=True,
                                                  final_conv=True, norm_scale=d ** -0.5,
                                                  out_dim=d),
        filter_predictor=GOTFilterPredictor(
            Transformer(d_model=d, nhead=nhead, num_encoder_layers=2, num_decoder_layers=2,
                        dim_feedforward=64), feature_sz=max(feat), num_tokens=K,
            box_enc="ltrb_token"),
        classifier=LinearFilterClassifier(num_channels=d),
        bb_regressor=DenseBoxRegressor(num_channels=d), fpn=FPN(output_dim=d))
    tnet = tt.torch_tiny_tamosnet()
    tnet.filter_predictor = t_got.GOTFilterPredictor(
        t_transformer.Transformer(d_model=d, nhead=nhead, num_encoder_layers=2,
                                  num_decoder_layers=2, dim_feedforward=64),
        feature_sz=max(feat), num_tokens=K, box_enc="ltrb_token").eval()
    tr = jnp.zeros((1, 1, feat[0] * 16, feat[1] * 16, 3))
    lab = jnp.zeros((1, 1, K) + feat)
    ltrb = jnp.zeros((1, 1, K) + feat + (4,))
    variables = jax.jit(lambda k: jnet.init(k, tr, tr, lab, ltrb, train=False))(
        jax.random.PRNGKey(seed))
    variables = jax.tree_util.tree_map(np.asarray, tt._perturb_batch_stats(
        jax.tree_util.tree_map(np.asarray, dict(variables)), seed=seed + 7))
    tnet.load_state_dict(tamosnet_from_flax(variables, tnet))
    return jnet, variables, tnet


def _tamos(feat=(4, 6), nhead=4, seed=0, **cuts):
    from pytracking_tpu.trackers.tamos import TaMOsParams, TaMOsTracker

    kw = dict(dict(train_feature_size=feat, num_tokens=3, sample_memory_size=2,
                   target_not_found_threshold=TAMOS_NOT_FOUND, conf_ths=TAMOS_CONF), **cuts)
    return _tamos_pair(feat, nhead, seed), (TaMOsTracker, TaMOsParams), \
        (t_tamos.TaMOsTracker, t_tamos.TaMOsParams), kw, (128, 192)


# the fused attention's route: one 32-wide head, L = 3 * 8 * 12 = 288 >= 256
FUSED_FEAT = (8, 12)
TAMOS_NOT_FOUND, TAMOS_CONF = 0.05, 0.053
# its sigmoid scores saturate at 1: the raw ones, peaks 11.5-13.3
FUSED_CUTS = dict(normalize_scores=False, target_not_found_threshold=12.0, conf_ths=12.4)


def _tamos_fused():
    return _tamos(FUSED_FEAT, nhead=1, seed=1, **FUSED_CUTS)


KYS_NOT_FOUND = 0.4721


def _kys():
    from pytracking_tpu.trackers.kys import KYSParams, KYSTracker
    from test_torch_kys import tiny_kys_pair

    kw = dict(BASE, target_not_found_threshold_fused=KYS_NOT_FOUND)
    return tiny_kys_pair(), (KYSTracker, KYSParams), (t_kys.KYSTracker, t_kys.KYSParams), kw, \
        (128, 128)


FAMILIES = {"tomp": _tomp, "tamos": _tamos, "tamos_fused": _tamos_fused, "kys": _kys}


# ---------------------------------------------------------------- the runs

def _kys_keep_mask(kw):
    """The JAX tracker's dropout keep mask at initialisation, in the port's
    layout (test_torch_kys_tracker.py)."""
    drop_key = jax.random.split(jax.random.PRNGKey(0))[1]
    n_drop, prob = dict(kw["augmentation"])["dropout"]

    def keep_mask(shape, p):
        assert tuple(shape) == (n_drop, OUT_DIM, 1, 1) and p == prob
        return _nchw(jax.random.bernoulli(drop_key, 1.0 - p, (n_drop, 1, 1, OUT_DIM))) > 0.5
    return keep_mask


def _frames0(size):
    return [frame(b, 0, *size) for b in range(B)]


def _batch(t, size):
    return np.stack([frame(b, t, *size) for b in range(B)])


def _snapshot(name, js) -> dict:
    """The JAX server's stacked state in the port's batched layout (numpy)."""
    def a(x, *perm):
        x = np.asarray(x)
        return x.transpose(*perm) if perm else x

    out = {n: a(getattr(js, n)) for n in ("flag", "num_stored", "prev_ind", "max_score")}
    out["mem_weights"] = a(js.mem_weights, 1, 0)
    if name == "tomp":
        out.update(mem_samples=a(js.mem_samples, 1, 0, 4, 2, 3),
                   mem_labels=a(js.mem_labels, 1, 0, 2, 3), mem_boxes=a(js.mem_boxes, 1, 0, 2),
                   scale_history=a(js.scale_history), scale_hist_len=a(js.scale_hist_len),
                   not_found_counter=a(js.not_found_counter))
    elif name.startswith("tamos"):
        out.update(mem_samples=a(js.mem_samples, 1, 0, 4, 2, 3),
                   mem_labels=a(js.mem_labels, 1, 0, 2, 3, 4),
                   mem_boxes=a(js.mem_boxes, 1, 0, 2, 3))
    else:
        out.update(mem_samples=a(js.mem_samples, 1, 0, 4, 2, 3),
                   mem_boxes=a(js.mem_boxes, 1, 0, 2),
                   target_filter=a(np.asarray(js.target_filter)[:, 0], 0, 4, 3, 1, 2),
                   motion_feat_prev=a(np.asarray(js.motion_feat_prev)[:, 0], 0, 3, 1, 2),
                   state_vector=a(np.asarray(js.state_vector)[:, 0], 0, 3, 1, 2),
                   prev_label=a(np.asarray(js.prev_label)[:, 0, :, :, 0])[:, None],
                   have_state=a(js.have_state), prev_box_patch=a(js.prev_box_patch))
    return out


def _jax_run(name, bf16):
    """The JAX server's run: initialise, T steps. Returns per step the boxes,
    the state snapshot and (KYS) each stream's jitter draws."""
    from pytracking_tpu.parallel.serving import BatchedTrackerServer as JServer

    (jnet, variables, _), (jcls, jparams), _, kw, size = FAMILY_CACHE(name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTRACKING_TPU_SHAPE_BUCKETS", "0")
        js = JServer(jcls, jparams(**kw), jnet, variables, bf16=bf16)
        if bf16:
            for obj in (js, js.tracker):
                for n in [n for n in vars(obj) if n.startswith("_jit") and vars(obj)[n]]:
                    setattr(obj, n, _exact(getattr(obj, n)))
        js.initialize(_frames0(size), [init_box(b) for b in range(B)])
        steps = [{"state": _snapshot(name, js.states)}]
        for t in range(1, T + 1):
            step = {}
            if name == "kys":
                K = kw["num_init_random_boxes"]
                step["jitter"] = np.stack([np.asarray(jax.random.uniform(
                    jax.random.split(js.states.key[b])[1], (K, 4))) for b in range(B)])
            step["boxes"] = np.asarray(js.track(_batch(t, size)))
            step["state"] = _snapshot(name, js.states)
            steps.append(step)
    return steps


_CACHE = {}


def FAMILY_CACHE(name):
    if name not in _CACHE:
        _CACHE[name] = FAMILIES[name]()
    return _CACHE[name]


def JAX_RUN(name, bf16=False):
    if (name, bf16) not in _CACHE:
        _CACHE[name, bf16] = _jax_run(name, bf16)
    return _CACHE[name, bf16]


def _port_server(name, bf16=False, n=B):
    """The port's server of `name` on the CPU, initialised on the first n
    streams (KYS with the JAX dropout mask)."""
    (_, _, tnet), _, (tcls, tparams), kw, size = FAMILY_CACHE(name)
    ts = BatchedTrackerServer(tcls, tparams(**kw), tnet, device="cpu", bf16=bf16)
    if name == "kys":
        ts.tracker._keep_mask = _kys_keep_mask(kw)
    ts.initialize(_frames0(size)[:n], [init_box(b) for b in range(n)])
    return ts


# state fields held equal, within 1e-3 px, and within 1e-4 of their scale
_EXACT = ("flag", "num_stored", "prev_ind")
_PX = ("mem_boxes",)
_SCALED = {"tomp": ("mem_samples", "mem_labels", "mem_weights", "scale_history"),
           "tamos": ("mem_samples", "mem_labels", "mem_weights"),
           "kys": ("mem_samples", "mem_weights", "target_filter", "motion_feat_prev",
                   "state_vector", "prev_label")}
_EXACT_MORE = {"tomp": ("not_found_counter", "scale_hist_len"), "tamos": (), "kys": ("have_state",)}


def _scaled(got, ref, what, tol=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (what, err, np.abs(ref).max())


def check_state(name, st, ref, what):
    """A port batched state against a snapshot in the port's layout."""
    family = "tamos" if name.startswith("tamos") else name
    for n in _EXACT + _EXACT_MORE[family]:
        np.testing.assert_array_equal(getattr(st, n).numpy(), ref[n], err_msg=f"{what} {n}")
    for n in _PX + (("prev_box_patch",) if family == "kys" else ()):
        np.testing.assert_allclose(getattr(st, n).numpy(), ref[n], atol=1e-3, rtol=0,
                                   err_msg=f"{what} {n}")
    for n in _SCALED[family]:
        _scaled(getattr(st, n).numpy(), ref[n], f"{what} {n}")


def run_against_jax(name, bf16=False):
    """The port's server stepped free beside the recorded JAX run; every
    step held to the limits. Returns the port's flags per step."""
    steps = JAX_RUN(name, bf16)
    size = FAMILY_CACHE(name)[-1]
    ts = _port_server(name, bf16)
    check_state(name, ts.states, steps[0]["state"], "init")
    flags = []
    for t, step in enumerate(steps[1:], 1):
        if "jitter" in step:
            ts._uniform = lambda shape, u=torch.from_numpy(step["jitter"]): u
        boxes = ts.track(_batch(t, size))
        np.testing.assert_array_equal(ts.flags, step["state"]["flag"], err_msg=f"step {t}")
        np.testing.assert_allclose(boxes, step["boxes"], atol=1e-3, rtol=0, err_msg=f"step {t}")
        np.testing.assert_allclose(ts.max_scores, step["state"]["max_score"],
                                   atol=1e-4 * np.abs(step["state"]["max_score"]).max(), rtol=0)
        check_state(name, ts.states, step["state"], f"step {t}")
        flags.append(ts.flags)
    return ts, np.stack(flags)


# ---------------------------------------------------------------- against JAX

@pytest.mark.parametrize("name", list(FAMILIES))
def test_server_matches_jax_server(name):
    """Each family's f32 server against the JAX server, step by step. The
    flags mix per stream (ToMP: uncertain, hard negative and not_found
    frames; TaMOs: found and lost objects, memory writes in some streams
    only; KYS: a lost stream before the others, and the tick)."""
    ts, flags = run_against_jax(name)
    assert ts.tracker._serve_reads_flags is False
    assert ts._deferred == (name == "kys")
    assert len({tuple(np.ravel(f)) for f in flags[:, 0]}) + len(np.unique(flags)) > 2, flags


@pytest.mark.parametrize("name", list(FAMILIES))
def test_bf16_server_matches_jax_bf16_server(name, monkeypatch):
    """The default server (bf16: every float32 weight of a copy of the net
    rounded through bf16, the BatchNorms' multipliers in bf16) against the
    JAX server's bf16 default (every float32 variable stored as bf16,
    promoted where a layer computes in float32: the transformer's
    projections, LayerNorms and box encoder as the heads), at the f32
    limits."""
    monkeypatch.delenv("PYTRACKING_TPU_SERVING_BF16", raising=False)
    tnet = FAMILY_CACHE(name)[0][2]
    w = next(iter(tnet.parameters()))
    before = w.clone()
    ts, _ = run_against_jax(name, bf16=True)
    assert ts.bf16 and ts.tracker.net is not tnet and torch.equal(w, before)


# ---------------------------------------------------------------- against single trackers

@pytest.mark.parametrize("name", ["tomp", "tamos", "kys"])
def test_server_matches_single_trackers(name):
    """B single port trackers against the server, T frames, each single step
    from the server's stream state (copied); the KYS singles run the
    deferred update and refit at the tick, their generators seeded alike
    (the server's one draw per step, expanded, is each one's). Flags,
    stored counts equal; boxes within 1e-3 px; memory (and KYS's filter
    and propagation state) within 1e-4 of scale."""
    (_, _, tnet), _, (tcls, tparams), kw, size = FAMILY_CACHE(name)
    server = BatchedTrackerServer(tcls, tparams(**kw), tnet, device="cpu", bf16=False)
    server.initialize(_frames0(size), [init_box(b) for b in range(B)])
    single_kw = dict(kw, defer_classifier_update=True) if name == "kys" else kw
    singles = [tcls(tparams(**single_kw), tnet, device="cpu") for _ in range(B)]
    for b, tr in enumerate(singles):
        tr.initialize(frame(b, 0, *size), {"init_bbox": init_box(b)})
    ticks = 0
    for t in range(1, T + 1):
        for b, tr in enumerate(singles):
            tr.state = server.tracker.stream_state(server.states, b)
        boxes = server.track(_batch(t, size))
        ticks += server.tracker._serve_tick_due(server._frame_num)
        for b, tr in enumerate(singles):
            out = tr.track(frame(b, t, *size))
            if name == "kys" and tr._serve_tick_due(tr.state.frame_num):
                tr.update_classifier_deferred()
            ref = server.tracker.stack_states([tr.state])
            check_state(name, server.tracker.stack_states([server.tracker.stream_state(
                server.states, b)]), {f.name: getattr(ref, f.name).numpy()
                                      for f in dataclasses.fields(ref) if f.name != "frame_num"},
                f"step {t} stream {b}")
            if name == "tamos":
                np.testing.assert_allclose(boxes[b, 0], out["target_bbox"], atol=1e-3, rtol=0)
            else:
                np.testing.assert_allclose(boxes[b], out["target_bbox"], atol=1e-3, rtol=0)
    assert ticks == (name == "kys")


# ---------------------------------------------------------------- the interface

@pytest.mark.parametrize("name", ["tomp", "tamos", "kys"])
def test_scan_track_matches_stepwise(name, monkeypatch):
    """`scan_track` over (T, B, H, W, 3) against T calls of `track`: the
    same boxes and states, and one readback for the whole sequence (no
    refit of these classes is chosen from the flags; KYS's tick is on the
    host's frame count)."""
    size = FAMILY_CACHE(name)[-1]
    servers = [_port_server(name) for _ in range(2)]
    step_boxes = np.stack([servers[0].track(_batch(t, size)) for t in range(1, T + 1)])
    reads = []
    read = BatchedTrackerServer._read
    monkeypatch.setattr(BatchedTrackerServer, "_read",
                        lambda self, out: reads.append(1) or read(self, out))
    scan_boxes = servers[1].scan_track(torch.from_numpy(np.stack([_batch(t, size)
                                                                  for t in range(1, T + 1)])))
    assert len(reads) == 1
    np.testing.assert_array_equal(scan_boxes, step_boxes)
    a, b = servers[1].states, servers[0].states
    assert a.frame_num == b.frame_num == T + 1
    for f in dataclasses.fields(a):
        if f.name != "frame_num":
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


@pytest.mark.parametrize("n", [1, B])
def test_tamos_streams_share_one_encoder_batch(n, monkeypatch):
    """Served TaMOs on the fused route: each encoder layer calls the fused
    attention once per step whatever the number of streams, on a batch of
    2n (each stream's classification and box-regression copies), the key
    mask each stream's own slots; the single tracker is the case n = 1."""
    from pytracking_tpu_torch.models.transformer import transformer as tr_mod

    size = FAMILY_CACHE("tamos_fused")[-1]
    ts = _port_server("tamos_fused", n=n)
    calls = []
    fused = tr_mod.fused_self_attention

    def counting(q, k, v, key_keep_mask=None):
        calls.append((q.shape[0], key_keep_mask))
        return fused(q, k, v, key_keep_mask=key_keep_mask)

    monkeypatch.setattr(tr_mod, "fused_self_attention", counting)
    for t in (1, 2):
        stored = ts.states.num_stored.clone()
        calls.clear()
        ts.track(np.stack([frame(b, t, *size) for b in range(n)]))
        layers = len(ts.tracker.net.filter_predictor.transformer.encoder)
        assert [c[0] for c in calls] == [2 * n] * layers
        hw = FUSED_FEAT[0] * FUSED_FEAT[1]
        slot = torch.arange(2).repeat_interleave(hw)
        for _, keep in calls:
            for b in range(n):
                cls_keep = torch.cat([slot < stored[b], torch.ones(hw, dtype=torch.bool)])
                bb_keep = torch.cat([slot < 1, torch.ones(hw, dtype=torch.bool)])
                assert torch.equal(keep[b], cls_keep) and torch.equal(keep[n + b], bb_keep)


def test_server_refuses_a_subclass_without_its_stream_step():
    """A subclass that defines the single tracker's step again, and not its
    stream-axis step, is refused, whichever family it comes from
    (KeepTrack's refusal is in test_torch_serving.py)."""
    from pytracking_tpu_torch.trackers.tamos import TaMOsTracker

    sub = type("NoStreams", (TaMOsTracker,), {"_track_from_patch": TaMOsTracker._track_from_patch})
    with pytest.raises(NotImplementedError, match="NoStreams._track_from_patch"):
        BatchedTrackerServer(sub, None, None, device="cpu")
