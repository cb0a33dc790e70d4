"""The port's training dataset readers, candidate matching processing and
sampler, distractor dump and `masks_to_bboxes` against the JAX package's,
on the CPU, on trees written by training/datasets/training_trees.py
(128x96 JPEG frames, 20 per video sequence, each dataset's irregular cases).

Every reader gives what its JAX twin gives, field for field and bit for
bit: the dataset's flags, its sequence list, every sequence's info arrays,
frames, per-frame annotations (COCO's PIL-filled polygon masks included)
and class names. The candidate matching processing draws from a passed
`np.random.RandomState`, the JAX class from the global one: seeded alike,
equal outputs. No JAX function is jitted; the one JAX array function
(`masks_to_bboxes`) runs op by op.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import pytracking_tpu.evaluation.environment as j_env
import pytracking_tpu_torch.evaluation.environment as t_env
from pytracking_tpu_torch.training.datasets import training_trees

SIZE = (128, 96)
FRAMES = 20


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("training_trees")
    return training_trees.write_training_trees(str(root), frames=FRAMES, size=SIZE)


@pytest.fixture
def specs(trees, monkeypatch):
    """Both packages' split files and LaSOT path pointed at the trees."""
    for name, value in training_trees.environment_variables(trees).items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(j_env, "_env_settings", None)
    t_env.reset_env_settings()
    yield trees
    t_env.reset_env_settings()


def _same(got, ref, where="out"):
    """Equal values of equal types: arrays by dtype, shape and bits, dicts
    by their keys in order, lists and tuples item by item."""
    if isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == ref.dtype and got.shape == ref.shape, \
            f"{where}: {got.dtype}{got.shape} vs {ref.dtype}{ref.shape}"
        np.testing.assert_array_equal(got, ref, err_msg=where)
    elif isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), f"{where}: {list(got)}"
        for k in ref:
            _same(got[k], ref[k], f"{where}[{k!r}]")
    elif isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref), f"{where}: {got!r}"
        for i, (g, r) in enumerate(zip(got, ref)):
            _same(g, r, f"{where}[{i}]")
    else:
        assert type(got) is type(ref) and (got == ref or (got != got and ref != ref)), \
            f"{where}: {got!r} vs {ref!r}"


def _frame_ids(ds, seq_id):
    if not ds.is_video_sequence():
        return [0, 0]
    n = len(ds.get_sequence_info(seq_id)["bbox"])
    return [0, 1, n - 1]


FLAGS = ("get_name", "get_num_sequences", "is_video_sequence", "has_class_info",
         "has_occlusion_info", "has_segmentation_info", "is_mot_dataset")


def assert_same_reader(t, j, sequences="sequence_list"):
    """Flags, the sequence list (`sequences`: the attribute holding it),
    and every sequence's info and frames at three of its frame ids."""
    for flag in FLAGS:
        assert hasattr(t, flag) == hasattr(j, flag), flag
        if hasattr(j, flag):
            assert getattr(t, flag)() == getattr(j, flag)(), flag
    _same(getattr(t, sequences), getattr(j, sequences), sequences)
    assert t.get_num_sequences() > 0
    for s in range(j.get_num_sequences()):
        info = j.get_sequence_info(s)
        _same(t.get_sequence_info(s), info, f"info {s}")
        ids = _frame_ids(j, s)
        _same(t.get_frames(s, ids), j.get_frames(s, ids, info), f"frames {s}")
        _same(t.get_frames(s, ids[:1], info), j.get_frames(s, ids[:1]), f"frames {s} anno")


def _readers(kind):
    """(port module, JAX module) of training/datasets/<kind>.py."""
    import importlib
    return (importlib.import_module(f"pytracking_tpu_torch.training.datasets.{kind}"),
            importlib.import_module(f"pytracking_tpu.training.datasets.{kind}"))


# (module, class or factory, tree, kwargs)
READERS = {
    "lasot": ("lasot", "Lasot", "lasot", {}),
    "lasot_train": ("lasot", "Lasot", "lasot", {"split": "train"}),
    "lasot_vid_ids": ("lasot", "Lasot", "lasot", {"vid_ids": [2]}),
    "got10k": ("got10k", "Got10k", "got10k", {}),
    "got10k_train": ("got10k", "Got10k", "got10k", {"split": "train"}),
    "got10k_val": ("got10k", "Got10k", "got10k", {"split": "val"}),
    "got10k_vottrain": ("got10k", "Got10k", "got10k", {"split": "vottrain"}),
    "got10k_votval": ("got10k", "Got10k", "got10k", {"split": "votval"}),
    "got10k_seq_ids": ("got10k", "Got10k", "got10k", {"seq_ids": [2, 1]}),
    "trackingnet": ("tracking_net", "TrackingNet", "trackingnet", {}),
    "trackingnet_sets": ("tracking_net", "TrackingNet", "trackingnet", {"set_ids": [0, 1, 2, 3]}),
    "coco_seq": ("coco_seq", "MSCOCOSeq", "coco", {}),
    "coco_seq_area": ("coco_seq", "MSCOCOSeq", "coco", {"min_area": 400.0}),
    "coco_mot": ("mot_datasets", "MSCOCOMOTSeq", "coco", {}),
    "coco_mot_max": ("mot_datasets", "MSCOCOMOTSeq", "coco", {"max_objects": 1}),
    "imagenet_vid": ("imagenetvid", "ImagenetVID", "imagenet_vid", {}),
    "imagenet_vid_min": ("imagenetvid", "ImagenetVID", "imagenet_vid", {"min_length": 18}),
    "taoburst_multi": ("tao_burst", "TAOBURST", "taoburst", {}),
    "taoburst_single": ("tao_burst", "TAOBURST", "taoburst", {"multiobj": False}),
    "davis": ("vos_base", "Davis", "davis", {}),
    "youtubevos": ("vos_base", "YouTubeVOS", "youtubevos", {}),
    "got10k_vos": ("vos_wrappers", "make_got10k_vos", "got10k", {"mask_root": "got10k_masks"}),
    "lvis": ("vos_wrappers", "LVIS", "lvis", {}),
    "ecssd": ("seg_images", "ECSSD", "ecssd", {}),
    "msra10k": ("seg_images", "MSRA10k", "msra10k", {}),
    "hkuis": ("seg_images", "HKUIS", "hkuis", {}),
    "sbd": ("seg_images", "SBD", "sbd", {}),
}


def _make(side, case, trees):
    module, name, tree, kwargs = READERS[case]
    kwargs = {k: trees[v] if k == "mask_root" else v for k, v in kwargs.items()}
    return getattr(_readers(module)[side], name)(trees[tree], **kwargs)


@pytest.mark.parametrize("case", sorted(READERS))
def test_reader_matches_jax(specs, case):
    t, j = _make(0, case, specs), _make(1, case, specs)
    assert_same_reader(t, j)


def test_imagenet_vid_mot_and_cache_match_jax(specs):
    """ImageNet-VID's tracklets parsed by each package, the cache.json each
    writes (read back by the other), and ImagenetVIDMOT over it."""
    t_vid, j_vid = _readers("imagenetvid")
    t_mot, j_mot = _readers("mot_datasets")
    root = specs["imagenet_vid"]
    cache = os.path.join(root, "cache.json")
    anno = j_vid._process_anno(root)
    _same(t_vid._process_anno(root), anno, "tracklets")
    assert {len(s["anno"]) for s in anno} == {FRAMES, FRAMES - 5}
    written = {}
    for side, module in (("torch", t_vid), ("jax", j_vid)):
        if os.path.exists(cache):
            os.remove(cache)
        module.ImagenetVID(root)
        written[side] = open(cache).read()
    assert written["torch"] == written["jax"]
    t, j = t_mot.ImagenetVIDMOT(root), j_mot.ImagenetVIDMOT(root)
    assert_same_reader(t, j, sequences="videos")
    assert t.get_num_sequences() == 2


def test_synthetic_video_blend_matches_jax(specs):
    t_seg, j_seg = _readers("seg_images")
    t_blend, j_blend = _readers("synthetic_video_blend")
    t = t_blend.SyntheticVideoBlend(t_seg.ECSSD(specs["ecssd"]), t_seg.MSRA10k(specs["msra10k"]),
                                    seq_len=6, seed=3)
    j = j_blend.SyntheticVideoBlend(j_seg.ECSSD(specs["ecssd"]), j_seg.MSRA10k(specs["msra10k"]),
                                    seq_len=6, seed=3)
    assert_same_reader(t, j)
    frames, anno, _ = t.get_frames(0, [0, 5])
    assert anno["mask"][1].sum() > 0 and anno["bbox"][1][2] > 0


def test_coco_image_dataset_matches_jax(specs):
    """MSCOCO's image API: the images, their annotations and masks, class
    names and the images of a class."""
    t_coco, j_coco = _readers("coco_seq")
    t, j = t_coco.MSCOCO(specs["coco"]), j_coco.MSCOCO(specs["coco"])
    assert t.get_num_images() == j.get_num_images() > 0
    for name in ("square", "distractor", "none"):
        assert t.get_images_in_class(name) == j.get_images_in_class(name)
    for i in range(j.get_num_images()):
        assert t.get_class_name(i) == j.get_class_name(i)
        _same(t.get_image_info(i), j.get_image_info(i), f"info {i}")
        _same(t.get_image(i), j.get_image(i), f"image {i}")
    # the run-length encoded instance falls back to its box
    rle = [i for i, a in enumerate(t.sequence_list) if isinstance(a["segmentation"], dict)]
    assert len(rle) == 1
    _, anno, _ = t.get_image(rle[0])
    x, y, w, h = [int(v) for v in t.sequence_list[rle[0]]["bbox"]]
    assert anno["mask"].sum() == anno["mask"][y:y + h, x:x + w].size


def test_coco_polygon_masks_bit_for_bit():
    """PIL's polygon fill in both packages, on random polygons with
    fractional vertices, several polygons per instance and short ones
    (under 3 points, skipped)."""
    from pytracking_tpu.training.datasets.coco_seq import MSCOCOSeq
    from pytracking_tpu_torch.training.datasets.coco_seq import polygon_mask

    rng = np.random.RandomState(0)
    for k in range(40):
        polys = [list(rng.uniform(-5, 70, 2 * rng.randint(2, 9)).round(2))
                 for _ in range(rng.randint(1, 4))]
        a = {"segmentation": polys, "bbox": [3, 4, 10, 12]}
        ref = MSCOCOSeq._poly_mask(None, a, (48, 64, 3))
        _same(polygon_mask(a, (48, 64, 3)), ref, f"polygon {k}")


def test_lasot_vos_reads_mirrored_masks(specs):
    """LaSOT's pseudo-masks lie in a tree that mirrors the sequences'
    <class>/<class>-<id>/ folders (as GOT-10k's mirror its sequence
    folders). The port reads them there. The JAX LasotVOS builds the path
    from the class of the class folder's entry ('airplane/airplane'), looks
    in <mask_root>/airplane/airplane/airplane/airplane-1/ and finds no
    mask (ROADMAP §3): every one of its masks is empty. Everything else
    agrees."""
    from pytracking_tpu.training.datasets.vos_wrappers import make_lasot_vos as j_make
    from pytracking_tpu_torch.training.datasets.vos_wrappers import make_lasot_vos as t_make

    t = t_make(specs["lasot"], specs["lasot_masks"])
    j = j_make(specs["lasot"], specs["lasot_masks"])
    assert t.sequence_list == j.sequence_list and t.sequence_list[0] == "airplane/airplane-1"
    _, t_anno, _ = t.get_frames(0, [0, 1, 2])
    frames, j_anno, meta = j.get_frames(0, [0, 1, 2])
    _same(t.get_frames(0, [0, 1, 2])[0], frames)
    for k in ("bbox", "valid", "visible"):
        _same(t_anno[k], j_anno[k], k)
    assert all(m.sum() == 0 for m in j_anno["mask"])
    assert t_anno["mask"][0].sum() > 0 and t_anno["mask"][1].sum() > 0
    assert t_anno["mask"][2].sum() == 0                  # frame 3 has no pseudo-mask
    from pytracking_tpu_torch.utils.png_io import imread_indexed
    ref = imread_indexed(os.path.join(specs["lasot_masks"], "airplane", "airplane-1",
                                      "00000002.png")) > 0
    _same(t_anno["mask"][1], ref.astype(np.float32))


@pytest.mark.parametrize("case", ["lasot", "got10k", "trackingnet", "coco_seq", "coco_mot",
                                  "imagenet_vid", "taoburst_multi", "davis", "youtubevos",
                                  "lvis", "ecssd", "got10k_vos"])
def test_missing_root_raises_naming_it(tmp_path, case):
    module, name, _, kwargs = READERS[case]
    kwargs = {k: str(tmp_path / "masks") if k == "mask_root" else v for k, v in kwargs.items()}
    missing = str(tmp_path / "not_there")
    with pytest.raises(FileNotFoundError, match=missing):
        getattr(_readers(module)[0], name)(missing, **kwargs)


def test_missing_parts_raise(specs, tmp_path):
    """A root without its annotation file, TrackingNet without any of its
    sets, a mask tree that is not there, an ImagenetVIDMOT root without
    annotations: each raises naming the path."""
    from pytracking_tpu_torch.training.datasets import (coco_seq, mot_datasets, tao_burst,
                                                        tracking_net, vos_wrappers)

    empty = str(tmp_path)
    for make in (coco_seq.MSCOCOSeq, mot_datasets.MSCOCOMOTSeq, tao_burst.TAOBURST,
                 vos_wrappers.LVIS, mot_datasets.ImagenetVIDMOT):
        with pytest.raises(FileNotFoundError, match=empty):
            make(empty)
    with pytest.raises(FileNotFoundError, match="TRAIN_"):
        tracking_net.TrackingNet(specs["trackingnet"], set_ids=[2, 7])
    with pytest.raises(FileNotFoundError, match="masks"):
        vos_wrappers.make_lasot_vos(specs["lasot"], os.path.join(empty, "masks"))


@pytest.mark.parametrize("side", [0, 1], ids=["torch", "jax"])
def test_split_file_errors(trees, monkeypatch, tmp_path, side):
    """Both packages: an unknown split, a split with ids, and a split file
    that is nowhere raise alike."""
    got10k = _readers("got10k")[side].Got10k
    lasot = _readers("lasot")[side].Lasot
    monkeypatch.setenv("PYTRACKING_TPU_DATA_SPECS_PATH", str(tmp_path))
    with pytest.raises(ValueError, match="Unknown split"):
        got10k(trees["got10k"], split="test")
    with pytest.raises(ValueError, match="Cannot set both"):
        got10k(trees["got10k"], split="train", seq_ids=[0])
    with pytest.raises(ValueError, match="Unknown split"):
        lasot(trees["lasot"], split="test")
    with pytest.raises(ValueError, match="Cannot set both"):
        lasot(trees["lasot"], split="train", vid_ids=[1])
    with pytest.raises(FileNotFoundError, match="data_specs"):
        got10k(trees["got10k"], split="val")
    alone = tmp_path / "alone" / "LaSOT"              # no data_specs beside it either
    alone.mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="lasot_train_split"):
        lasot(str(alone), split="train")


def test_masks_to_bboxes_matches_jax():
    import jax.numpy as jnp

    from pytracking_tpu.ops.bbox import masks_to_bboxes as j_boxes
    from pytracking_tpu_torch.ops.bbox import masks_to_bboxes as t_boxes

    rng = np.random.RandomState(0)
    masks = (rng.rand(3, 5, 23, 31) > 0.97).astype(np.float32)
    masks[0, 0] = 0                                     # an empty one
    masks[1, 2] = 0
    masks[1, 2, 4:9, 7:20] = 1
    for fmt in ("c", "t", "v"):
        got = t_boxes(torch.from_numpy(masks), fmt).numpy()
        ref = np.asarray(j_boxes(jnp.asarray(masks), fmt))
        _same(got, ref, fmt)
    assert np.all(t_boxes(torch.zeros(7, 9), "t").numpy() == 0)
    _same(t_boxes(torch.zeros(7, 9)).numpy(), np.array([-0.5, -0.5, 0, 0], np.float32))
    _same(t_boxes(torch.from_numpy(masks[1, 2]), "t").numpy(),
          np.array([7, 4, 13, 5], np.float32))


# ------------------------------------------------ candidate matching

def _tcm_cases():
    """(mode, K, output_sz, seed): the two cases of
    tests/test_data_pipeline_round2.py's TCM tests, then KeepTrack's
    recipe's K = 8 at 288 with 1, 3, 8 and 11 candidates."""
    cases = [("self_sup", 5, 128, 0, 3), ("partial_sup", 5, 128, 3, 2)]
    for seed, n in ((11, 1), (12, 3), (13, 8), (14, 11)):
        cases += [("self_sup", 8, 288, seed, n), ("partial_sup", 8, 288, seed + 10, n)]
    return cases


def _tcm_data(mode, n, seed):
    rng = np.random.RandomState(seed)
    img = (rng.rand(240, 320, 3) * 255).astype(np.float32)
    if (mode, n) == ("self_sup", 3):                    # test_tcm_processing_self_sup's data
        coords, scores = np.array([[5, 7], [11, 11], [20, 3]]), np.array([0.9, 0.5, 0.3],
                                                                         np.float32)
    elif (mode, n) == ("partial_sup", 2):
        coords, scores = np.array([[5, 7], [11, 11]]), np.array([0.9, 0.5], np.float32)
    else:
        coords = rng.randint(0, 23, (n, 2))
        scores = rng.rand(n).astype(np.float32)
    sa = np.array([60.0 + seed, 40.0, 150.0 + 3 * seed, 150.0])
    if mode == "self_sup":
        return {"sup_mode": mode, "img": [img], "search_area_box": [sa],
                "target_candidate_coords": [coords], "target_candidate_scores": [scores]}
    coords1 = np.clip(coords + rng.randint(-1, 2, coords.shape), 0, 22)
    return {"sup_mode": mode, "img": [img, img[::-1].copy()], "search_area_box": [sa, sa + 4],
            "target_candidate_coords": [coords, coords1],
            "target_candidate_scores": [scores, scores[::-1].copy()],
            "target_anno_coord": [coords[0], coords1[min(1, n - 1)]]}


@pytest.mark.parametrize("mode,K,output_sz,seed,n", _tcm_cases())
def test_tcm_processing_matches_jax(mode, K, output_sz, seed, n):
    from pytracking_tpu.training.processing import TargetCandidateMatchingProcessing as J
    from pytracking_tpu_torch.training.processing import TargetCandidateMatchingProcessing as T

    kw = dict(output_sz=output_sz, num_target_candidates=K, score_map_sz=(23, 23))
    data = _tcm_data(mode, n, seed)
    np.random.seed(seed)
    ref = J(**kw)(data)
    after = np.random.rand()
    np_rng = np.random.RandomState(seed)
    got = T(**kw)(data, random.Random(seed), np_rng)
    _same(got, ref)
    assert np_rng.rand() == after                       # the same number of draws


class _StubTracker:
    """A tracker of fixed outputs from the decoded frame: its box the
    annotation moved by the frame's mean brightness; on even frames two
    candidates (the box's centre and a distractor) and a search area, on
    odd ones only the box."""

    def __init__(self, gt):
        self.gt, self.t = gt, 0

    def initialize(self, image, info):
        self.t = 0

    def track(self, image):
        self.t += 1
        shift = float(image.mean()) / 64.0
        b = [float(v) for v in self.gt[self.t]]
        box = [b[0] + shift, b[1] - shift, b[2], b[3]]
        out = {"target_bbox": box, "max_score": 0.7}
        if self.t % 2 == 0:
            cy, cx = box[1] + box[3] / 2, box[0] + box[2] / 2
            out["candidates"] = {"coords": [[cy, cx], [cy + 30.0, cx - 20.0]],
                                 "scores": [0.8, 0.3 if self.t % 4 == 0 else 0.1]}
            out["search_area_box"] = [cx - 40.0, cy - 40.0, 80.0, 80.0]
        return out


@pytest.fixture
def dumps(specs, tmp_path):
    """The candidate file of each package's extract_candidate_data over
    `lasot_train` (airplane-1, bird-1) with the stub tracker."""
    from pytracking_tpu.evaluation.datasets import get_dataset as j_get
    from pytracking_tpu.util_scripts import create_distractor_dataset as j_cdd
    from pytracking_tpu_torch.evaluation.datasets import get_dataset as t_get
    from pytracking_tpu_torch.util_scripts import create_distractor_dataset as t_cdd

    out = {}
    for side, get, cdd in (("torch", t_get, t_cdd), ("jax", j_get, j_cdd)):
        seqs = get("lasot_train")
        path = str(tmp_path / f"{side}.json")
        for seq in seqs:
            cdd.dump_seq_data_to_disk(path, seq.name,
                                      cdd.extract_candidate_data(_StubTracker(seq.ground_truth_rect),
                                                                 seq))
        out[side] = (seqs, path)
    return out


def test_extract_candidate_data_matches_jax(dumps):
    t_seqs, t_path = dumps["torch"]
    j_seqs, j_path = dumps["jax"]
    assert [s.name for s in t_seqs] == [s.name for s in j_seqs] == ["airplane-1", "bird-1"]
    got, ref = json.load(open(t_path)), json.load(open(j_path))
    assert got == ref and open(t_path).read() == open(j_path).read()
    states = {fd["state"] for seq in got.values() for fd in seq.values()}
    assert {"target_only", "target_with_distractors"} <= states
    assert len(got["airplane-1"]) == FRAMES - 1


def test_determine_frame_state_matches_jax():
    from pytracking_tpu.util_scripts.create_distractor_dataset import \
        determine_frame_state as j_state
    from pytracking_tpu_torch.util_scripts.create_distractor_dataset import (
        STATES, determine_frame_state)

    rng = np.random.RandomState(0)
    seen = set()
    for k in range(200):
        n = rng.randint(0, 5)
        cand = {"coords": (rng.rand(n, 2) * 60).tolist(), "scores": rng.rand(n).tolist()}
        gt = None if k % 37 == 0 else (rng.rand(4) * [40, 40, 30, 30] - (k % 23 == 0)).tolist()
        got = determine_frame_state(cand, gt)
        assert got == j_state(cand, gt) and got[0] in STATES
        seen.add(got[0])
    assert seen == set(STATES)


@pytest.mark.parametrize("route", ["direct", "processed"])
def test_candidate_matching_sampler_matches_jax(dumps, route):
    from pytracking_tpu.training.datasets import candidate_matching as j_cm
    from pytracking_tpu.training.processing import TargetCandidateMatchingProcessing as JP
    from pytracking_tpu_torch.training.datasets import candidate_matching as t_cm
    from pytracking_tpu_torch.training.processing import TargetCandidateMatchingProcessing as TP

    t_seqs, path = dumps["torch"]
    j_seqs, _ = dumps["jax"]
    t_ds, j_ds = t_cm.CandidateMatchingDataset(t_seqs, path), \
        j_cm.CandidateMatchingDataset(j_seqs, path)
    assert t_ds.sequence_list == j_ds.sequence_list
    assert t_ds.get_frame_states() == j_ds.get_frame_states()
    _same(t_ds.get_frame(1, 4), j_ds.get_frame(1, 4))
    kw = {"K": 8, "samples_per_epoch": 12}
    if route == "processed":
        t = t_cm.CandidateMatchingSampler(t_ds, processing=TP(output_sz=64,
                                                               num_target_candidates=8),
                                          seed=5, **kw)
        j = j_cm.CandidateMatchingSampler(j_ds, processing=JP(output_sz=64,
                                                               num_target_candidates=8), **kw)
        np.random.seed(5)
    else:
        t, j = t_cm.CandidateMatchingSampler(t_ds, **kw), j_cm.CandidateMatchingSampler(j_ds, **kw)
    assert t.usable == j.usable
    for i in range(len(j)):
        _same(t[i], j[i], f"item {i}")


def test_candidate_matching_sampler_without_usable_frame(dumps, tmp_path):
    from pytracking_tpu_torch.training.datasets.candidate_matching import (
        CandidateMatchingDataset, CandidateMatchingSampler)

    seqs, path = dumps["torch"]
    data = json.load(open(path))
    for seq in data.values():
        for fd in seq.values():
            fd["state"] = "target_lost"
    lost = tmp_path / "lost.json"
    lost.write_text(json.dumps(data))
    with pytest.raises(ValueError, match="no usable frame"):
        CandidateMatchingSampler(CandidateMatchingDataset(seqs, str(lost)))
    with pytest.raises(FileNotFoundError, match="missing.json"):
        CandidateMatchingDataset(seqs, str(tmp_path / "missing.json"))


# ------------------------------------------------ DiMP's mix

def _dimp_mix(side, trees):
    lasot, got10k, tn, coco = (_readers(k)[side] for k in
                               ("lasot", "got10k", "tracking_net", "coco_seq"))
    return [lasot.Lasot(trees["lasot"], split="train"), got10k.Got10k(trees["got10k"],
                                                                      split="vottrain"),
            tn.TrackingNet(trees["trackingnet"], set_ids=[0, 1, 2, 3]),
            coco.MSCOCOSeq(trees["coco"])]


def _dimp_processing(side):
    """dimp50's processing at a 64x64 crop."""
    if side == 0:
        from pytracking_tpu_torch.training import transforms as tfm
        from pytracking_tpu_torch.training.processing import DiMPProcessing
    else:
        from pytracking_tpu.training import transforms as tfm
        from pytracking_tpu.training.processing import DiMPProcessing
    return DiMPProcessing(
        search_area_factor=5.0, output_sz=64, center_jitter_factor={"train": 3, "test": 4.5},
        scale_jitter_factor={"train": 0.25, "test": 0.5},
        proposal_params={"min_iou": 0.1, "boxes_per_frame": 8, "proposal_sigma": 0.05},
        label_function_params={"feature_sz": 4, "sigma_factor": 0.05, "kernel_sz": 4},
        train_transform=tfm.Transform(tfm.BrightnessJitter(0.2), tfm.RandomHorizontalFlip(0.5)),
        joint_transform=tfm.Transform(tfm.ToGrayscale(probability=0.05)))


def test_dimp_mix_sampler_matches_jax(specs):
    """DiMP-50's four readers (upstream's dimp50 mix) through DiMPSampler
    and DiMPProcessing, 16 samples, bit for bit. The JAX sampler also
    passes a COCO sample's frame-sized masks on, uncropped (ROADMAP §3);
    the port's box samplers carry no masks, as upstream's."""
    from pytracking_tpu.training.sampler import DiMPSampler as J
    from pytracking_tpu_torch.training.sampler import DiMPSampler as T

    kw = dict(samples_per_epoch=16, max_gap=30, num_test_frames=3, num_train_frames=3)
    t = T(_dimp_mix(0, specs), processing=_dimp_processing(0), seed=6, **kw)
    j = J(_dimp_mix(1, specs), processing=_dimp_processing(1), **kw)
    random.seed(6)
    np.random.seed(6)
    seen = set()
    for i in range(len(j)):
        ref, got = j[i], t[i]
        seen.add(ref["dataset"])
        if ref["dataset"] == "coco":
            assert ref["train_masks"][0].shape == (SIZE[1], SIZE[0])
            ref = {k: v for k, v in ref.items() if not k.endswith("_masks")}
        _same(got, ref, f"sample {i}")
    assert seen == {"lasot", "got10k", "trackingnet", "coco"}


def test_dimp_mix_trains_one_step_on_the_cpu(specs, tmp_path, monkeypatch):
    """run_training('dimp', 'dimp50') on the written mix: one step of 2
    sequences at a 64x64 crop with the tiny DiMP net, on the CPU."""
    from pytracking_tpu_torch.run_training import run_training
    from pytracking_tpu_torch.training.settings import Settings

    from test_torch_training import _seeded_tiny_net

    monkeypatch.setenv("PYTRACKING_TPU_TORCH_WORKSPACE", str(tmp_path))
    settings = Settings(output_sz=64, feature_sz=4, batch_size=2, num_workers=2,
                        print_interval=1000)
    trainer = run_training("dimp", "dimp50", settings=settings, datasets=_dimp_mix(0, specs),
                           max_epochs=1, samples_per_epoch=2, net=_seeded_tiny_net(),
                           device="cpu")
    assert len(trainer.step_log) == 1 and np.isfinite(trainer.step_log[0]["loss"])
    assert trainer.restarts == 0


def test_lwl_mix_sampler_matches_jax(specs):
    """LWL's video datasets (YouTube-VOS and DAVIS, six objects) through
    LWLSampler and LWLProcessing at a 64x64 crop, 16 samples, masks
    included, bit for bit: the port keeps each sequence's info after its
    first reading, and the samples drawn from it again are still the JAX
    sampler's, which reads it anew. Flip probability 0: the port flips a
    flipped crop's mask, the JAX processing does not (the test of
    tests/test_torch_training_data.py)."""
    from pytracking_tpu.training import transforms as j_tfm
    from pytracking_tpu.training.processing import LWLProcessing as JP
    from pytracking_tpu.training.sampler import LWLSampler as J
    from pytracking_tpu_torch.training import transforms as t_tfm
    from pytracking_tpu_torch.training.processing import LWLProcessing as TP
    from pytracking_tpu_torch.training.sampler import LWLSampler as T

    def mix(side):
        vos = _readers("vos_base")[side]
        return [vos.YouTubeVOS(specs["youtubevos"]), vos.Davis(specs["davis"])]

    def processing(P, tfm):
        return P(search_area_factor=5.0, output_sz=64,
                 center_jitter_factor={"train": 3, "test": 5.5},
                 scale_jitter_factor={"train": 0.25, "test": 0.5},
                 train_transform=tfm.Transform(tfm.RandomHorizontalFlip(0.0)),
                 joint_transform=tfm.Transform(tfm.ToGrayscale(probability=0.05)))

    kw = dict(samples_per_epoch=16, max_gap=100, num_test_frames=3, num_train_frames=1)
    t = T(mix(0), processing=processing(TP, t_tfm), seed=2, **kw)
    j = J(mix(1), processing=processing(JP, j_tfm), **kw)
    random.seed(2)
    np.random.seed(2)
    for i in range(len(j)):
        _same(t[i], j[i], f"sample {i}")
    assert sum(len(d._infos) for d in t.datasets) == 6
