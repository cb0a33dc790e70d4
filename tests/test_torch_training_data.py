"""The port's host data pipeline for training against the JAX package's, on
the CPU: transforms, processing_utils, DiMPProcessing, KLDiMPProcessing
(PrDiMP's mixture proposals and label densities), ATOMProcessing,
DiMPSampler and ATOMSampler over the synthetic video dataset, the loader's
collation, and the loader's shapes (the twin of tests/test_training.py's
pipeline tests); later slices' ToMP, TaMOs, LWL, RTS and KYS processing
and samplers.

The JAX pipeline draws from the global `random` / `np.random`; the port's
from a `random.Random` and a `np.random.RandomState` passed down. Seeded
alike (`random.seed(s)`, `np.random.seed(s)` against `random.Random(s)`,
`np.random.RandomState(s)`), every output is equal bit for bit: the
tolerance is 0.
"""

import random

import numpy as np
import pytest

from pytracking_tpu_torch.training import processing_utils as t_pu
from pytracking_tpu_torch.training import transforms as t_tfm
from pytracking_tpu_torch.training.datasets.synthetic_video import \
    SyntheticVideoDataset as TSyntheticVideoDataset
from pytracking_tpu_torch.training.loader import LTRLoader as TLTRLoader
from pytracking_tpu_torch.training.loader import MultiEpochLTRLoader as TMultiEpochLTRLoader
from pytracking_tpu_torch.training.loader import _stack_dim1 as t_stack_dim1
from pytracking_tpu_torch.training.sampler import DiMPSampler as TDiMPSampler


def _gens(seed):
    """The JAX side's global generators and the port's own, seeded alike."""
    random.seed(seed)
    np.random.seed(seed)
    return {"rng": random.Random(seed), "np_rng": np.random.RandomState(seed)}


def _equal(a, b, path="out"):
    """Equal structure, types and bits."""
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in b:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (path, a, b)


def _images(seed, n=3, H=60, W=80):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, (H, W, 3)).astype(np.uint8) for _ in range(n)]


def _boxes(seed, n=3):
    rng = np.random.RandomState(seed)
    return [np.array([10 + rng.rand() * 20, 8 + rng.rand() * 20, 15 + rng.rand() * 10,
                      12 + rng.rand() * 10], np.float32) for _ in range(n)]


TRANSFORMS = {
    "gray": (lambda m: m.Transform(m.ToGrayscale(0.5)), True),
    "flip": (lambda m: m.Transform(m.RandomHorizontalFlip(0.5)), True),
    "brightness": (lambda m: m.Transform(m.BrightnessJitter(0.2)), False),
    "blur": (lambda m: m.Transform(m.Blur(0.7, (0.5, 1.5))), False),
    "normalize": (lambda m: m.Transform(m.Normalize()), False),
    "chain": (lambda m: m.Transform(m.ToGrayscale(0.3), m.BrightnessJitter(0.2),
                                    m.RandomHorizontalFlip(0.5)), True),
}


@pytest.mark.parametrize("joint", [True, False])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_jax(name, joint):
    from pytracking_tpu.training import transforms as j_tfm

    make, with_mask = TRANSFORMS[name]
    for seed in range(4):
        ims, boxes = _images(seed), _boxes(seed)
        kw = dict(image=list(ims), bbox=list(boxes), joint=joint)
        if with_mask:
            kw["mask"] = [(im[..., 0] > 128).astype(np.float32) for im in ims]
        gens = _gens(seed)
        ref = make(j_tfm)(**kw)
        got = make(t_tfm)(**kw, **gens)
        _equal(got, ref)
    # one element, not a list
    gens = _gens(9)
    _equal(make(t_tfm)(image=ims[0], bbox=boxes[0], **gens),
           make(j_tfm)(image=ims[0], bbox=boxes[0]))


def test_processing_utils_match_jax():
    from pytracking_tpu.training import processing_utils as j_pu

    ims, boxes = _images(1, H=90, W=120), _boxes(1)
    for im, bb in zip(ims, boxes):
        for out_sz in (None, 64):
            _equal(t_pu.sample_target(im, bb, 4.0, out_sz), j_pu.sample_target(im, bb, 4.0, out_sz))
        _equal(t_pu.sample_target_from_crop_region(im, [-5, 10, 70, 50], 32),
               j_pu.sample_target_from_crop_region(im, [-5, 10, 70, 50], 32))
    jittered = [b + np.float32(3) for b in boxes]
    _equal(t_pu.jittered_center_crop(ims, jittered, boxes, 5.0, 72),
           j_pu.jittered_center_crop(ims, jittered, boxes, 5.0, 72))
    props = np.random.RandomState(2).rand(7, 4).astype(np.float32) * 30 + 5
    _equal(t_pu.iou(boxes[0], props), j_pu.iou(boxes[0], props))
    for kw in (dict(sigma_factor=0.1, feat_sz=18, image_sz=288, kernel_sz=4),
               dict(sigma_factor=0.08, feat_sz=(9, 11), image_sz=(144, 176), kernel_sz=3,
                    end_pad_if_even=False, density=True, uni_bias=0.01)):
        bb = np.stack(boxes)
        _equal(t_pu.gaussian_label_function(bb, **kw), j_pu.gaussian_label_function(bb, **kw))
    for seed in range(6):
        sigma = (0.02, 0.05, 0.5) if seed % 2 else 0.05
        box = np.array([20.0, 30.0, 1.5 + 30 * (seed % 3), 25.0])
        gens = _gens(seed)
        ref = j_pu.perturb_box(box, min_iou=0.5, sigma_factor=sigma)
        got = t_pu.perturb_box(box, 0.5, sigma, **gens)
        _equal(got, ref)
        gens = _gens(seed)
        _equal(t_pu.gaussian_proposals(box, 8, sigma, **gens), j_pu.gaussian_proposals(box, 8, sigma))
        gens = _gens(seed)
        _equal(t_pu.rand_uniform(0.1, 0.5, gens["np_rng"], 3), j_pu.rand_uniform(0.1, 0.5, 3))


def _processing(module, tfm, output_sz=96):
    return module.DiMPProcessing(
        search_area_factor=5.0, output_sz=output_sz,
        center_jitter_factor={"train": 3, "test": 4.5},
        scale_jitter_factor={"train": 0.25, "test": 0.5},
        proposal_params={"min_iou": 0.1, "boxes_per_frame": 8, "proposal_sigma": 0.05},
        label_function_params={"feature_sz": output_sz // 16, "sigma_factor": 0.05,
                               "kernel_sz": 4},
        train_transform=tfm.Transform(tfm.BrightnessJitter(0.2), tfm.RandomHorizontalFlip(0.5)),
        joint_transform=tfm.Transform(tfm.ToGrayscale(0.3)))


def test_dimp_processing_matches_jax():
    from pytracking_tpu.training import processing as j_processing
    from pytracking_tpu.training import transforms as j_tfm
    from pytracking_tpu_torch.training import processing as t_processing

    ims, boxes = _images(3, n=5, H=120, W=160), _boxes(3, n=5)
    for seed in range(3):
        data = lambda: {"train_images": list(ims[:3]), "train_anno": list(boxes[:3]),
                        "test_images": list(ims[3:]), "test_anno": list(boxes[3:]),
                        "dataset": "d"}
        gens = _gens(seed)
        ref = _processing(j_processing, j_tfm)(data())
        got = _processing(t_processing, t_tfm)(data(), gens["rng"], gens["np_rng"])
        _equal(got, ref)


def _kl_processing(module, tfm, labels=True, output_sz=96, sigmas=((0.05, 0.05), (0.5, 0.5))):
    label_params = {"feature_sz": output_sz // 16, "sigma_factor": 0.05, "kernel_sz": 4}
    return module.KLDiMPProcessing(
        search_area_factor=5.0, output_sz=output_sz,
        center_jitter_factor={"train": 3, "test": 4.5},
        scale_jitter_factor={"train": 0.25, "test": 0.5},
        proposal_params={"boxes_per_frame": 16, "proposal_sigma": [tuple(s) for s in sigmas]},
        label_function_params=label_params if labels else None,
        train_transform=tfm.Transform(tfm.BrightnessJitter(0.2), tfm.RandomHorizontalFlip(0.5)),
        joint_transform=tfm.Transform(tfm.ToGrayscale(0.3)))


def _atom_processing(module, tfm, output_sz=96):
    return module.ATOMProcessing(
        search_area_factor=5.0, output_sz=output_sz,
        center_jitter_factor={"train": 0, "test": 4.5},
        scale_jitter_factor={"train": 0, "test": 0.5},
        proposal_params={"min_iou": 0.1, "boxes_per_frame": 16, "proposal_sigma": 0.05},
        train_transform=tfm.Transform(tfm.BrightnessJitter(0.2)),
        joint_transform=tfm.Transform(tfm.ToGrayscale(0.3)))


KL_CASES = {  # (label densities, mixture components)
    "prdimp": (True, ((0.05, 0.05), (0.5, 0.5))),
    "prob_ml": (False, ((0.05, 0.05), (0.5, 0.5))),
    "three_components": (True, ((0.02, 0.05), (0.1, 0.2), (0.5, 0.5))),
}


@pytest.mark.parametrize("case", sorted(KL_CASES))
def test_kldimp_processing_matches_jax(case):
    """KLDiMPProcessing against the JAX one under equal seeds, bit for bit:
    the crops, the mixture proposals (each draws its component, each but
    proposal 0 its offset, from the generator the sampler passes), their
    densities (proposal 0's the mixture's density at a zero offset), the
    ground-truth densities and the label densities."""
    from pytracking_tpu.training import processing as j_processing
    from pytracking_tpu.training import transforms as j_tfm
    from pytracking_tpu_torch.training import processing as t_processing

    labels, sigmas = KL_CASES[case]
    ims, boxes = _images(4, n=6, H=120, W=160), _boxes(4, n=6)
    for seed in range(3):
        data = lambda: {"train_images": list(ims[:3]), "train_anno": list(boxes[:3]),
                        "test_images": list(ims[3:]), "test_anno": list(boxes[3:]),
                        "dataset": "d"}
        gens = _gens(seed)
        ref = _kl_processing(j_processing, j_tfm, labels, sigmas=sigmas)(data())
        got = _kl_processing(t_processing, t_tfm, labels, sigmas=sigmas)(
            data(), gens["rng"], gens["np_rng"])
        _equal(got, ref)
        assert ("test_label_density" in got) == labels and "proposal_iou" not in got
        dens = got["proposal_density"][0]
        assert dens.shape == (16,) and dens[0] == dens.max() > 0
        assert np.array_equal(got["test_proposals"][0][0], got["test_anno"][0]) or \
            np.abs(got["test_proposals"][0][0] - got["test_anno"][0]).max() < 1e-4
        assert got["gt_density"][0].tolist() == [1.0] + [0.0] * 15
        # the draws went on where the processing left them
        assert gens["np_rng"].randint(1 << 30) == np.random.randint(1 << 30)


def test_atom_processing_matches_jax():
    """ATOMProcessing (DiMP's without labels) against the JAX one, bit for
    bit, at atom_paper's jitter (none on the train frame)."""
    from pytracking_tpu.training import processing as j_processing
    from pytracking_tpu.training import transforms as j_tfm
    from pytracking_tpu_torch.training import processing as t_processing

    ims, boxes = _images(5, n=2, H=120, W=160), _boxes(5, n=2)
    for seed in range(3):
        data = lambda: {"train_images": [ims[0]], "train_anno": [boxes[0]],
                        "test_images": [ims[1]], "test_anno": [boxes[1]], "dataset": "d"}
        gens = _gens(seed)
        ref = _atom_processing(j_processing, j_tfm)(data())
        got = _atom_processing(t_processing, t_tfm)(data(), gens["rng"], gens["np_rng"])
        _equal(got, ref)
        assert "test_label" not in got and got["test_proposals"][0].shape == (16, 4)


@pytest.mark.parametrize("kind", ["atom", "prob_ml"])
def test_atom_sampler_matches_jax(kind):
    """ATOMSampler[i] (one train and one test frame, 'interval' sampling
    within max_gap) with ATOM's and the prob-ML recipe's processing, one
    seed for the run."""
    from pytracking_tpu.training import processing as j_processing
    from pytracking_tpu.training import transforms as j_tfm
    from pytracking_tpu.training.datasets.synthetic_video import SyntheticVideoDataset
    from pytracking_tpu.training.sampler import ATOMSampler
    from pytracking_tpu_torch.training import processing as t_processing
    from pytracking_tpu_torch.training.sampler import ATOMSampler as TATOMSampler

    make = _atom_processing if kind == "atom" else \
        (lambda m, tfm: _kl_processing(m, tfm, labels=False))
    j = ATOMSampler([SyntheticVideoDataset(num_sequences=6, seq_len=30)], samples_per_epoch=6,
                    max_gap=50, processing=make(j_processing, j_tfm))
    t = TATOMSampler([TSyntheticVideoDataset(num_sequences=6, seq_len=30)], samples_per_epoch=6,
                     max_gap=50, processing=make(t_processing, t_tfm), seed=7)
    assert (t.num_train_frames, t.num_test_frames, t.frame_sample_mode) == (1, 1, "interval")
    random.seed(7)
    np.random.seed(7)
    for i in range(4):
        _equal(t[i], j[i])


def _samplers(seed, samples=6):
    from pytracking_tpu.training import processing as j_processing
    from pytracking_tpu.training import transforms as j_tfm
    from pytracking_tpu.training.datasets.synthetic_video import SyntheticVideoDataset
    from pytracking_tpu.training.sampler import DiMPSampler
    from pytracking_tpu_torch.training import processing as t_processing

    j = DiMPSampler([SyntheticVideoDataset(num_sequences=6, seq_len=30)], samples_per_epoch=samples,
                    max_gap=10, num_test_frames=2, num_train_frames=2,
                    processing=_processing(j_processing, j_tfm))
    t = TDiMPSampler([TSyntheticVideoDataset(num_sequences=6, seq_len=30)],
                     samples_per_epoch=samples, max_gap=10, num_test_frames=2, num_train_frames=2,
                     processing=_processing(t_processing, t_tfm), seed=seed)
    random.seed(seed)
    np.random.seed(seed)
    return j, t


@pytest.mark.parametrize("mode", ["causal", "interval"])
def test_dimp_sampler_matches_jax(mode):
    """DiMPSampler[i] for i = 0..3, one seed for the run: the JAX sampler
    after random.seed / np.random.seed, the port's sampler with seed=."""
    j, t = _samplers(11)
    j.frame_sample_mode = t.frame_sample_mode = mode
    for i in range(4):
        _equal(t[i], j[i])
    t.seed(5)
    random.seed(5)
    np.random.seed(5)
    _equal(t[0], j[0])


def test_synthetic_dataset_matches_jax():
    from pytracking_tpu.training.datasets.synthetic_video import SyntheticVideoDataset

    j, t = SyntheticVideoDataset(num_sequences=3, seq_len=12), \
        TSyntheticVideoDataset(num_sequences=3, seq_len=12)
    assert len(t) == len(j) == 3 and t.get_name() == j.get_name()
    for seq in range(3):
        _equal(t.get_sequence_info(seq), j.get_sequence_info(seq))
        _equal(t.get_frames(seq, [0, 5, 11]), j.get_frames(seq, [0, 5, 11]))


def test_stack_dim1_matches_jax():
    from pytracking_tpu.training.loader import _stack_dim1

    j, t = _samplers(3, samples=4)
    samples = [t[i] for i in range(3)]
    for stack_dim in (1, 0):
        _equal(t_stack_dim1(samples, stack_dim), _stack_dim1(samples, stack_dim))
    extra = [dict(s, scalar=np.float32(i), vec=np.arange(3) + i) for i, s in enumerate(samples)]
    _equal(t_stack_dim1(extra), _stack_dim1(extra))


# ---- the twins of tests/test_training.py's pipeline tests

def test_sample_target_geometry():
    im = np.zeros((100, 120, 3), np.uint8)
    im[40:60, 50:70] = 255
    crop, rf = t_pu.sample_target(im, [50, 40, 20, 20], 5.0, 100)
    assert crop.shape == (100, 100, 3)
    assert crop[40:60, 40:60].mean() > 200
    assert crop[:10, :10].mean() < 50


def test_gaussian_label_function_peak():
    bb = np.array([[134.0, 134.0, 20.0, 20.0]])
    label = t_pu.gaussian_label_function(bb, 0.25 / 5.0, 4, 18, 288)
    assert label.shape == (1, 19, 19)
    assert np.unravel_index(label[0].argmax(), label[0].shape) == (9, 9)
    assert abs(label[0].max() - 1.0) < 1e-4


def test_perturb_box_iou_bound():
    box = np.array([50.0, 50.0, 30.0, 30.0])
    gens = _gens(0)
    for _ in range(10):
        _, iou = t_pu.perturb_box(box, 0.5, 0.1, **gens)
        assert iou > 0.4


@pytest.mark.parametrize("num_workers", [1, 2])
def test_processing_sampler_and_loader_shapes(num_workers):
    from pytracking_tpu_torch.training import processing as t_processing

    ds = TSyntheticVideoDataset(num_sequences=4, seq_len=30)
    sampler = TDiMPSampler([ds], samples_per_epoch=8, max_gap=10, num_test_frames=2,
                           num_train_frames=2, processing=_processing(t_processing, t_tfm),
                           seed=0)
    data = sampler[0]
    assert len(data["train_images"]) == 2
    assert data["train_images"][0].shape == (96, 96, 3)
    assert data["test_proposals"][0].shape == (8, 4)
    assert data["test_label"][0].shape == (7, 7)

    loader = TLTRLoader("train", sampler, batch_size=4, num_workers=num_workers)
    batches = list(loader)
    assert len(batches) == len(loader) == 2
    batch = batches[0]
    assert batch["train_images"].shape == (2, 4, 96, 96, 3)
    assert batch["train_anno"].shape == (2, 4, 4)
    assert batch["test_proposals"].shape == (2, 4, 8, 4)
    assert batch["proposal_iou"].shape == (2, 4, 8)
    assert batch["test_label"].shape == (2, 4, 7, 7)
    assert batch["dataset"] == ["synthetic_video"] * 4

    multi = TMultiEpochLTRLoader("train", sampler, batch_size=4, num_workers=num_workers)
    for _ in range(2):                   # two epochs from one producer
        assert [b["train_images"].shape for b in multi] == [(2, 4, 96, 96, 3)] * 2
    multi.close()


def test_loader_raises_a_worker_failure():
    """A sample that fails raises in the consumer, not a short epoch."""
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise ValueError("bad sample")

    with pytest.raises(ValueError, match="bad sample"):
        list(TLTRLoader("train", Broken(), batch_size=2, num_workers=2))


# ---- ToMP and TaMOs

def _tomp_processing(module, tfm, output_sz=96):
    return module.ToMPProcessing(
        search_area_factor=5.0, output_sz=output_sz,
        center_jitter_factor={"train": 3, "test": 4.5},
        scale_jitter_factor={"train": 0.25, "test": 0.5},
        label_function_params={"feature_sz": output_sz // 16, "sigma_factor": 0.05,
                               "kernel_sz": 1, "stride": 16},
        train_transform=tfm.Transform(tfm.BrightnessJitter(0.2), tfm.RandomHorizontalFlip(0.5)),
        joint_transform=tfm.Transform(tfm.ToGrayscale(0.3)))


def test_tomp_processing_matches_jax():
    """ToMPProcessing: DiMP's crops and labels plus the dense LTRB maps of
    every train and test frame, bit for bit on the same draws."""
    from pytracking_tpu.training import processing as j_processing
    from pytracking_tpu.training import transforms as j_tfm
    from pytracking_tpu_torch.training import processing as t_processing

    ims, boxes = _images(4, n=3, H=120, W=160), _boxes(4, n=3)
    for seed in range(3):
        data = lambda: {"train_images": list(ims[:2]), "train_anno": list(boxes[:2]),
                        "test_images": list(ims[2:]), "test_anno": list(boxes[2:]),
                        "dataset": "d"}
        gens = _gens(seed)
        ref = _tomp_processing(j_processing, j_tfm)(data())
        got = _tomp_processing(t_processing, t_tfm)(data(), gens["rng"], gens["np_rng"])
        assert got["train_ltrb_target"][0].shape == (6, 6, 4)
        _equal(got, ref)
    box = np.array([20.5, 30.0, 17.0, 9.0], np.float32)
    _equal(t_processing._encode_ltrb(box, 96, 16), j_processing._encode_ltrb(box, 96, 16))


class _MOTDataset:
    """Two sequences of 40 frames with 2 or 4 objects as {obj_id: box}
    dicts, visibility per (frame, object), object 1 invisible in frames
    0-9; ids 0, 1, 3, 5 (5 lies beyond 3 slots, 3 beyond 2)."""

    def __len__(self):
        return 2

    def get_name(self):
        return "mot"

    def is_video_sequence(self):
        return True

    def is_mot_dataset(self):
        return True

    def get_num_sequences(self):
        return 2

    def get_sequence_info(self, seq_id):
        ids = (0, 1) if seq_id == 0 else (0, 1, 3, 5)
        boxes = [{k: np.array([20.0 + 25 * i + t, 18.0 + 9 * i, 20 + 2 * i, 16 + i], np.float32)
                  for i, k in enumerate(ids)} for t in range(40)]
        visible = np.ones((40, len(ids)), bool)
        visible[:10, 1] = False
        return {"visible": visible, "bbox": boxes}

    def get_frames(self, seq_id, ids, info):
        frames = [np.full((120, 160, 3), 60 + 5 * i, np.uint8) for i in ids]
        for f, i in zip(frames, ids):
            for k, b in info["bbox"][i].items():
                x, y, w, h = [int(v) for v in b]
                f[y:y + h, x:x + w] = 100 + 30 * k
        return frames, {"bbox": [info["bbox"][i] for i in ids]}, None


class _SingleObjectImages:
    """An image dataset of bare (x, y, w, h) boxes: {0: box} per frame."""

    def __len__(self):
        return 3

    def get_name(self):
        return "images"

    def is_video_sequence(self):
        return False

    def get_num_sequences(self):
        return 3

    def get_sequence_info(self, seq_id):
        return {"bbox": [np.array([30.0 + seq_id, 25.0, 24.0, 20.0], np.float32)]}

    def get_frames(self, seq_id, ids, info):
        frames = [np.full((100, 140, 3), 90 + seq_id, np.uint8) for _ in ids]
        return frames, {"bbox": [info["bbox"][i] for i in ids]}, None


def _tamos_processing(module, tfm, K=3, output_sz=128):
    return module.TaMOsProcessing(
        search_area_factor=5.0, output_sz=output_sz,
        center_jitter_factor={"train": 3, "test": 4.5},
        scale_jitter_factor={"train": 0.25, "test": 0.5},
        label_function_params={"feature_sz": output_sz // 16, "sigma_factor": 0.05,
                               "kernel_sz": 1, "stride": 16},
        num_objects=K, stride_high=8,
        train_transform=tfm.Transform(tfm.BrightnessJitter(0.2), tfm.RandomHorizontalFlip(0.5)),
        joint_transform=tfm.Transform(tfm.ToGrayscale(0.3)))


@pytest.mark.parametrize("K", [2, 3])
def test_tamos_processing_matches_jax(K):
    """TaMOsProcessing on {obj_id: box} frames (ids beyond the K slots
    dropped) and on bare boxes: the crops around each frame's jittered
    lowest id, the crop-coordinate dicts, the slot-first train labels and
    LTRB maps, the slot-last test labels, LTRB maps and sample regions at
    stride 8, bit for bit on the same draws."""
    from pytracking_tpu.training import processing as j_processing
    from pytracking_tpu.training import transforms as j_tfm
    from pytracking_tpu_torch.training import processing as t_processing

    ds = _MOTDataset()
    info = ds.get_sequence_info(1)
    frames, anno, _ = ds.get_frames(1, [12, 30], info)
    for seed in range(2):
        data = lambda: {"train_images": frames[:1], "train_anno": anno["bbox"][:1],
                        "test_images": frames[1:], "test_anno": [anno["bbox"][1]],
                        "dataset": "mot"}
        gens = _gens(seed)
        ref = _tamos_processing(j_processing, j_tfm, K)(data())
        got = _tamos_processing(t_processing, t_tfm, K)(data(), gens["rng"], gens["np_rng"])
        assert got["train_label"][0].shape == (K, 8, 8)
        assert got["test_sample_region"][0].shape == (16, 16, K)
        assert got["train_label"][0][1].max() > 0.01     # object 1 reached its slot
        _equal(got, ref)
    bare = {"train_images": frames[:1], "train_anno": [np.array([30.0, 20, 22, 18])],
            "test_images": frames[1:], "test_anno": [np.array([34.0, 22, 22, 18])]}
    gens = _gens(9)
    ref = _tamos_processing(j_processing, j_tfm, K)(dict(bare))
    got = _tamos_processing(t_processing, t_tfm, K)(dict(bare), gens["rng"], gens["np_rng"])
    _equal(got, ref)
    assert not got["test_label"][0][..., 1:].any()


def test_tamos_sampler_matches_jax():
    """TaMOsDatasetSampler over a multi-object video dataset (visibility
    per frame and object) and a single-object image dataset, both with the
    TaMOs processing: samples 0-5 bit for bit on one seed, 'is_mot' and the
    {obj_id: box} dicts included; then the loader's collation of the
    dict-valued annotations and the flag as the JAX _stack_dim1 gives it,
    and the upload leaving them on the host. The twin of
    tests/test_data_pipeline_round2.py's TaMOs test."""
    from pytracking_tpu.training import processing as j_processing
    from pytracking_tpu.training import transforms as j_tfm
    from pytracking_tpu.training.loader import _stack_dim1
    from pytracking_tpu.training.sampler import TaMOsDatasetSampler as JSampler
    from pytracking_tpu_torch.training import processing as t_processing
    from pytracking_tpu_torch.training.sampler import TaMOsDatasetSampler as TSampler
    from pytracking_tpu_torch.training.trainer import batch_to_device

    datasets = [_MOTDataset(), _SingleObjectImages()]
    j = JSampler(datasets, p_datasets=[2, 1], samples_per_epoch=6, max_gap=10,
                 num_test_frames=1, num_train_frames=1,
                 processing=_tamos_processing(j_processing, j_tfm))
    t = TSampler(datasets, p_datasets=[2, 1], samples_per_epoch=6, max_gap=10,
                 num_test_frames=1, num_train_frames=1,
                 processing=_tamos_processing(t_processing, t_tfm), seed=21)
    random.seed(21)
    np.random.seed(21)
    jt = [j[i] for i in range(6)]
    tt = [t[i] for i in range(6)]
    for a, b in zip(tt, jt):
        _equal(a, b)
    assert {s["dataset"] for s in tt} == {"mot", "images"}
    assert any(s["is_mot"] for s in tt) and not all(s["is_mot"] for s in tt)
    got, ref = t_stack_dim1(tt[:3]), _stack_dim1(jt[:3])
    assert sorted(got) == sorted(ref)
    for k in ref:
        if isinstance(ref[k], np.ndarray) and ref[k].dtype == object:
            assert got[k].shape == ref[k].shape
            for x, y in zip(got[k].ravel(), ref[k].ravel()):
                _equal(x, y)
        else:
            _equal(got[k], ref[k])
    assert got["train_anno"].dtype == object and got["is_mot"].dtype == bool
    up = batch_to_device(got, "cpu")
    assert "train_anno" not in up and "test_anno" not in up and "dataset" not in up
    assert up["test_label"].shape == (1, 3, 16, 16, 3) and up["train_images"].shape[2] == 3


# ---------------------------------------------------------------- LWL and RTS

def test_synthetic_vos_dataset_matches_jax():
    """SyntheticVOSVideoDataset: the sequence info, and each frame's image
    and mask (the rendered square), bit for bit."""
    from pytracking_tpu.training.datasets.synthetic_video import SyntheticVOSVideoDataset
    from pytracking_tpu_torch.training.datasets.synthetic_video import \
        SyntheticVOSVideoDataset as TSyntheticVOSVideoDataset

    j, t = SyntheticVOSVideoDataset(num_sequences=3, seq_len=12), \
        TSyntheticVOSVideoDataset(num_sequences=3, seq_len=12)
    assert t.has_segmentation_info() and j.has_segmentation_info()
    for seq in range(3):
        _equal(t.get_sequence_info(seq), j.get_sequence_info(seq))
        got, ref = t.get_frames(seq, [0, 5, 11]), j.get_frames(seq, [0, 5, 11])
        _equal(got, ref)
        assert all(m.any() and m.dtype == np.float32 for m in got[1]["mask"])


def _lwl_processing(module, tfm, flip=0.5, labels=False, output_sz=96):
    label_params = {"feature_sz": output_sz // 32, "sigma_factor": 0.05, "kernel_sz": 4} \
        if labels else None
    cls = module.RTSProcessing if labels else module.LWLProcessing
    return cls(search_area_factor=5.0, output_sz=output_sz,
               center_jitter_factor={"train": 3, "test": 4.5},
               scale_jitter_factor={"train": 0.25, "test": 0.5},
               label_function_params=label_params,
               train_transform=tfm.Transform(tfm.RandomHorizontalFlip(flip)),
               joint_transform=tfm.Transform(tfm.ToGrayscale(0.3)))


def _masks(boxes, H, W):
    out = []
    for b in boxes:
        m = np.zeros((H, W), np.float32)
        x, y, w, h = [int(round(float(v))) for v in b]
        m[y:y + h, x:x + w] = 1.0
        out.append(m)
    return out


@pytest.mark.parametrize("labels", [False, True])
def test_lwl_processing_matches_jax(labels):
    """LWLProcessing (and RTSProcessing, with the classifier's labels) at
    flip probability 0, where the two packages must agree: crops, masks,
    boxes and labels bit for bit, over three seeds."""
    from pytracking_tpu.training import processing as j_processing
    from pytracking_tpu.training import transforms as j_tfm
    from pytracking_tpu_torch.training import processing as t_processing

    ims, boxes = _images(5, n=4, H=120, W=160), _boxes(5, n=4)
    masks = _masks(boxes, 120, 160)
    for seed in range(3):
        data = lambda: {"train_images": list(ims[:1]), "train_anno": list(boxes[:1]),
                        "train_masks": list(masks[:1]), "test_images": list(ims[1:]),
                        "test_anno": list(boxes[1:]), "test_masks": list(masks[1:]),
                        "dataset": "d"}
        gens = _gens(seed)
        ref = _lwl_processing(j_processing, j_tfm, 0.0, labels)(data())
        got = _lwl_processing(t_processing, t_tfm, 0.0, labels)(data(), gens["rng"],
                                                               gens["np_rng"])
        _equal(got, ref)
        assert all(m.any() for m in got["test_masks"])
        assert ("test_label" in got) == labels
        if labels:
            assert got["test_label"][0].shape == (4, 4)


def test_flipped_mask_follows_its_box():
    """At flip probability 1 the port flips each crop's mask with its image
    and box, as upstream's LWLProcessing does: the mask's centroid stays
    within 2 px of the box's centre in x. The target is a 30 px square in
    the middle of a 400x400 image, so every crop lies inside the image. The JAX package's processing flips the image and
    box but not the mask: its masks stay where the unflipped target was,
    up to twice the jitter's offset away. Frames whose mask the jitter
    pushed against the crop's edge are left out."""
    from pytracking_tpu.training import processing as j_processing
    from pytracking_tpu.training import transforms as j_tfm
    from pytracking_tpu_torch.training import processing as t_processing

    rng = np.random.RandomState(2)
    ims = [rng.randint(0, 255, (400, 400, 3)).astype(np.uint8) for _ in range(4)]
    boxes = [np.array([185.0 + i, 186.0 - i, 30.0, 30.0], np.float32) for i in range(4)]
    masks = _masks(boxes, 400, 400)

    def centre_dx(out):
        """Per frame, |mask centroid - box centre| in x, NaN where the
        jitter put the mask against the crop's edge (clipped)."""
        dx = []
        for m, b in zip(out["train_masks"] + out["test_masks"],
                        out["train_anno"] + out["test_anno"]):
            cols = m.sum(axis=0)
            xs = np.nonzero(cols)[0]
            clipped = not xs.size or xs[0] == 0 or xs[-1] == m.shape[1] - 1
            centroid = (cols * np.arange(m.shape[1])).sum() / max(cols.sum(), 1.0)
            dx.append(np.nan if clipped else abs(centroid + 0.5 - (b[0] + b[2] / 2)))
        return np.asarray(dx)

    got_dx, ref_dx = [], []
    for seed in range(4):
        data = lambda: {"train_images": list(ims[:1]), "train_anno": list(boxes[:1]),
                        "train_masks": list(masks[:1]), "test_images": list(ims[1:]),
                        "test_anno": list(boxes[1:]), "test_masks": list(masks[1:]),
                        "dataset": "d"}
        gens = _gens(seed)
        ref_dx.append(centre_dx(_lwl_processing(j_processing, j_tfm, 1.0)(data())))
        got_dx.append(centre_dx(_lwl_processing(t_processing, t_tfm, 1.0)(
            data(), gens["rng"], gens["np_rng"])))
    got_dx, ref_dx = np.concatenate(got_dx), np.concatenate(ref_dx)
    assert np.isfinite(got_dx).sum() >= 12 and np.isfinite(ref_dx).sum() >= 12
    assert np.nanmax(got_dx) <= 2.0, got_dx
    assert np.nanmax(ref_dx) > 8.0, ref_dx


def test_lwl_sampler_matches_jax():
    """LWLSampler over SyntheticVOSVideoDataset with LWLProcessing (flip
    probability 0): the samples, masks included, bit for bit from the same
    seeds, and their collation."""
    from pytracking_tpu.training import processing as j_processing
    from pytracking_tpu.training import transforms as j_tfm
    from pytracking_tpu.training.datasets.synthetic_video import SyntheticVOSVideoDataset
    from pytracking_tpu.training.loader import _stack_dim1 as j_stack_dim1
    from pytracking_tpu.training.sampler import LWLSampler
    from pytracking_tpu_torch.training import processing as t_processing
    from pytracking_tpu_torch.training.datasets.synthetic_video import \
        SyntheticVOSVideoDataset as TSyntheticVOSVideoDataset
    from pytracking_tpu_torch.training.sampler import LWLSampler as TLWLSampler

    kw = dict(samples_per_epoch=4, max_gap=20, num_test_frames=3, num_train_frames=1)
    j = LWLSampler([SyntheticVOSVideoDataset(num_sequences=6, seq_len=30)],
                   processing=_lwl_processing(j_processing, j_tfm, 0.0), **kw)
    t = TLWLSampler([TSyntheticVOSVideoDataset(num_sequences=6, seq_len=30)],
                    processing=_lwl_processing(t_processing, t_tfm, 0.0), seed=9, **kw)
    random.seed(9)
    np.random.seed(9)
    got, ref = [t[i] for i in range(4)], [j[i] for i in range(4)]
    for a, b in zip(got, ref):
        _equal(a, b)
        assert len(a["train_masks"]) == 1 and len(a["test_masks"]) == 3
    _equal(t_stack_dim1(got), j_stack_dim1(ref))
    assert t_stack_dim1(got)["test_masks"].shape == (3, 4, 96, 96)


# ---------------------------------------------------------------- KYS

def _kys_processing(module, tfm, end_pad=True, proposals=True, output_sz=128):
    label_params = {"feature_sz": 8, "sigma_factor": 0.05, "kernel_sz": 4}
    if not end_pad:
        label_params["end_pad_if_even"] = False
    return module.KYSProcessing(
        search_area_factor=5.0, output_sz=output_sz,
        center_jitter_param={"train_factor": 3.0, "train_mode": "uniform", "test_factor": 4.5,
                             "test_limit_motion": True, "test_mode": "uniform"},
        scale_jitter_param={"train_factor": 0.25, "test_factor": 0.3},
        proposal_params={"boxes_per_frame": 8, "min_iou": 0.3,
                         "sigma_factor": [0.01, 0.05, 0.1, 0.2, 0.3]} if proposals else None,
        label_function_params=label_params, min_crop_inside_ratio=0.1,
        train_transform=tfm.Transform(tfm.BrightnessJitter(0.2)),
        joint_transform=tfm.Transform(tfm.ToGrayscale(probability=0.3)))


@pytest.mark.parametrize("end_pad", [True, False])
def test_kys_processing_matches_jax(end_pad):
    """KYSProcessing on tests/test_data_pipeline_round2.py's case (two
    frames of the test sequence absent, a target near the image's corner
    so that the crop-inside retries and the motion limit act), with the
    labels end-padded (9x9 on the 8x8 grid) or not (8x8): crops, boxes,
    proposals and labels bit for bit over three seeds, the absent frames'
    labels zero."""
    from pytracking_tpu.training import processing as j_processing
    from pytracking_tpu.training import transforms as j_tfm
    from pytracking_tpu_torch.training import processing as t_processing

    ims = _images(7, n=7, H=120, W=160)
    visible = np.array([1, 1, 0, 0, 1], np.float32)
    for seed in range(3):
        data = lambda: {"train_images": list(ims[:2]),
                        "train_anno": [np.array([40.0, 30.0, 30.0, 24.0])] * 2,
                        "test_images": list(ims[2:]),
                        "test_anno": [np.array([4.0 + 3 * i, 2.0, 30.0, 24.0])
                                      for i in range(5)],
                        "test_visible": visible.copy(),
                        "test_valid_anno": np.ones(5, np.float32), "dataset": "d"}
        gens = _gens(seed)
        ref = _kys_processing(j_processing, j_tfm, end_pad, proposals=seed != 2)(data())
        got = _kys_processing(t_processing, t_tfm, end_pad, proposals=seed != 2)(
            data(), gens["rng"], gens["np_rng"])
        _equal(got, ref)
        assert got["test_label"][0].shape == ((9, 9) if end_pad else (8, 8))
        assert got["test_label"][2].max() == 0.0 and got["test_label"][3].max() == 0.0
        assert got["test_label"][0].max() > 0.1
        assert ("test_proposals" in got) == (seed != 2)


class _OccDataset:
    """tests/test_data_pipeline_round2.py's: 20 visible, 10 occluded, 30
    visible frames."""

    def get_name(self):
        return "occ"

    def is_video_sequence(self):
        return True

    def has_occlusion_info(self):
        return True

    def get_num_sequences(self):
        return 1

    def get_sequence_info(self, seq_id):
        vis = np.ones(60)
        ratio = np.ones(60)
        ratio[20:30] = 0.2
        vis[20:30] = 0
        return {"visible": vis, "visible_ratio": ratio,
                "bbox": [np.array([30.0, 30, 20, 20])] * 60}

    def get_frames(self, seq_id, ids, info):
        frames = [np.full((64, 64, 3), 100 + i, np.float32) for i in ids]
        anno = {"bbox": [np.array([30.0, 30, 20, 20]) for _ in ids],
                "visible": np.array([info["visible"][i] for i in ids]),
                "valid": np.ones(len(ids)),
                "visible_ratio": np.array([info["visible_ratio"][i] for i in ids])}
        return frames, anno, None


@pytest.mark.parametrize("case", ["occlusion", "synthetic"])
def test_kys_sampler_matches_jax(case):
    """KYSSampler bit for bit from the same seeds, and the collation: on
    tests/test_data_pipeline_round2.py's occlusion dataset without
    processing (the sub-sequences span the occlusion: visible and occluded
    test frames, the occluded ones' labels zero once processed), and on the
    synthetic videos with KYSProcessing (sequences of 20 frames, so that
    some test frames run past the end: padded with frame 0 and marked in
    test_valid_image)."""
    from pytracking_tpu.training import processing as j_processing
    from pytracking_tpu.training import transforms as j_tfm
    from pytracking_tpu.training.datasets.synthetic_video import SyntheticVideoDataset
    from pytracking_tpu.training.loader import _stack_dim1 as j_stack_dim1
    from pytracking_tpu.training.sampler import KYSSampler
    from pytracking_tpu_torch.training import processing as t_processing
    from pytracking_tpu_torch.training.sampler import KYSSampler as TKYSSampler

    info = {"num_train_frames": 2, "num_test_frames": 8, "max_train_gap": 30,
            "allow_missing_target": True, "min_fraction_valid_frames": 0.5, "mode": "Sequence"}
    if case == "occlusion":
        j_data, t_data, j_proc, t_proc = [_OccDataset()], [_OccDataset()], None, None
    else:
        j_data = [SyntheticVideoDataset(num_sequences=4, seq_len=20, H=120, W=160)]
        t_data = [TSyntheticVideoDataset(num_sequences=4, seq_len=20, H=120, W=160)]
        j_proc = _kys_processing(j_processing, j_tfm, end_pad=False, proposals=False,
                                 output_sz=64)
        t_proc = _kys_processing(t_processing, t_tfm, end_pad=False, proposals=False,
                                 output_sz=64)
    j = KYSSampler(j_data, samples_per_epoch=6, sequence_sample_info=info, processing=j_proc,
                   sample_occluded_sequences=True)
    t = TKYSSampler(t_data, samples_per_epoch=6, sequence_sample_info=info, processing=t_proc,
                    sample_occluded_sequences=True, seed=4)
    random.seed(4)
    np.random.seed(4)
    ref, got = [j[i] for i in range(6)], [t[i] for i in range(6)]
    for a, b in zip(got, ref):
        _equal(a, b)
        assert len(a["test_images"]) == 8 and a["test_valid_image"].shape == (8,)
    if case == "occlusion":
        assert any((a["test_visible"] == 0).any() and (a["test_visible"] == 1).any()
                   for a in got)
    else:
        assert any((a["test_valid_image"] == 0).any() for a in got)
        assert got[0]["test_label"][0].shape == (8, 8)
    _equal(t_stack_dim1(got), j_stack_dim1(ref))
    assert t_stack_dim1(got)["test_valid_image"].shape == (1, 6, 8)
