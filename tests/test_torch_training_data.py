"""The port's host data pipeline for training against the JAX package's, on
the CPU: transforms, processing_utils, DiMPProcessing, DiMPSampler over the
synthetic video dataset, the loader's collation, and the loader's shapes
(the twin of tests/test_training.py's pipeline tests).

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
