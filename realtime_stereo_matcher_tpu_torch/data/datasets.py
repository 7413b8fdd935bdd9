"""Stereo datasets (port of the JAX package's framework-free
``realtime_stereo_matcher_tpu/data/datasets.py``; reference
dataset/stereo_datasets.py).

Index-based map-style datasets producing NHWC numpy samples.  Sample
layout (vs. the reference's NCHW torch tensors):

    (files, img1 (H,W,3) f32, img2 (H,W,3) f32, flow (H,W,1) f32, valid (H,W) f32)

Disparity is converted to **negative horizontal flow** on read
(reference :78), the repo-wide sign convention.

Dataset roots resolve as ``<root>/<DatasetDir>``, where root comes from the
``RSM_DATA_ROOT`` env var, the config's ``data.dataset_root``, or the
reference's hard-coded ``/mnt/data/workspace/datasets``.

Training builds them with the config's ``aug_params`` (a crop: the host
augmentors of ``data/augment.py``; ``img_pad``), evaluation with
``aug_params={}`` (no augmentor).  :func:`build_train_dataset` concatenates
the config's ``train.datasets``.
"""

from __future__ import annotations

import copy
import logging
import os
import os.path as osp
from glob import glob
from pathlib import Path

import numpy as np

from realtime_stereo_matcher_tpu_torch.data import frame_io
from realtime_stereo_matcher_tpu_torch.data.augment import (
    FlowAugmentor,
    SparseFlowAugmentor,
)

DEFAULT_ROOT = os.environ.get("RSM_DATA_ROOT", "/mnt/data/workspace/datasets")


class StereoDataset:
    """Base dataset (reference stereo_datasets.py:21-126)."""

    def __init__(self, aug_params=None, sparse=False, reader=None):
        self.augmentor = None
        self.sparse = sparse
        self.img_pad = (aug_params.pop("img_pad", None)
                        if aug_params is not None else None)
        if aug_params is not None and "crop_size" in aug_params:
            if sparse:
                self.augmentor = SparseFlowAugmentor(**aug_params)
            else:
                self.augmentor = FlowAugmentor(**aug_params)

        self.disparity_reader = reader if reader is not None else frame_io.read_gen
        self.is_test = False
        # image output dtype: float32 by default; the device-augment path
        # sets uint8 to halve host->device transfer (data/device_augment.py)
        self.out_dtype = np.float32
        self.flow_list = []
        self.disparity_list = []
        self.image_list = []
        self.extra_info = []

    def seed(self, seed):
        """Reseed the augmentor (per-worker determinism, reference :56-62)."""
        if self.augmentor is not None:
            self.augmentor.seed(seed)

    def get(self, index, rng=None):
        """Like __getitem__ but with an explicit augmentation RNG, so the
        threaded loader is deterministic regardless of worker scheduling."""
        return self._get(index, rng)

    def __getitem__(self, index):
        return self._get(index, None)

    def _get(self, index, rng):
        if self.is_test:
            img1 = np.array(frame_io.read_gen(self.image_list[index][0]))
            img2 = np.array(frame_io.read_gen(self.image_list[index][1]))
            img1 = img1.astype(np.uint8)[..., :3].astype(np.float32)
            img2 = img2.astype(np.uint8)[..., :3].astype(np.float32)
            return img1, img2, self.extra_info[index]

        index = index % len(self.image_list)
        disp = self.disparity_reader(self.disparity_list[index])
        if isinstance(disp, tuple):
            disp, valid = disp
        else:
            valid = disp < 512

        img1 = np.array(frame_io.read_gen(self.image_list[index][0])).astype(np.uint8)
        img2 = np.array(frame_io.read_gen(self.image_list[index][1])).astype(np.uint8)

        disp = np.array(disp).astype(np.float32)
        flow = np.stack([-disp, np.zeros_like(disp)], axis=-1)

        if img1.ndim == 2:
            img1 = np.tile(img1[..., None], (1, 1, 3))
            img2 = np.tile(img2[..., None], (1, 1, 3))
        else:
            img1 = img1[..., :3]
            img2 = img2[..., :3]

        if self.augmentor is not None:
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(img1, img2, flow,
                                                         valid, rng=rng)
            else:
                img1, img2, flow = self.augmentor(img1, img2, flow, rng=rng)

        img1 = img1.astype(self.out_dtype)
        img2 = img2.astype(self.out_dtype)
        flow = flow.astype(np.float32)

        if self.sparse:
            valid = np.asarray(valid, np.float32)
        else:
            valid = ((np.abs(flow[..., 0]) < 512)
                     & (np.abs(flow[..., 1]) < 512)).astype(np.float32)

        if self.img_pad is not None:
            pad_h, pad_w = self.img_pad
            pads = [(pad_h, pad_h), (pad_w, pad_w), (0, 0)]
            img1 = np.pad(img1, pads)
            img2 = np.pad(img2, pads)

        flow = flow[..., :1]
        return (self.image_list[index] + [self.disparity_list[index]],
                img1, img2, flow, valid)

    def __mul__(self, v):
        copy_of_self = copy.copy(self)
        copy_of_self.flow_list = v * self.flow_list
        copy_of_self.image_list = v * self.image_list
        copy_of_self.disparity_list = v * self.disparity_list
        copy_of_self.extra_info = v * self.extra_info
        return copy_of_self

    def __add__(self, other):
        return ConcatDataset([self, other])

    def __len__(self):
        return len(self.image_list)


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = []
        for d in datasets:
            if isinstance(d, ConcatDataset):
                self.datasets.extend(d.datasets)
            else:
                self.datasets.append(d)
        self._lens = [len(d) for d in self.datasets]

    def seed(self, seed):
        for i, d in enumerate(self.datasets):
            d.seed(seed + i)

    def __len__(self):
        return sum(self._lens)

    def __add__(self, other):
        return ConcatDataset([self, other])

    def __getitem__(self, index):
        return self.get(index, None)

    def get(self, index, rng=None):
        for d, n in zip(self.datasets, self._lens):
            if index < n:
                return d.get(index, rng) if hasattr(d, "get") else d[index]
            index -= n
        raise IndexError(index)


class SceneFlowDatasets(StereoDataset):
    """FlyingThings3D / Monkaa / Driving (reference :129-220)."""

    def __init__(self, aug_params=None, root=None, dstype="frames_cleanpass",
                 things_test=False, subsets=("things", "monkaa", "driving")):
        super().__init__(aug_params)
        self.root = root or osp.join(DEFAULT_ROOT, "SceneFlow")
        self.dstype = dstype
        if "things" in subsets:
            self._add_things("TEST" if things_test else "TRAIN")
        if "monkaa" in subsets:
            self._add_monkaa()
        if "driving" in subsets:
            self._add_driving()

    def _add_things(self, split="TRAIN"):
        original_length = len(self.disparity_list)
        root = osp.join(self.root, "FlyingThings3D")
        left_images = sorted(
            glob(osp.join(root, self.dstype, split, "*/*/left/*.png")))
        right_images = [im.replace("left", "right") for im in left_images]
        disparity_images = [
            im.replace(self.dstype, "disparity").replace(".png", ".pfm")
            for im in left_images]
        # fixed random subset of 400 TEST images (reference :164-168)
        state = np.random.get_state()
        np.random.seed(1000)
        val_idxs = set(np.random.permutation(len(left_images))[:400])
        np.random.set_state(state)
        for idx, (img1, img2, disp) in enumerate(
                zip(left_images, right_images, disparity_images)):
            if (split == "TEST" and idx in val_idxs) or split == "TRAIN":
                self.image_list += [[img1, img2]]
                self.disparity_list += [disp]
        logging.info("Added %d from FlyingThings %s",
                     len(self.disparity_list) - original_length, self.dstype)

    def _add_monkaa(self):
        original_length = len(self.disparity_list)
        root = osp.join(self.root, "Monkaa")
        left_images = sorted(glob(osp.join(root, self.dstype, "*/left/*.png")))
        for img1 in left_images:
            self.image_list += [[img1, img1.replace("left", "right")]]
            self.disparity_list += [
                img1.replace(self.dstype, "disparity").replace(".png", ".pfm")]
        logging.info("Added %d from Monkaa %s",
                     len(self.disparity_list) - original_length, self.dstype)

    def _add_driving(self):
        original_length = len(self.disparity_list)
        root = osp.join(self.root, "Driving")
        left_images = sorted(glob(osp.join(root, self.dstype, "*/*/*/left/*.png")))
        for img1 in left_images:
            self.image_list += [[img1, img1.replace("left", "right")]]
            self.disparity_list += [
                img1.replace(self.dstype, "disparity").replace(".png", ".pfm")]
        logging.info("Added %d from Driving %s",
                     len(self.disparity_list) - original_length, self.dstype)


class ETH3D(StereoDataset):
    """ETH3D two-view (reference :223-240)."""

    def __init__(self, aug_params=None, root=None, split="training"):
        super().__init__(aug_params, sparse=True)
        root = root or osp.join(DEFAULT_ROOT, "ETH3D")
        image1_list = sorted(glob(osp.join(root, f"two_view_{split}/*/im0.png")))
        image2_list = sorted(glob(osp.join(root, f"two_view_{split}/*/im1.png")))
        disp_list = (
            sorted(glob(osp.join(root, "two_view_training_gt/*/disp0GT.pfm")))
            if split == "training"
            else [osp.join(root, "two_view_training_gt/playground_1l/disp0GT.pfm")]
            * len(image1_list))
        for img1, img2, disp in zip(image1_list, image2_list, disp_list):
            self.image_list += [[img1, img2]]
            self.disparity_list += [disp]


class SintelStereo(StereoDataset):
    """Sintel stereo training set (reference :243-258)."""

    def __init__(self, aug_params=None, root=None):
        super().__init__(aug_params, sparse=True,
                         reader=frame_io.read_disp_sintel)
        root = root or osp.join(DEFAULT_ROOT, "SintelStereo")
        image1_list = sorted(glob(osp.join(root, "training/*_left/*/frame_*.png")))
        image2_list = sorted(glob(osp.join(root, "training/*_right/*/frame_*.png")))
        disp_list = sorted(
            glob(osp.join(root, "training/disparities/*/frame_*.png"))) * 2
        for img1, img2, disp in zip(image1_list, image2_list, disp_list):
            assert img1.split("/")[-2:] == disp.split("/")[-2:]
            self.image_list += [[img1, img2]]
            self.disparity_list += [disp]


class FallingThings(StereoDataset):
    """FallingThings (reference :261-279)."""

    def __init__(self, aug_params=None, root=None):
        super().__init__(aug_params, reader=frame_io.read_disp_falling_things)
        root = root or osp.join(DEFAULT_ROOT, "FallingThings")
        assert os.path.exists(root)
        with open(os.path.join(root, "filenames.txt"), "r") as f:
            filenames = sorted(f.read().splitlines())
        for e in filenames:
            self.image_list += [[osp.join(root, e),
                                 osp.join(root, e.replace("left.jpg", "right.jpg"))]]
            self.disparity_list += [
                osp.join(root, e.replace("left.jpg", "left.depth.png"))]


class TartanAir(StereoDataset):
    """TartanAir (reference :282-313)."""

    def __init__(self, aug_params=None, root=None, keywords=()):
        super().__init__(aug_params, reader=frame_io.read_disp_tartan_air)
        root = root or DEFAULT_ROOT
        assert os.path.exists(root)
        with open(os.path.join(root, "tartanair_filenames.txt"), "r") as f:
            filenames = sorted(
                s for s in f.read().splitlines()
                if "seasonsforest_winter/Easy" not in s)
            for kw in keywords:
                filenames = sorted(s for s in filenames if kw in s.lower())
        for e in filenames:
            self.image_list += [[osp.join(root, e),
                                 osp.join(root, e.replace("_left", "_right"))]]
            self.disparity_list += [osp.join(
                root,
                e.replace("image_left", "depth_left").replace(
                    "left.png", "left_depth.npy"))]


class KITTI(StereoDataset):
    """KITTI 2015 (reference :316-341)."""

    def __init__(self, aug_params=None, root=None, image_set="training"):
        super().__init__(aug_params, sparse=True,
                         reader=frame_io.read_disp_kitti)
        root = root or osp.join(DEFAULT_ROOT, "KITTI")
        assert os.path.exists(root)
        image1_list = sorted(glob(os.path.join(root, image_set, "image_2/*_10.png")))
        image2_list = sorted(glob(os.path.join(root, image_set, "image_3/*_10.png")))
        disp_list = (
            sorted(glob(os.path.join(root, "training", "disp_occ_0/*_10.png")))
            if image_set == "training"
            else [osp.join(root, "training/disp_occ_0/000085_10.png")]
            * len(image1_list))
        for img1, img2, disp in zip(image1_list, image2_list, disp_list):
            self.image_list += [[img1, img2]]
            self.disparity_list += [disp]


class Middlebury(StereoDataset):
    """Middlebury V3 / 2014 (reference :344-408)."""

    def __init__(self, aug_params=None, root=None, phase="training", split="F"):
        super().__init__(aug_params, sparse=True,
                         reader=frame_io.read_disp_middlebury)
        root = root or osp.join(DEFAULT_ROOT, "Middlebury")
        assert os.path.exists(root)
        assert split in ["F", "H", "Q", "2014"]
        if split == "2014":
            scenes = list((Path(root) / "2014").glob("*"))
            for scene in scenes:
                for s in ["E", "L", ""]:
                    self.image_list += [
                        [str(scene / "im0.png"), str(scene / f"im1{s}.png")]]
                    self.disparity_list += [str(scene / "disp0.pfm")]
        else:
            lines = list(map(osp.basename,
                             glob(os.path.join(root, f"MiddEval3/{phase}{split}/*"))))
            image1_list = sorted(
                os.path.join(root, "MiddEval3", f"{phase}{split}", f"{n}/im0.png")
                for n in lines)
            image2_list = sorted(
                os.path.join(root, "MiddEval3", f"{phase}{split}", f"{n}/im1.png")
                for n in lines)
            disp_list = sorted(
                os.path.join(root, "MiddEval3", f"{phase}{split}", f"{n}/disp0GT.pfm")
                for n in lines)
            assert len(image1_list) == len(image2_list) == len(disp_list) > 0, [
                image1_list, phase, split]
            for img1, img2, disp in zip(image1_list, image2_list, disp_list):
                self.image_list += [[img1, img2]]
                self.disparity_list += [disp]


def build_train_dataset(exp_config, *, raw=False) -> ConcatDataset | StereoDataset:
    """Concatenate the configured training datasets
    (reference fetch_dataloader, stereo_datasets.py:411-482).

    ``raw=True`` builds the datasets without host augmentors (full-size
    samples), for the on-device augmentation path (data/device_augment.py).
    """
    from realtime_stereo_matcher_tpu_torch.config import ExperimentConfig

    assert isinstance(exp_config, ExperimentConfig)
    aug_params = None if raw else exp_config.aug_params()
    root = (exp_config.data.dataset_root or None) if exp_config.data else None

    def sub(name):
        return osp.join(root, name) if root else None

    def cp():
        return None if aug_params is None else dict(aug_params)

    train_dataset = None
    for dataset_name in exp_config.train.datasets:
        if dataset_name.startswith("middlebury_"):
            new_dataset = Middlebury(cp(), root=sub("Middlebury"),
                                     split=dataset_name.replace("middlebury_", ""))
        elif dataset_name == "sceneflow/things":
            new_dataset = SceneFlowDatasets(
                cp(), root=sub("SceneFlow"),
                dstype="frames_cleanpass", subsets=["things"])
        elif dataset_name == "sceneflow/driving":
            new_dataset = SceneFlowDatasets(
                cp(), root=sub("SceneFlow"),
                dstype="frames_cleanpass", subsets=["driving"])
        elif "kitti" in dataset_name:
            new_dataset = KITTI(cp(), root=sub("KITTI"))
        elif dataset_name == "sintel_stereo":
            new_dataset = SintelStereo(cp(),
                                       root=sub("SintelStereo")) * 140
        elif dataset_name == "falling_things":
            new_dataset = FallingThings(cp(),
                                        root=sub("FallingThings")) * 5
        elif dataset_name.startswith("tartan_air"):
            new_dataset = TartanAir(cp(), root=root,
                                    keywords=dataset_name.split("_")[2:])
        elif dataset_name == "eth3d":
            new_dataset = ETH3D(cp(), root=sub("ETH3D"))
        elif dataset_name.startswith("synthetic"):
            # "synthetic" or "synthetic_<N>": procedural scenes with exact GT
            # (data/synthetic.py); holdout seeds >= 10**6 are reserved for
            # validate_synthetic
            from realtime_stereo_matcher_tpu_torch.data.synthetic import (
                SyntheticStereo,
            )

            parts = dataset_name.split("_")
            length = int(parts[1]) if len(parts) > 1 else 2000
            new_dataset = SyntheticStereo(cp(), length=length)
        else:
            raise ValueError(f"unknown training dataset: {dataset_name}")
        logging.info("Adding %d samples from %s", len(new_dataset), dataset_name)
        train_dataset = (new_dataset if train_dataset is None
                         else train_dataset + new_dataset)
    logging.info("Training with %d image pairs", len(train_dataset))
    return train_dataset
