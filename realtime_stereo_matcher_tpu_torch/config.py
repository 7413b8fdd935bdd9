"""Typed experiment configuration, ingesting the reference's JSON schema.

A copy of the JAX package's framework-free ``realtime_stereo_matcher_tpu/config.py``
(the port imports nothing of that package).  The reference passes a raw
``json.load`` dict everywhere with ``name / path / train / test / model /
data`` sections (reference train_stereo.py:227, configure/*.json); these
dataclasses hold the same schema with defaults, so the reference config
files load unchanged, and honour ``saturation_range`` / ``image_gamma`` /
``do_flip`` where present.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any


@dataclasses.dataclass
class LossConfig:
    type: str = "SequenceLoss"
    parameters: dict = dataclasses.field(
        default_factory=lambda: {"loss_gamma": 0.9, "max_flow_magnitude": 700})


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 4
    restore_checkpoint: str = ""
    save_checkpoint_frequency: int = 10000
    datasets: list = dataclasses.field(default_factory=list)
    learn_rate: float = 2e-4
    num_of_steps: int = 100000
    weight_decay: float = 1e-5
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    # "auto" | "on" | "off": train on the kernel path (models/fast_train.py)
    # when the model and crop support it; "on" raises where they do not
    fast_kernels: str = "auto"
    # pin every BatchNorm to eval mode while training -- the reference's
    # dormant freeze_bn (train_stereo.py:121-124), train/freeze.py
    freeze_bn: bool = False
    # hold the scenes on the device and augment there inside the train step
    # (data/device_cache.py, data/device_augment.py)
    device_augment: bool = False


@dataclasses.dataclass
class TestConfig:
    datasets: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ModelConfig:
    type: str = "MobileStereoNet"
    parameters: dict = dataclasses.field(default_factory=dict)
    downsample_factor: int = 6
    mixed_precision: bool = True  # reference default (evaluate_stereo.py:320)

    def as_dict(self) -> dict:
        return {"type": self.type, "parameters": dict(self.parameters)}


@dataclasses.dataclass
class DataConfig:
    image_size: list = dataclasses.field(default_factory=lambda: [240, 320])
    spatial_scale: list = dataclasses.field(default_factory=lambda: [-0.2, 0.4])
    do_flip: Any = False
    no_y_jitter: bool = False
    saturation_range: Any = None
    image_gamma: Any = None
    dataset_root: str = ""  # framework addition: base dir for datasets


@dataclasses.dataclass
class ExperimentConfig:
    name: str = "experiment"
    path: str = "experiments/experiment"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig | None = None
    test: TestConfig | None = None
    data: DataConfig | None = None

    @property
    def has_train(self) -> bool:
        return self.train is not None

    def aug_params(self) -> dict:
        """Augmentor kwargs (reference dataset/stereo_datasets.py:414-435,
        with the dead-config bug fixed)."""
        d = self.data or DataConfig()
        params = {
            "crop_size": tuple(d.image_size),
            "min_scale": d.spatial_scale[0],
            "max_scale": d.spatial_scale[1],
            "do_flip": d.do_flip,
            "yjitter": not d.no_y_jitter,
        }
        if d.saturation_range:
            params["saturation_range"] = tuple(d.saturation_range)
        if d.image_gamma:
            params["gamma"] = tuple(d.image_gamma)
        return params


def _build(cls, src: dict):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in src.items():
        if k not in fields:
            continue  # tolerate unknown keys like the reference's raw dict
        if k == "loss" and isinstance(v, dict):
            v = LossConfig(**v)
        kwargs[k] = v
    return cls(**kwargs)


def load_config(path_or_dict) -> ExperimentConfig:
    """Load an ExperimentConfig from a reference-schema JSON file or dict."""
    if isinstance(path_or_dict, (str, Path)):
        raw = json.loads(Path(path_or_dict).read_text())
    else:
        raw = dict(path_or_dict)
    cfg = ExperimentConfig(
        name=raw.get("name", "experiment"),
        path=raw.get("path", "experiments/experiment"),
        model=_build(ModelConfig, raw.get("model", {})),
        train=_build(TrainConfig, raw["train"]) if "train" in raw else None,
        test=_build(TestConfig, raw["test"]) if "test" in raw else None,
        data=_build(DataConfig, raw["data"]) if "data" in raw else None,
    )
    return cfg
