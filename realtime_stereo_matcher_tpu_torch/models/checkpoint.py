"""Load trained weights into a port model.

``load_weights(path, model)`` reads three kinds of file, each with
``torch.load(..., weights_only=True)`` (tensors and plain containers only,
no pickled code):

* a checkpoint of the port's trainer (``train.trainer.save_checkpoint``:
  the state dict under ``"model"``);
* a plain state dict saved with ``torch.save`` (the files under
  ``realtime_stereo_matcher_tpu_torch/weights/``);
* a checkpoint of the reference PyTorch code, ``.pth`` or gzipped
  ``.pth.gz``, its state dict bare or under ``"state_dict"``, its keys with
  or without DataParallel's ``module.`` prefix.  The port's models use the
  reference's parameter names, so no layout changes (the JAX package's
  ``models/torch_import.py`` ``load_torch_checkpoint`` reads the same files
  and then converts layouts).

The JAX package writes orbax checkpoint directories, which only JAX can
read: the function refuses a directory and says how such weights are
converted.
"""

from __future__ import annotations

import gzip
import io
from pathlib import Path

import torch


def _read(path: Path):
    if path.name.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return torch.load(io.BytesIO(f.read()), map_location="cpu",
                              weights_only=True)
    return torch.load(path, map_location="cpu", weights_only=True)


def read_state_dict(path) -> dict[str, torch.Tensor]:
    """The model state dict held by the file at ``path`` (on the CPU)."""
    path = Path(path)
    if path.is_dir():
        raise ValueError(
            f"{path} is a directory: an orbax checkpoint of the JAX package, "
            "which only JAX reads.  Convert it where JAX is installed: "
            "restore it with the JAX package's create_train_state and "
            "restore_checkpoint, map the variables with "
            "realtime_stereo_matcher_tpu_torch.models.convert."
            "from_jax_variables, and torch.save the state dict "
            "(tests/test_torch_port_eval.py --write-weights does this for "
            "the weights under realtime_stereo_matcher_tpu_torch/weights/)")
    obj = _read(path)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    elif isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise ValueError(f"{path} holds no state dict ({type(obj).__name__})")
    return {k.removeprefix("module."): v for k, v in obj.items()}


def load_weights(path, model: torch.nn.Module) -> torch.nn.Module:
    """Load the weights and BatchNorm statistics of the file at ``path``
    into ``model`` (strictly: every key of the model, and no other) on the
    model's device; returns ``model``."""
    model.load_state_dict(read_state_dict(path))
    return model
