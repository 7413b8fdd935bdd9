"""Sequence loss and flow-map metrics (port of
``realtime_stereo_matcher_tpu/train/loss.py``; reference loss/loss.py).

* exponentially weighted multi-prediction loss: weight ``gamma^(n-1-i)``,
  plain L1 for intermediate predictions, SmoothL1 (beta=1) for the final one;
* predictions whose shape differs from the ground truth are upsampled with
  *nearest* interpolation and rescaled by the width ratio;
* the valid mask combines the dataset mask with ``|flow| < max_flow_magnitude``.

Masked means are explicit sums over a float mask, and everything reduces in
float32, as in the JAX package.  Layouts are NHWC: predictions and flow
(B, H, W, 1), valid (B, H, W).
"""

from __future__ import annotations

from typing import Sequence

import torch

from realtime_stereo_matcher_tpu_torch.ops import resize_nearest


def smooth_l1(diff: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ad = diff.abs()
    return torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()
    return (x * m).sum() / m.sum().clamp(min=1.0)


def sequence_loss(flow_preds: Sequence[torch.Tensor], flow_gt: torch.Tensor,
                  flow_valid: torch.Tensor, *, loss_gamma: float = 0.9,
                  max_flow_magnitude: float = 700.0) -> torch.Tensor:
    """Reference SequenceLoss.forward (loss/loss.py:35-81): a float32 scalar
    over (B, H', W', 1) predictions, coarse to fine."""
    n_preds = len(flow_preds)
    if n_preds < 1:
        raise ValueError(f"empty flow predictions ({n_preds})!")
    gt = flow_gt.float()
    flow_mag = torch.sqrt(torch.sum(gt ** 2, dim=-1))
    valid = ((flow_valid.float() >= 0.5) & (flow_mag < max_flow_magnitude))
    valid = valid[..., None]

    total = torch.zeros((), dtype=torch.float32, device=gt.device)
    h, w = gt.shape[1], gt.shape[2]
    for i, pred in enumerate(flow_preds):
        weight = loss_gamma ** (n_preds - 1 - i)
        p = pred.float()
        if p.shape[1] != h or p.shape[2] != w:
            p = resize_nearest(p * (float(w) / p.shape[2]), (h, w))
        diff = gt - p
        err = smooth_l1(diff) if i == n_preds - 1 else diff.abs()
        total = total + weight * _masked_mean(err, valid)
    return total


def flow_map_metrics(flow_gt, flow_pred, flow_valid) -> dict:
    """Reference get_flow_map_metrics (loss/loss.py:6-22): masked EPE, the
    <0.5/1/3/5 px rates and the first image's prediction min/max, as float32
    tensors on the prediction's device (no host sync)."""
    gt = flow_gt.float()
    pred = flow_pred.float()
    valid = flow_valid.float() >= 0.5
    epe = torch.sqrt(torch.sum((pred - gt) ** 2, dim=-1))
    metrics = {"epe": _masked_mean(epe, valid)}
    for name, px in (("0.5px", 0.5), ("1px", 1.0), ("3px", 3.0), ("5px", 5.0)):
        metrics[name] = _masked_mean((epe < px).float(), valid)
    metrics["min"] = pred[0].min()
    metrics["max"] = pred[0].max()
    return metrics


def build_loss_function(loss_config: dict):
    """Loss factory on the config's ``type`` (reference loss/__init__.py):
    returns ``loss_fn(preds, gt, valid)``; unknown types raise."""
    ltype = loss_config.get("type", "SequenceLoss")
    params = dict(loss_config.get("parameters", {}))
    if ltype != "SequenceLoss":
        raise NotImplementedError(f"invalid loss type: {ltype}!")
    gamma = float(params.get("loss_gamma", 0.9))
    max_flow = float(params.get("max_flow_magnitude", 700))

    def loss_fn(preds, gt, valid):
        return sequence_loss(preds, gt, valid, loss_gamma=gamma,
                             max_flow_magnitude=max_flow)

    return loss_fn
