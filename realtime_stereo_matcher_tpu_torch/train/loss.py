"""Sequence loss and flow-map metrics (port of
``realtime_stereo_matcher_tpu/train/loss.py``; reference loss/loss.py).

* exponentially weighted multi-prediction loss: weight ``gamma^(n-1-i)``,
  plain L1 for intermediate predictions, SmoothL1 (beta=1) for the final one;
* predictions whose shape differs from the ground truth are upsampled with
  *nearest* interpolation and rescaled by the width ratio;
* the valid mask combines the dataset mask with ``|flow| < max_flow_magnitude``.

Masked means are explicit sums over a float mask, and everything reduces in
float32, as in the JAX package (in float64 where a prediction or the flow is
float64, so that float64 steps can be compared to rounding).  Layouts are
NHWC: predictions and flow (B, H, W, 1), valid (B, H, W).

Across ranks (``group``, a ``torch.distributed`` group; None: one process)
the means are the global batch's, as the JAX package's under ``axis_name``:

* the denominator (the valid count) is all-reduced and carries no
  gradient, and ``sequence_loss`` returns this rank's *share*
  ``sum_levels w * num_r / den_global``: the shares sum over the ranks to
  the global loss, and the backward of a share gives this rank's part of
  the global gradient, which the step sums over the ranks.  (Every rank
  backpropagating the global loss would give ``world`` times the gradient;
  a DDP-style mean of per-rank losses is wrong wherever the ranks' valid
  counts differ.)
* ``flow_map_metrics`` returns the global values on every rank: the masked
  means from all-reduced sums, and ``min`` / ``max`` the min / max over the
  ranks of each rank's *first local image*, as the JAX package's
  ``pmin`` / ``pmax`` of ``pred[0]``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from realtime_stereo_matcher_tpu_torch import stats_dtype
from realtime_stereo_matcher_tpu_torch.ops import resize_nearest
from realtime_stereo_matcher_tpu_torch.parallel.distributed import all_reduce_


def smooth_l1(diff: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ad = diff.abs()
    return torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)


def _global_count(mask: torch.Tensor, group, dtype) -> torch.Tensor:
    """The mask's count summed over the ranks, at least 1, no gradient."""
    den = mask.detach().to(dtype).sum().reshape(1)
    return all_reduce_(den, group, what="loss count")[0].clamp(min=1.0)


def sequence_loss(flow_preds: Sequence[torch.Tensor], flow_gt: torch.Tensor,
                  flow_valid: torch.Tensor, *, loss_gamma: float = 0.9,
                  max_flow_magnitude: float = 700.0,
                  group=None) -> torch.Tensor:
    """Reference SequenceLoss.forward (loss/loss.py:35-81): a float32 scalar
    over (B, H', W', 1) predictions, coarse to fine.  With ``group``: this
    rank's share of the global loss (module docstring)."""
    n_preds = len(flow_preds)
    if n_preds < 1:
        raise ValueError(f"empty flow predictions ({n_preds})!")
    acc = stats_dtype(flow_gt.dtype, *(p.dtype for p in flow_preds))
    gt = flow_gt.to(acc)
    flow_mag = torch.sqrt(torch.sum(gt ** 2, dim=-1))
    valid = ((flow_valid.float() >= 0.5) & (flow_mag < max_flow_magnitude))
    valid = valid[..., None]
    den = _global_count(valid, group, acc)

    total = torch.zeros((), dtype=acc, device=gt.device)
    h, w = gt.shape[1], gt.shape[2]
    for i, pred in enumerate(flow_preds):
        weight = loss_gamma ** (n_preds - 1 - i)
        p = pred.to(acc)
        if p.shape[1] != h or p.shape[2] != w:
            p = resize_nearest(p * (float(w) / p.shape[2]), (h, w))
        diff = gt - p
        err = smooth_l1(diff) if i == n_preds - 1 else diff.abs()
        total = total + weight * ((err * valid.to(acc)).sum() / den)
    return total


_RATES = (("0.5px", 0.5), ("1px", 1.0), ("3px", 3.0), ("5px", 5.0))


def flow_map_metrics(flow_gt, flow_pred, flow_valid, group=None) -> dict:
    """Reference get_flow_map_metrics (loss/loss.py:6-22): masked EPE, the
    <0.5/1/3/5 px rates and the first image's prediction min/max, as float32
    (float64) tensors on the prediction's device (no host sync).  With
    ``group``: the global values (module docstring), in two all-reduces."""
    acc = stats_dtype(flow_gt.dtype, flow_pred.dtype)
    gt = flow_gt.to(acc)
    pred = flow_pred.to(acc)
    m = (flow_valid.float() >= 0.5).to(acc)
    epe = torch.sqrt(torch.sum((pred - gt) ** 2, dim=-1))
    sums = torch.stack([(epe * m).sum()]
                       + [((epe < px).to(acc) * m).sum() for _, px in _RATES]
                       + [m.sum()])
    all_reduce_(sums, group, what="metrics")
    means = sums[:-1] / sums[-1].clamp(min=1.0)
    extremes = torch.stack([pred[0].min(), -pred[0].max()])
    all_reduce_(extremes, group, op="min", what="metrics min/max")
    metrics = dict(zip(["epe"] + [name for name, _ in _RATES], means.unbind()))
    metrics["min"], metrics["max"] = extremes[0], -extremes[1]
    return metrics


def build_loss_function(loss_config: dict):
    """Loss factory on the config's ``type`` (reference loss/__init__.py):
    returns ``loss_fn(preds, gt, valid, group=None)``; unknown types
    raise."""
    ltype = loss_config.get("type", "SequenceLoss")
    params = dict(loss_config.get("parameters", {}))
    if ltype != "SequenceLoss":
        raise NotImplementedError(f"invalid loss type: {ltype}!")
    gamma = float(params.get("loss_gamma", 0.9))
    max_flow = float(params.get("max_flow_magnitude", 700))

    def loss_fn(preds, gt, valid, group=None):
        return sequence_loss(preds, gt, valid, loss_gamma=gamma,
                             max_flow_magnitude=max_flow, group=group)

    return loss_fn
