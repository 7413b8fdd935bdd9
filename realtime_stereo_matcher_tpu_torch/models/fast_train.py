"""Kernel-path training for MobileStereoNet v1 (port of
``realtime_stereo_matcher_tpu/models/fast_train.py``).

``make_fast_train_step(model, tx, loss_params)`` is a drop-in replacement for
``train.trainer.make_train_step``: every stride-1 3x3 conv of the encoder
ResBlocks and the RefineNets runs on the differentiable
:func:`~realtime_stereo_matcher_tpu_torch.kernels.train_conv.flat_conv3x3`
(forward and dx on K1, dW on K4) and the five cost-filter convs on
:func:`~realtime_stereo_matcher_tpu_torch.kernels.train_conv3d.flat_conv3d`
(K3, and K4's 3D form).  The encoder's stride-2 convs and head stay plain
``F.conv2d``, as the JAX package kept them in XLA.  BatchNorm, ReLU, the
cost volume, soft-argmin and the resizes are plain PyTorch between kernels.
Per bf16 step at the reference config that is 108 K1 launches (54 forward,
54 dx), 10 K3 and 59 K4 (54 in 2D, 5 in 3D).

Semantics match the plain model in train mode (and the Flax model):

* the parameters are the model's own, so gradients land in ``.grad``;
* train-mode BatchNorm with flax statistics (float32, biased variance,
  momentum 0.9) and *sequential* running-stat threading where one module is
  applied twice (the encoder on left, then right);
* the epilogue order of the JAX package's ``_bn_relu_mask``: statistics in
  float32 from the conv output, then ``y * scale + bias`` in the compute
  dtype, ReLU, then the residual add;
* the disparity stays float32 across the refinements.

The TPU layout (lane fold, pixel phases, halo masks) is not carried over, so
BatchNorm needs no mask.  The running stats come back as a new dict keyed by
state-dict name, as ``model.apply(..., mutable=["batch_stats"])`` returns a
new tree; the step copies them into the model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from realtime_stereo_matcher_tpu_torch.kernels.train_conv import (
    MAX_DILATION,
    flat_conv3x3,
)
from realtime_stereo_matcher_tpu_torch.kernels.train_conv3d import flat_conv3d
from realtime_stereo_matcher_tpu_torch.models.layers import (
    batch_stats,
    normalize_images,
    running_update,
)
from realtime_stereo_matcher_tpu_torch.models.stereo_net import (
    MobileStereoNet,
    _full_res_nearest,
)
from realtime_stereo_matcher_tpu_torch.ops import (
    difference_cost_volume,
    pad_to_multiple,
    resize_bilinear,
    soft_argmin,
)


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """torch OIHW / OIDHW -> HWIO / DHWIO view."""
    return w.permute(*range(2, w.ndim), 1, 0)


def _conv2d_nhwc(x, w_oihw, *, stride=1):
    """Plain ``F.conv2d`` (torch padding 1) on NHWC ``x``: the convs the
    training path keeps off the kernels, as the JAX package kept them in
    XLA."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, stride=stride, padding=1)
    return y.permute(0, 2, 3, 1)


def running_stats(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The model's BatchNorm running stats by state-dict name."""
    return {k: v for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _bn_relu(y, bn, key, stats, *, train, dtype):
    """flax BatchNorm + ReLU on a channels-last conv output, in the JAX
    package's kernel-path epilogue order; train mode writes the updated
    running stats of ``key`` (a state-dict prefix) into ``stats``."""
    if train:
        mu, var = batch_stats(y, tuple(range(y.ndim - 1)))
        stats[f"{key}.running_mean"] = running_update(
            stats[f"{key}.running_mean"], mu)
        stats[f"{key}.running_var"] = running_update(
            stats[f"{key}.running_var"], var)
    else:
        mu, var = stats[f"{key}.running_mean"], stats[f"{key}.running_var"]
    scale = bn.weight.float() * torch.rsqrt(var + bn.eps)
    bias = bn.bias.float() - mu * scale
    return torch.relu(y.to(dtype) * scale.to(dtype) + bias.to(dtype))


def encoder_train(enc, x, stats, prefix="feature_extractor", *, train=True,
                  dtype=torch.float32):
    """FeatureEncoder forward with the ResBlock convs on the kernels; the
    stride-2 convs and the head stay plain.  ``x`` (B, H, W, 3) normalized
    image -> (B, H/8, W/8, 32) features in ``dtype``."""
    n_stages = (len(enc) - 1) // 2
    for i in range(n_stages):
        down = enc[2 * i]
        y = _conv2d_nhwc(x.to(dtype), down[0].weight.to(dtype), stride=2)
        y = _bn_relu(y, down[1], f"{prefix}.{2 * i}.1", stats, train=train,
                     dtype=dtype)
        z = y
        for c, seq in enumerate(enc[2 * i + 1].conv):
            z = flat_conv3x3(z, _hwio(seq[0].weight), seq[0].dilation[0])
            z = _bn_relu(z, seq[1], f"{prefix}.{2 * i + 1}.conv.{c}.1", stats,
                         train=train, dtype=dtype)
        x = z + y
    head = enc[2 * n_stages]
    return _conv2d_nhwc(x, head.weight.to(dtype)) + head.bias.to(dtype)


def cost_filter_train(cf, vol, stats, prefix="cost_filter", *, train=True,
                      dtype=torch.float32):
    """CostFilter3D forward on the kernels: (B, D, h, w, C) difference volume
    -> (B, D, h, w) float32 cost, the head bias added in float32."""
    x = vol.to(dtype)
    for j in range(4):
        x = flat_conv3d(x, _hwio(cf[3 * j].weight))
        x = _bn_relu(x, cf[3 * j + 1], f"{prefix}.{3 * j + 1}", stats,
                     train=train, dtype=dtype)
    head = cf[12]
    return flat_conv3d(x, _hwio(head.weight))[..., 0].float() + head.bias.float()


def refine_net_train(rn, disp, l_guide, stats, prefix, *, train=True,
                     dtype=torch.float32):
    """RefineNet (v1, no warp) on the kernels: (B, h, w, 1) float32
    disparity and the (B, H, W, 3) guide -> (B, 2h, 2w, 1) float32."""
    h2, w2 = disp.shape[1] * 2, disp.shape[2] * 2
    disp = resize_bilinear(disp.float(), (h2, w2)) * 2.0
    if l_guide.shape[1:3] != (h2, w2):
        l_guide = resize_bilinear(l_guide, (h2, w2))
    x = torch.cat([disp.to(dtype), l_guide.to(dtype)], dim=-1)
    seq = rn.conv0
    x = flat_conv3x3(x, _hwio(seq[0][0].weight))
    x = _bn_relu(x, seq[0][1], f"{prefix}.conv0.0.1", stats, train=train,
                 dtype=dtype)
    for b, block in enumerate(list(seq)[1:-1], start=1):
        block_in = x
        for c, cbn in enumerate(block.conv):
            x = flat_conv3x3(x, _hwio(cbn[0].weight), cbn[0].dilation[0])
            x = _bn_relu(x, cbn[1], f"{prefix}.conv0.{b}.conv.{c}.1", stats,
                         train=train, dtype=dtype)
        x = x + block_in
    head = seq[-1]
    delta = flat_conv3x3(x, _hwio(head.weight)).float() + head.bias.float()
    return torch.relu(disp + delta)


def fast_train_forward(model: MobileStereoNet, left_img, right_img, *,
                       train: bool = True, dtype=torch.float32):
    """Full v1 forward on the kernel path.

    Returns (multi-scale negative disparities, coarse to fine, float32;
    new running stats by state-dict name) -- the contract of the JAX
    package's ``fast_train_forward``.  The model is not modified."""
    if type(model) is not MobileStereoNet:
        raise NotImplementedError(
            f"the kernel train path supports MobileStereoNet v1, not "
            f"{type(model).__name__}; see ROADMAP.md")
    align = 2 ** model.down_factor
    vol_disp = (model.max_disp + 1) // align
    stats = running_stats(model)
    kw = dict(train=train, dtype=dtype)

    left, orig_hw = pad_to_multiple(normalize_images(left_img, dtype), align)
    right, _ = pad_to_multiple(normalize_images(right_img, dtype), align)
    lf = encoder_train(model.feature_extractor, left, stats, **kw)
    rf = encoder_train(model.feature_extractor, right, stats, **kw)
    vol = difference_cost_volume(lf, rf, vol_disp)
    cost = cost_filter_train(model.cost_filter, vol, stats, **kw)
    x = soft_argmin(cost, axis=1)[..., None]

    multi_scale = []
    out_hw = left.shape[1:3]
    for r, rn in enumerate(model.refine_layer):
        x = refine_net_train(rn, x, left, stats, f"refine_layer.{r}", **kw)
        multi_scale.append(_full_res_nearest(x, out_hw, orig_hw))
    return [-1.0 * m for m in multi_scale], stats


@torch.no_grad()
def load_running_stats(model: torch.nn.Module, stats: dict) -> None:
    """Copy a ``fast_train_forward`` stats dict into the model's buffers."""
    buffers = dict(model.named_buffers())
    for k, v in stats.items():
        buffers[k].copy_(v)


def make_fast_train_step(model, tx, loss_params: dict,
                         loss_type: str = "SequenceLoss", *,
                         dtype=torch.bfloat16):
    """Kernel-path ``(state, img1, img2, flow, valid) -> (state, metrics)``
    step; the contract of ``train.trainer.make_train_step``.  The step
    updates the model, its running stats and ``tx`` in place.  (The JAX
    package's sharded form, ``mesh=``, is not ported.)"""
    from realtime_stereo_matcher_tpu_torch.train.loss import (
        build_loss_function,
        flow_map_metrics,
    )

    loss = build_loss_function({"type": loss_type, "parameters": loss_params})

    def train_step(state, img1, img2, flow, valid):
        model.train()
        tx.zero_grad()
        preds, new_stats = fast_train_forward(model, img1, img2, train=True,
                                              dtype=dtype)
        loss_val = loss(preds, flow, valid)
        loss_val.backward()
        tx.step()
        load_running_stats(model, new_stats)
        metrics = flow_map_metrics(flow, preds[-1].detach(), valid)
        metrics["live_loss"] = loss_val.detach()
        state.step += 1
        return state, metrics

    return train_step


def fast_step_supported(model, exp_config) -> bool:
    """Whether the kernel train path applies: a v1 model whose convs are the
    kernels' channel pairs (hidden width 32) and dilations (1 to 8), and a
    crop size in the config."""
    if type(model) is not MobileStereoNet or model.hidden_dim != 32:
        return False
    if not all(1 <= d <= MAX_DILATION for d in model.refine_dilates):
        return False
    try:
        h, w = exp_config.data.image_size
    except (AttributeError, TypeError, ValueError):
        return False
    return h > 0 and w > 0
