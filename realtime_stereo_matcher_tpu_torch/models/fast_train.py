"""Kernel-path training for MobileStereoNet v1, v2 and v3 (port of
``realtime_stereo_matcher_tpu/models/fast_train.py``).

``make_fast_train_step(model, tx, loss_params)`` is a drop-in replacement for
``train.trainer.make_train_step``: every stride-1 3x3 conv of the encoder
ResBlocks and the RefineNets runs on the differentiable
:func:`~realtime_stereo_matcher_tpu_torch.kernels.train_conv.flat_conv3x3`
(forward and dx on K1, dW on K4) and the five cost-filter convs on
:func:`~realtime_stereo_matcher_tpu_torch.kernels.train_conv3d.flat_conv3d`
(K3, and K4's 3D form).  As in the JAX package, the rest stays plain:

* the encoder's stride-2 convs and head (v1, v2);
* v3's U-Net extractor, the model's own forward, called once per view (it
  has no BatchNorm);
* v3's 65-channel refine entry conv;
* BatchNorm, ReLU, the cost volume, soft-argmin, the resizes and the warp.

Launches per bf16 step: v1 and v2 108 K1 (54 forward, 54 dx; v2's three
7 -> 32 entries and their 32 -> 7 dx among them), 10 K3 and 59 K4 (54 in
2D, 5 in 3D); v3 78 K1 (39 forward, 39 dx), 10 K3 and 44 K4 (39 in 2D, 5 in
3D).

Semantics match the plain model in train mode (and the Flax model):

* the parameters are the model's own, so gradients land in ``.grad``;
* train-mode BatchNorm with flax statistics (float32, biased variance,
  momentum 0.9) and *sequential* running-stat threading where one module is
  applied twice (the encoder on left, then right);
* the epilogue order of the JAX package's ``_bn_relu_mask``: statistics in
  float32 from the conv output, then ``y * scale + bias``, ReLU, then the
  residual add.  The affine runs in float32 and is rounded once to the
  compute dtype; the JAX package runs it in the compute dtype, where in
  bf16 ``y * scale`` and the folded bias ``-mean * scale`` cancel to a few
  bits wherever a channel's mean is large against its spread (v3's refine
  entries).  float32 is unaffected;
* the disparity stays float32 (float64 in a float64 step) across the
  refinements, and so does the warp's flow, which keeps its gradient: v2
  and v3 refinements warp the right guidance with the banded warp
  (``ops.warp_by_flow_map_banded``) at the level's ``max_shift``, as the
  JAX kernel path does; within the band that is the plain model's warp.

The TPU layout (lane fold, pixel phases, halo masks) is not carried over, so
BatchNorm needs no mask.  The running stats come back as a new dict keyed by
state-dict name, as ``model.apply(..., mutable=["batch_stats"])`` returns a
new tree; the step copies them into the model.

Data parallelism: ``make_fast_train_step(..., group=...)`` runs the step on
every rank of a ``torch.distributed`` group over its local images, as the
JAX package's ``shard_map`` over the mesh's ``data`` axis: every rank
launches the kernels on its local batch, the BatchNorm statistics are the
global batch's (sync-BN: ``layers.batch_stats``' differentiable all-reduce
of the sums, so a rank's output depends on every rank's input in the
backward too), the masked loss is each rank's share of the global one
(``train/loss.py``), and the gradients are summed over the ranks in one flat
all-reduce before the optimizer step.

Under a profiler a step is the span ``rsm.step`` holding the forward's
``rsm.extract``, ``rsm.cost`` and ``rsm.refine.<level>``, then ``rsm.loss``
(the loss and the step's metrics), ``rsm.backward`` (the backward and the
gradients' sum over the ranks) and ``rsm.optimizer`` (``utils/spans.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from realtime_stereo_matcher_tpu_torch import stats_dtype
from realtime_stereo_matcher_tpu_torch.kernels.refine_stack import refine_inputs
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
    MobileStereoNetV2,
    MobileStereoNetV3,
    _full_res_nearest,
    refine_max_shifts,
)
from realtime_stereo_matcher_tpu_torch.ops import (
    difference_cost_volume,
    pad_to_multiple,
    soft_argmin,
)
from realtime_stereo_matcher_tpu_torch.parallel.distributed import (
    all_reduce_,
    sum_gradients,
)
from realtime_stereo_matcher_tpu_torch.utils.spans import (
    refine_span_names,
    span,
)

_VARIANTS = (MobileStereoNet, MobileStereoNetV2, MobileStereoNetV3)


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """torch OIHW / OIDHW -> HWIO / DHWIO view."""
    return w.permute(*range(2, w.ndim), 1, 0)


class _PlainConv(torch.autograd.Function):
    """``F.conv2d`` (padding 1) of NCHW ``x`` whose backward runs cuDNN's
    deterministic algorithms: by default cuDNN may pick a weight or data
    gradient that sums with atomics, and two runs of one float32 step then
    gave the encoder's 20 gradients other bits.  The forward is
    ``F.conv2d`` itself; on the CPU the backward is autograd's."""

    @staticmethod
    def forward(ctx, x, w, stride: int):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return F.conv2d(x, w, stride=stride, padding=1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [ctx.stride] * 2, [1, 1], [1, 1], False,
                [0, 0], 1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                            False])
        finally:
            torch.backends.cudnn.deterministic = saved
        return dx, dw, None


def _conv2d_nhwc(x, w_oihw, *, stride=1):
    """Plain ``F.conv2d`` (torch padding 1) on NHWC ``x``: the convs the
    training path keeps off the kernels, as the JAX package kept them in
    XLA, with a deterministic backward (:class:`_PlainConv`)."""
    y = _PlainConv.apply(x.permute(0, 3, 1, 2), w_oihw, stride)
    return y.permute(0, 2, 3, 1)


def running_stats(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The model's BatchNorm running stats by state-dict name."""
    return {k: v for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _bn_relu(y, bn, key, stats, *, train, dtype, group=None):
    """flax BatchNorm + ReLU on a channels-last conv output, in the JAX
    package's kernel-path epilogue order, the affine in float32 and the
    result in ``dtype``; train mode writes the updated running stats of
    ``key`` (a state-dict prefix) into ``stats``, its statistics over the
    ranks of ``group`` where given (sync-BN)."""
    if train:
        mu, var = batch_stats(y, tuple(range(y.ndim - 1)), group)
        stats[f"{key}.running_mean"] = running_update(
            stats[f"{key}.running_mean"], mu)
        stats[f"{key}.running_var"] = running_update(
            stats[f"{key}.running_var"], var)
    else:
        mu, var = stats[f"{key}.running_mean"], stats[f"{key}.running_var"]
    scale = bn.weight.to(mu.dtype) * torch.rsqrt(var + bn.eps)
    bias = bn.bias.to(mu.dtype) - mu * scale
    # rounded to ``dtype`` before the ReLU, which commutes with rounding:
    # the ReLU and its backward then move ``dtype``, not float32
    return torch.relu(torch.addcmul(bias, y, scale).to(dtype))


def encoder_train(enc, x, stats, prefix="feature_extractor", *, train=True,
                  dtype=torch.float32, group=None):
    """FeatureEncoder forward with the ResBlock convs on the kernels; the
    stride-2 convs and the head stay plain.  ``x`` (B, H, W, 3) normalized
    image -> (B, H/8, W/8, 32) features in ``dtype``."""
    n_stages = (len(enc) - 1) // 2
    for i in range(n_stages):
        down = enc[2 * i]
        y = _conv2d_nhwc(x.to(dtype), down[0].weight.to(dtype), stride=2)
        y = _bn_relu(y, down[1], f"{prefix}.{2 * i}.1", stats, train=train,
                     dtype=dtype, group=group)
        z = y
        for c, seq in enumerate(enc[2 * i + 1].conv):
            z = flat_conv3x3(z, _hwio(seq[0].weight), seq[0].dilation[0])
            z = _bn_relu(z, seq[1], f"{prefix}.{2 * i + 1}.conv.{c}.1", stats,
                         train=train, dtype=dtype, group=group)
        x = z + y
    head = enc[2 * n_stages]
    return _conv2d_nhwc(x, head.weight.to(dtype)) + head.bias.to(dtype)


def cost_filter_train(cf, vol, stats, prefix="cost_filter", *, train=True,
                      dtype=torch.float32, group=None):
    """CostFilter3D forward on the kernels: (B, D, h, w, C) difference volume
    -> (B, D, h, w) float32 cost, the head bias added in float32 (float64
    for a float64 ``dtype``)."""
    x = vol.to(dtype)
    for j in range(4):
        x = flat_conv3d(x, _hwio(cf[3 * j].weight))
        x = _bn_relu(x, cf[3 * j + 1], f"{prefix}.{3 * j + 1}", stats,
                     train=train, dtype=dtype, group=group)
    head = cf[12]
    wide = stats_dtype(dtype)
    return (flat_conv3d(x, _hwio(head.weight))[..., 0].to(wide)
            + head.bias.to(wide))


def refine_net_train(rn, disp, l_guide, stats, prefix, r_guide=None,
                     max_shift=None, *, train=True, dtype=torch.float32,
                     group=None):
    """RefineNet on the kernels: (B, h, w, 1) float32 disparity and the
    (B, H, W, C) guides -> (B, 2h, 2w, 1) float32.  With ``r_guide`` (v2,
    v3) the right guide is warped by the upsampled disparity, banded at
    ``max_shift``.  An entry conv wider than 32 channels (v3's 65) stays
    plain, as in the JAX package; the others run on the kernels."""
    disp, guides = refine_inputs(disp, l_guide, r_guide, max_shift, dtype)
    x = torch.cat([disp.to(dtype), *guides], dim=-1)
    seq = rn.conv0
    entry = seq[0][0]
    x = (_conv2d_nhwc(x, entry.weight.to(dtype)) if entry.in_channels > 32
         else flat_conv3x3(x, _hwio(entry.weight)))
    x = _bn_relu(x, seq[0][1], f"{prefix}.conv0.0.1", stats, train=train,
                 dtype=dtype, group=group)
    for b, block in enumerate(list(seq)[1:-1], start=1):
        block_in = x
        for c, cbn in enumerate(block.conv):
            x = flat_conv3x3(x, _hwio(cbn[0].weight), cbn[0].dilation[0])
            x = _bn_relu(x, cbn[1], f"{prefix}.conv0.{b}.conv.{c}.1", stats,
                         train=train, dtype=dtype, group=group)
        x = x + block_in
    head = seq[-1]
    wide = stats_dtype(dtype)
    delta = flat_conv3x3(x, _hwio(head.weight)).to(wide) + head.bias.to(wide)
    return torch.relu(disp + delta)


def fast_train_forward(model, left_img, right_img, *, train: bool = True,
                       dtype=torch.float32, group=None):
    """Full v1, v2 or v3 forward on the kernel path.

    Returns (multi-scale negative disparities, coarse to fine, float32;
    new running stats by state-dict name) -- the contract of the JAX
    package's ``fast_train_forward``.  The model is not modified.  With
    ``group`` the BatchNorm statistics are the global batch's (the JAX
    package's ``axis_name``)."""
    if type(model) not in _VARIANTS:
        raise NotImplementedError(
            f"the kernel train path supports MobileStereoNet v1, v2 and v3, "
            f"not {type(model).__name__}; see ROADMAP.md")
    down = model.down_factor
    align = 2 ** down
    vol_disp = (model.max_disp + 1) // align
    stats = running_stats(model)
    kw = dict(train=train, dtype=dtype, group=group)

    with span("rsm.extract"):
        left, orig_hw = pad_to_multiple(normalize_images(left_img, dtype), align)
        right, _ = pad_to_multiple(normalize_images(right_img, dtype), align)
        if type(model) is MobileStereoNetV3:
            # the U-Net's own plain forward in the path's dtype, once per view
            with torch.autocast(left.device.type, dtype=dtype,
                                enabled=dtype != torch.float32):
                l_py = model.feature_extractor(left)
                r_py = model.feature_extractor(right)
            lf, rf = l_py[0].to(dtype), r_py[0].to(dtype)
            guides = list(zip(l_py[1:], r_py[1:]))
            refines, name = model.refine_layers, "refine_layers"
        else:
            lf = encoder_train(model.feature_extractor, left, stats, **kw)
            rf = encoder_train(model.feature_extractor, right, stats, **kw)
            warp = type(model) is MobileStereoNetV2
            guides = [(left, right if warp else None)] * down
            refines, name = model.refine_layer, "refine_layer"
    with span("rsm.cost"):
        vol = difference_cost_volume(lf, rf, vol_disp)
        cost = cost_filter_train(model.cost_filter, vol, stats, **kw)
        x = soft_argmin(cost, axis=1)[..., None]

    multi_scale = []
    out_hw = left.shape[1:3]
    shifts = refine_max_shifts(model.max_disp, down)
    refine_spans = refine_span_names(len(refines))
    for r, rn in enumerate(refines):
        with span(refine_spans[r]):
            l_guide, r_guide = guides[r]
            x = refine_net_train(rn, x, l_guide, stats, f"{name}.{r}", r_guide,
                                 shifts[r], **kw)
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
                         dtype=torch.bfloat16, group=None):
    """Kernel-path ``(state, img1, img2, flow, valid) -> (state, metrics)``
    step; the contract of ``train.trainer.make_train_step``.  The step
    updates the model, its running stats and ``tx`` in place.

    With ``group`` (a ``torch.distributed`` group) the batch is this rank's
    local slice of the global batch, and the step is the JAX package's
    sharded one (``mesh=``): sync-BN, the loss share backpropagated, the
    gradients summed over the ranks in one flat all-reduce, and the
    metrics (``live_loss`` the sum of the shares) the global batch's on
    every rank."""
    from realtime_stereo_matcher_tpu_torch.train.loss import (
        build_loss_function,
        flow_map_metrics,
    )

    loss = build_loss_function({"type": loss_type, "parameters": loss_params})

    def train_step(state, img1, img2, flow, valid):
        with span("rsm.step"):
            model.train()
            tx.zero_grad()
            preds, new_stats = fast_train_forward(model, img1, img2, train=True,
                                                  dtype=dtype, group=group)
            with span("rsm.loss"):
                loss_val = loss(preds, flow, valid, group=group)
                metrics = flow_map_metrics(flow, preds[-1].detach(), valid,
                                           group=group)
                live = loss_val.detach().clone().reshape(1)
                metrics["live_loss"] = all_reduce_(live, group, what="loss")[0]
            with span("rsm.backward"):
                loss_val.backward()
                sum_gradients(tx.params, group)
            with span("rsm.optimizer"):
                tx.step()
                load_running_stats(model, new_stats)
            state.step += 1
            return state, metrics

    return train_step


def fast_step_supported(model, exp_config, mesh=None) -> bool:
    """Whether the kernel train path applies: a v1, v2 or v3 model whose
    convs are the kernels' channel pairs (hidden width 32) and dilations
    (1 to 8), a crop size in the config and, on a ``mesh``
    (``parallel/mesh.py``) of several ranks, a global batch the ranks
    split evenly.  (The JAX package's rule that every refine level's width
    be a multiple of its 4-pixel lane fold is the TPU's, not the
    kernels'.)"""
    if type(model) not in _VARIANTS or model.hidden_dim != 32:
        return False
    if mesh is not None and exp_config.train.batch_size % mesh.size:
        return False
    if not all(1 <= d <= MAX_DILATION for d in model.refine_dilates):
        return False
    try:
        h, w = exp_config.data.image_size
    except (AttributeError, TypeError, ValueError):
        return False
    return h > 0 and w > 0
