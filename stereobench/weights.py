"""Weights drawn from the run's seed on the card, in one call.

The same state dict is handed to the program and to the reference.  Every
value comes from one uniform draw in [-1, 1) of a ``torch.Generator`` on
the device, scaled per tensor:

* a convolution's weight to He's variance 2 / fan-in (a transposed
  convolution's fan-in counts the inputs that reach one output), so the
  features keep their scale through the ReLU stacks and the answer depends
  on the images: with less, the biases drown the features, and a wrong
  frame's answer reads like the right one's; its bias to +-0.1;
* a BatchNorm's weight to 1 +- 0.2, its bias to +-0.1; its running mean
  and variance are then those of its input on the cell's first trigger
  (:func:`calibrate_batchnorm`), as a trained net's BatchNorm holds its
  data's statistics.  Without that, the refinements' entry passes the
  disparity (in px) on at full scale: the refinements grow it past the
  image's width on some seeds, and the bf16 rounding of that input sets
  the answer's error, seed by seed.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d)


def _scales(model: nn.Module):
    """(state-dict key, shape, scale, offset) of every floating tensor."""
    out = []
    for prefix, m in model.named_modules():
        pre = f"{prefix}." if prefix else ""
        if isinstance(m, nn.ConvTranspose2d):
            fan_in = m.weight.shape[0] * math.prod(m.kernel_size) / math.prod(m.stride)
            out.append((pre + "weight", m.weight.shape, math.sqrt(6 / fan_in), 0.0))
        elif isinstance(m, _CONVS):
            fan_in = m.weight[0].numel()
            out.append((pre + "weight", m.weight.shape, math.sqrt(6 / fan_in), 0.0))
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            out += [(pre + "weight", m.weight.shape, 0.2, 1.0),
                    (pre + "bias", m.bias.shape, 0.1, 0.0),
                    (pre + "running_mean", m.running_mean.shape, 0.1, 0.0),
                    (pre + "running_var", m.running_var.shape, 0.5, 1.0)]
            continue
        else:
            continue
        if m.bias is not None:
            out.append((pre + "bias", m.bias.shape, 0.1, 0.0))
    return out


@torch.no_grad()
def calibrate_batchnorm(model: nn.Module, state_dict: dict, inputs) -> dict:
    """``state_dict`` with every BatchNorm's running mean and (biased)
    variance set to the statistics of its input when ``model`` (loaded
    with it) runs on ``inputs``, layer by layer in forward order; a
    variance is kept at 1e-3 or more."""
    model.load_state_dict(state_dict)

    def hook(bn, args):
        x = args[0].float()
        dims = [0, *range(2, x.ndim)]
        bn.running_mean.copy_(x.mean(dims))
        bn.running_var.copy_(x.var(dims, unbiased=False).clamp(min=1e-3))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    try:
        model(*inputs)
    finally:
        for h in handles:
            h.remove()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@torch.no_grad()
def seeded_state_dict(model: nn.Module, seed: int, device) -> dict:
    """A state dict for ``model`` (any device, meta included) drawn from
    ``seed`` on ``device``, float32."""
    specs = _scales(model)
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    sd, at = {}, 0
    for key, shape, scale, offset in specs:
        n = math.prod(shape)
        sd[key] = flat[at:at + n].view(shape) * scale + offset
        at += n
    for key, buf in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.zeros((), dtype=buf.dtype, device=device)
    missing = set(model.state_dict()) - set(sd)
    if missing:
        raise KeyError(f"no seeded value for {sorted(missing)}")
    return sd
