"""Tensor ops of the port: padding, resampling and cost volumes."""

from realtime_stereo_matcher_tpu_torch.ops.cost_volume import (
    correlation_cost_volume,
    difference_cost_volume,
    interweave_volume,
    shift_stack,
    soft_argmin,
    soft_argmin_trilinear,
)
from realtime_stereo_matcher_tpu_torch.ops.padding import (
    InputPadder,
    pad_to_multiple,
)
from realtime_stereo_matcher_tpu_torch.ops.sampling import (
    resize_bilinear,
    resize_nearest,
    resize_trilinear,
    warp_by_flow_map,
    warp_by_flow_map_banded,
)

__all__ = [
    "InputPadder",
    "correlation_cost_volume",
    "difference_cost_volume",
    "interweave_volume",
    "pad_to_multiple",
    "resize_bilinear",
    "resize_nearest",
    "resize_trilinear",
    "shift_stack",
    "soft_argmin",
    "soft_argmin_trilinear",
    "warp_by_flow_map",
    "warp_by_flow_map_banded",
]
