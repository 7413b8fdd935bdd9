"""Tensor ops of the port: padding, resampling and cost volumes."""

from realtime_stereo_matcher_tpu_torch.ops.cost_volume import (
    difference_cost_volume,
    shift_stack,
    soft_argmin,
)
from realtime_stereo_matcher_tpu_torch.ops.padding import (
    InputPadder,
    pad_to_multiple,
)
from realtime_stereo_matcher_tpu_torch.ops.sampling import (
    resize_bilinear,
    resize_nearest,
    warp_by_flow_map,
    warp_by_flow_map_banded,
)

__all__ = [
    "InputPadder",
    "difference_cost_volume",
    "pad_to_multiple",
    "resize_bilinear",
    "resize_nearest",
    "shift_stack",
    "soft_argmin",
    "warp_by_flow_map",
    "warp_by_flow_map_banded",
]
