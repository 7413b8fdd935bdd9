"""Input padding utilities (port of ``realtime_stereo_matcher_tpu/ops/padding.py``).

* :class:`InputPadder` -- pad (B, H, W, C) images up to a multiple of
  ``divis_by`` in replicate mode, centered ("sintel") or bottom-anchored,
  with an ``unpad`` crop back (reference dataset/input_padder.py:4-29).
* :func:`pad_to_multiple` -- the in-model right/bottom zero pad every network
  applies before feature extraction (reference model/mobile_stereo_net.py:124-130).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_to_multiple(x: torch.Tensor, multiple: int, *, h_axis: int = 1,
                    w_axis: int = 2, mode: str = "constant"):
    """Zero-pad H and W (right/bottom) up to the next multiple.

    Mirrors the reference's in-model ``F.pad(img, (0, w_pad, 0, h_pad))``.
    ``mode`` is ``"constant"`` or ``"edge"``.  Returns (padded, (orig_h, orig_w)).
    """
    h, w = x.shape[h_axis], x.shape[w_axis]
    h_pad = (multiple - h % multiple) % multiple
    w_pad = (multiple - w % multiple) % multiple
    if h_pad == 0 and w_pad == 0:
        return x, (h, w)
    pads = [(0, 0)] * x.ndim
    pads[h_axis] = (0, h_pad)
    pads[w_axis] = (0, w_pad)
    return _pad(x, pads, mode), (h, w)


def _pad(x: torch.Tensor, pads, mode: str) -> torch.Tensor:
    """numpy-style per-axis ``pads`` for ``"constant"`` (zeros) or
    ``"edge"`` (replicate) mode."""
    if mode == "constant":
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        return F.pad(x, flat)
    if mode != "edge":
        raise ValueError(f"unsupported pad mode {mode!r}")
    for axis, (lo, hi) in enumerate(pads):
        if lo or hi:
            n = x.shape[axis]
            idx = torch.arange(-lo, n + hi, device=x.device).clamp_(0, n - 1)
            x = x.index_select(axis, idx)
    return x


class InputPadder:
    """Pads (B, H, W, C) images so H, W are divisible by ``divis_by``.

    mode="sintel": centered pad; otherwise width centered, height padded at
    the bottom -- exactly the reference's two modes.  Uses replicate (edge)
    padding like the reference's ``F.pad(mode='replicate')``.
    """

    def __init__(self, dims, mode: str = "sintel", divis_by: int = 8):
        self.ht, self.wd = int(dims[1]), int(dims[2])
        pad_ht = (((self.ht // divis_by) + 1) * divis_by - self.ht) % divis_by
        pad_wd = (((self.wd // divis_by) + 1) * divis_by - self.wd) % divis_by
        if mode == "sintel":
            # [left, right, top, bottom]
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2,
                         pad_ht // 2, pad_ht - pad_ht // 2]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    @property
    def padded_shape(self):
        return (self.ht + self._pad[2] + self._pad[3],
                self.wd + self._pad[0] + self._pad[1])

    def pad(self, *inputs):
        out = []
        for x in inputs:
            if x.ndim != 4:
                raise ValueError(f"expected (B, H, W, C), got {tuple(x.shape)}")
            pads = [(0, 0), (self._pad[2], self._pad[3]),
                    (self._pad[0], self._pad[1]), (0, 0)]
            out.append(_pad(x, pads, "edge"))
        return out

    def unpad(self, x):
        if x.ndim != 4:
            raise ValueError(f"expected (B, H, W, C), got {tuple(x.shape)}")
        ht, wd = x.shape[1], x.shape[2]
        c = [self._pad[2], ht - self._pad[3], self._pad[0], wd - self._pad[1]]
        return x[:, c[0]:c[1], c[2]:c[3], :]
