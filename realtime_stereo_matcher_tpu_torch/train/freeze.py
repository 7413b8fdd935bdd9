"""BatchNorm freezing (port of ``frozen_bn_apply`` from
``realtime_stereo_matcher_tpu/train/freeze.py``; reference
train_stereo.py:121-124, ``freeze_bn``).

Every BatchNorm runs in eval mode -- it normalizes with its running
statistics and updates none of them -- while the rest of the network keeps
training: the model stays in train mode, so a model that returns all its
supervision heads in training still does.  The JAX package injects
``use_running_average=True`` into every BatchNorm call with a Flax method
interceptor; in torch that is the modules' own eval flag, set for the
duration of a forward by :func:`frozen_bn`.  The trainer wires it through
``train.freeze_bn: true``.
"""

from __future__ import annotations

import contextlib

from torch import nn


@contextlib.contextmanager
def frozen_bn(model: nn.Module):
    """Put every BatchNorm of ``model`` in eval mode for the block, and
    give each its own mode back afterwards."""
    bns = [m for m in model.modules()
           if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    modes = [m.training for m in bns]
    for m in bns:
        m.eval()
    try:
        yield model
    finally:
        for m, mode in zip(bns, modes):
            m.train(mode)
