"""The port's train-start init of MobileStereoNetV4 against the JAX
package's, on the CPU: per tensor, mean and standard deviation within
sampling error (``init_matches_jax``,
tests/test_torch_port_dispnetc_train.py).

The Conv3d reducer draws N(0, sqrt(2 / (out x kd x 3 x 3))) (its
constructor's init, the fan-out formula) with zero biases, which the JAX
package folds away; the other convs are kaiming-normal fan-out, the
hourglass transposed convs and the one remaining conv bias keep torch's
default, BatchNorm is ones / zeros.
"""

import torch

from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.train.init import reference_initialize
from test_torch_port_dispnetc_train import init_matches_jax, jax_initialized
from test_torch_port_v4_model import V4, one_torch_thread  # noqa: F401


def test_reference_initialize_matches_jax_in_distribution():
    port = init_matches_jax(V4, jax_initialized(V4))
    for i, n in ((0, 16 * 8 * 9), (3, 32 * 4 * 9), (6, 16 * 2 * 9)):
        conv = port.conv3d[i]
        assert not conv.bias.any()
        std = float(conv.weight.std())
        assert abs(std / (2.0 / n) ** 0.5 - 1) < 0.15, (i, std)
    # torch's default on the hourglass transposed convs: uniform
    convt = port.encoder_decoder1.conv5[0]
    bound = 1.0 / convt.weight[0].numel() ** 0.5
    assert float(convt.weight.abs().max()) <= bound


def test_reference_initialize_is_seeded():
    a, b = (build_model(V4, device="cpu") for _ in range(2))
    reference_initialize(a, torch.Generator().manual_seed(5))
    reference_initialize(b, torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                b.state_dict().values()))
