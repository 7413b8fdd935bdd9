"""The trained MobileDispNetC (step 20001) in the port, on the CPU.

* ``realtime_stereo_matcher_tpu_torch/weights/synth_disp_net_c-20001.pt``
  equals, tensor for tensor, a fresh ``from_jax_variables`` conversion of
  the committed orbax checkpoint, restored read-only by the JAX package;
* on all 40 held-out synthetic scenes the port's plain float32
  ``validate_synthetic``, run by the runner the ``evaluate`` entry point
  builds with ``device="cpu"``, equals the JAX package's (Flax, float32) in
  EPE within 1e-4 px and D1 within 0.01 points, and both equal
  ``weights/held_out.json`` within the same bounds; on the JAX package's
  own first three scenes the two predictions differ by under 1e-2 px per
  pixel (the checks of tests/test_torch_port_eval_v2.py).
"""

import pytest

from test_torch_port_eval import (
    restore_trained,
    trained_held_out_check,
    trained_weights_check,
)
from test_torch_port_v4_model import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def restored():
    return restore_trained("dispnetc")


def test_committed_dispnetc_weights_equal_a_fresh_conversion(restored):
    trained_weights_check("dispnetc", restored)


def test_trained_dispnetc_held_out_metrics_match_jax(restored):
    trained_held_out_check("dispnetc", restored)
