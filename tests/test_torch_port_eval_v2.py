"""The trained MobileStereoNetV2 (step 44000) in the port, on the CPU.

* ``realtime_stereo_matcher_tpu_torch/weights/synth_stereo_net_v2-44000.pt``
  equals, tensor for tensor, a fresh ``from_jax_variables`` conversion of
  the committed orbax checkpoint, restored read-only by the JAX package;
* on all 40 held-out synthetic scenes the port's plain float32
  ``validate_synthetic``, run by the runner the ``evaluate`` entry point
  builds with ``device="cpu"``, equals the JAX package's (Flax, float32) in
  EPE within 1e-4 px and D1 within 0.01 points, and both equal
  ``weights/held_out.json`` within the same bounds.  The check compares
  metrics, not pixels: the port's scenes differ from the JAX package's
  cv2-made ones by one level on a few pixels.  On the JAX package's own
  first three scenes, the two predictions differ by under 1e-2 px per
  pixel (the trained v3 by up to 3.4e-4 px on one scene).

The checks are shared with tests/test_torch_port_eval_v3.py; the two files
run side by side under xdist's ``loadfile``.
"""

import pytest

from test_torch_port_eval import (
    restore_trained,
    trained_held_out_check,
    trained_weights_check,
)


@pytest.fixture(scope="module")
def restored():
    return restore_trained("v2")


def test_committed_v2_weights_equal_a_fresh_conversion(restored):
    trained_weights_check("v2", restored)


def test_trained_v2_held_out_metrics_match_jax(restored):
    trained_held_out_check("v2", restored)
