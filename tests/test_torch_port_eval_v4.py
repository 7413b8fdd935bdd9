"""The trained MobileStereoNetV4 (step 20001) in the port, on the CPU.

* ``realtime_stereo_matcher_tpu_torch/weights/synth_stereo_net_v4-20001.pt``
  equals, tensor for tensor, a fresh ``from_jax_variables`` conversion of
  the committed orbax checkpoint, restored read-only by the JAX package;
* ``weights/held_out.json`` names that checkpoint and its config;
* on the JAX package's own first three held-out synthetic scenes (320 x
  448, padded to 320 x 448), the port's plain float32 runner, the one the
  ``evaluate`` entry point builds with ``device="cpu"``, and the JAX
  package's (Flax, float32) give final predictions within 1e-2 px per
  pixel.  A Flax V4 forward takes ~2.7 s a scene on this CPU, so the
  40-scene held-out EPE / D1 against ``held_out.json`` is checked on the
  card (``chip_smoke.py``, phase "v4").
"""

import json

import pytest

from test_torch_port_eval import (
    HELD_OUT,
    TRAINED,
    restore_trained,
    trained_pixels_check,
    trained_weights_check,
)
from test_torch_port_v4_model import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def restored():
    return restore_trained("v4")


def test_committed_v4_weights_equal_a_fresh_conversion(restored):
    trained_weights_check("v4", restored)


def test_trained_v4_matches_jax_on_held_out_scenes(restored):
    held_out = json.loads(HELD_OUT.read_text())["v4"]
    assert {k: held_out[k] for k in TRAINED["v4"]} == TRAINED["v4"]
    trained_pixels_check("v4", restored, 3)
