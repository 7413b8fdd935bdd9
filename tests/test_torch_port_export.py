"""The port's export (``torch.export``) and profiler against the plain
forward and the JAX package, on the CPU.

* v1 (the repo's config, seeded weights) exported at 64 x 96, saved,
  loaded and run: within rtol 1e-4 / atol 1e-2 of the plain eval forward's
  last map (the JAX package's tolerance, tests/test_export_profiler.py);
  v2, v3, V4 and MobileDispNetC the same, ``slow``-marked as there; the
  metadata file names the shape, dtype and inputs;
* ``aot_compile(device="cpu")`` serves the same map and refuses another
  shape or dtype;
* ``count_parameters`` equals the JAX package's count of the same model's
  ``params`` for v1, v2, v3 and MobileDispNetC; V4 has the 64 Conv3d biases
  more that the JAX package folds into its running means;
* ``cost_analysis`` of an (M, K) x (K, N) product is 2 M N K FLOPs exactly;
  ``get_model_capacity`` prints the GFLOPs line; ``trace`` writes a Chrome
  trace naming the convolutions.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_stereo_matcher_tpu.models import build_model as jax_build_model
from realtime_stereo_matcher_tpu.utils.profiler import (
    count_parameters as jax_count_parameters,
)
from realtime_stereo_matcher_tpu_torch.export import (
    aot_compile,
    export_stereo_model,
    load_exported,
    make_serving_fn,
)
from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.utils.profiler import (
    cost_analysis,
    count_parameters,
    get_model_capacity,
    trace,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = {"v1": "stereo_net_config.json", "v2": "stereo_net_config_v2.json",
           "v3": "stereo_net_config_v3.json", "v4": "stereo_net_config_v4.json",
           "dispnetc": "disp_net_c_config.json"}
# the JAX test's small shapes of the models it exports slow-marked
SMALL = {"v4": {"max_disp": 32, "volume_size": 8, "hg_size": 8},
         "dispnetc": {"max_disp": 32}}
HW = (64, 96)


def model_config(name: str, small: bool = False) -> dict:
    config = json.loads((ROOT / "configure" / CONFIGS[name]).read_text())
    config = config["model"]
    if small and name in SMALL:
        config = {"type": config["type"], "parameters": SMALL[name]}
    return config


def frames(seed: int = 0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.uniform(0, 255, (1, *HW, 3))
                                  .astype(np.float32)) for _ in range(2))


def _roundtrip(name, tmp_path):
    model = build_model(model_config(name, small=True), device="cpu")
    left, right = frames()
    with torch.no_grad():
        want = model(left, right)[-1]
    path = export_stereo_model(model, image_hw=HW,
                               output_file=tmp_path / f"{name}.pt2")
    meta = json.loads(path.with_suffix(".pt2.json").read_text())
    assert meta["input_shape"] == [1, *HW, 3] and meta["dtype"] == "float32"
    assert meta["inputs"] == ["left", "right"]
    with torch.no_grad():
        got = load_exported(path).module()(left, right)
    assert got.shape == want.shape == (1, *HW, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-2)


def test_export_roundtrip(tmp_path):
    _roundtrip("v1", tmp_path)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["v2", "v3", "v4", "dispnetc"])
def test_export_roundtrip_all_models(tmp_path, name):
    _roundtrip(name, tmp_path)


def test_aot_compile_serves_one_shape():
    model = build_model({"type": "MobileStereoNet",
                         "parameters": {"hidden_dim": 8, "max_disp": 64}},
                        device="cpu")
    left, right = frames(1)
    compiled = aot_compile(model, image_hw=HW, device="cpu")
    with torch.no_grad():
        want = make_serving_fn(model)(left, right)
    np.testing.assert_allclose(compiled(left, right).numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-2)
    with pytest.raises(ValueError, match="compiled for"):
        compiled(left[:, :32], right[:, :32])
    with pytest.raises(ValueError, match="compiled for"):
        compiled(left.double(), right.double())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_count_parameters_is_the_jax_packages(name):
    config = model_config(name)
    got = count_parameters(build_model(config, device="cpu"))
    flax = jax_build_model(config)
    img = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k: flax.init(k, img, img, train=False),
                            jax.random.PRNGKey(0))
    want = jax_count_parameters(shapes["params"])
    # V4: the reference's Conv3d biases (16 + 32 + 16), folded in JAX
    assert got == want + (64 if name == "v4" else 0)


def test_cost_analysis_of_a_product():
    m, k, n = 128, 256, 64
    cost = cost_analysis(torch.matmul, torch.ones(m, k), torch.ones(k, n))
    assert cost == {"flops": 2.0 * m * n * k}


def test_model_capacity(capsys):
    model = build_model(model_config("v1"), device="cpu")
    flops, params = get_model_capacity(model, *frames())
    assert params == count_parameters(model)
    assert flops > 1e8  # conv-heavy forward at 64 x 96
    assert "GFLOPs" in capsys.readouterr().out


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(1, 4, 16, 16)
    w = torch.randn(8, 4, 3, 3)
    with trace(str(tmp_path)):
        torch.nn.functional.conv2d(x, w, padding=1)
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
