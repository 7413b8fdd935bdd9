"""The port's kernel modules against JAX, on the CPU.

On a CPU tensor each kernel wrapper runs its plain PyTorch version, so these
tests hold the plain versions (the reference the CUDA kernels are checked
against on the card) and the kernel-path plans to the JAX package:

* ``fused_conv3x3_plain`` / ``fused_conv3d_plain`` against
  ``jax.lax.conv_general_dilated`` with the same epilogue;
* ``fast_cost_filter``, ``fast_encoder`` and ``fast_refine`` against Flax
  ``CostFilter3D``, ``FeatureEncoder`` and ``RefineNet`` on the same weights
  (moved over by ``from_jax_variables``).

Everything is float32.  Tolerance 1e-5 absolute for one conv (float32 sums
of <= 864 products of order-1 values, taken in another order); for a whole
stack of 5, 10 or 14 convs see ``_stack_atol``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_stereo_matcher_tpu.models import build_model as jax_build_model
from realtime_stereo_matcher_tpu.models.stereo_net import (
    CostFilter3D as JaxCostFilter3D,
    FeatureEncoder as JaxFeatureEncoder,
    RefineNet as JaxRefineNet,
)
from realtime_stereo_matcher_tpu_torch.kernels import LAUNCHES
from realtime_stereo_matcher_tpu_torch.kernels.conv3x3 import (
    fused_conv3x3,
    fused_conv3x3_plain,
)
from realtime_stereo_matcher_tpu_torch.kernels.cost_filter3d import (
    build_cost_filter_plan,
    fast_cost_filter,
    fused_conv3d,
    fused_conv3d_plain,
)
from realtime_stereo_matcher_tpu_torch.kernels.encoder import (
    build_encoder_plan,
    fast_encoder,
)
from realtime_stereo_matcher_tpu_torch.kernels.refine_stack import (
    build_refine_plan,
    fast_refine,
)
from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.models.convert import from_jax_variables

CONV_ATOL = 1e-5


def _stack_atol(want):
    """1e-4, or 5e-6 of the largest magnitude where that is larger: float32
    noise through a stack grows with its activations, which Flax's
    lecun-normal init makes large (RefineNet outputs reach ~50 px here)."""
    return max(1e-4, 5e-6 * float(np.abs(np.asarray(want)).max()))


def _jax_conv(x, w, scale, bias, *, stride, dilation, act, residual):
    nd = x.ndim - 2
    dims = ("NHWC", "HWIO", "NHWC") if nd == 2 else ("NDHWC", "DHWIO", "NDHWC")
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride,) * nd,
        [(dilation, dilation)] * nd, rhs_dilation=(dilation,) * nd,
        dimension_numbers=dims, precision=jax.lax.Precision.HIGHEST)
    y = y * scale + bias
    if act == "relu":
        y = jnp.maximum(y, 0.0)
    elif isinstance(act, float):
        y = jnp.maximum(y, 0.0) + act * jnp.minimum(y, 0.0)
    if residual is not None:
        y = y + residual
    return np.asarray(y)


def _operands(rng, x_shape, w_shape):
    x = rng.uniform(-1, 1, x_shape).astype(np.float32)
    fan_in = int(np.prod(w_shape[:-1]))
    w = rng.uniform(-1, 1, w_shape).astype(np.float32) / np.sqrt(fan_in)
    c = w_shape[-1]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.3, c).astype(np.float32)
    return x, w, scale, bias


CONV3X3_CASES = [
    # stride, dilation, c_in, c_out, act, residual
    (1, 1, 32, 32, "relu", False),
    (1, 1, 32, 32, "relu", True),
    (1, 2, 32, 32, "relu", True),
    (1, 4, 32, 32, "relu", False),
    (1, 8, 32, 32, "relu", True),
    (1, 1, 32, 32, "none", False),
    (1, 1, 4, 32, "relu", False),
    (1, 1, 32, 1, "none", False),
    (1, 2, 32, 32, 0.2, True),
    (1, 1, 3, 32, 0.2, False),   # v3 U-Net stem
    (2, 1, 3, 32, "relu", False),
    (2, 1, 32, 32, "relu", False),
]


@pytest.mark.parametrize("stride,dilation,cin,cout,act,res", CONV3X3_CASES)
@pytest.mark.parametrize("hw", [(24, 40), (19, 21)])
def test_fused_conv3x3_plain_matches_jax(rng, stride, dilation, cin, cout, act,
                                         res, hw):
    x, w, scale, bias = _operands(rng, (2, *hw, cin), (3, 3, cin, cout))
    ho, wo = (hw[0] - 1) // stride + 1, (hw[1] - 1) // stride + 1
    r = rng.uniform(-1, 1, (2, ho, wo, cout)).astype(np.float32) if res else None
    want = _jax_conv(x, w, scale, bias, stride=stride, dilation=dilation,
                     act=act, residual=r)
    t = [torch.from_numpy(a) for a in (x, w, scale, bias)]
    got = fused_conv3x3_plain(*t, stride=stride, dilation=dilation, act=act,
                              residual=None if r is None else torch.from_numpy(r))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CONV_ATOL)
    # on a CPU tensor the wrapper is the plain version and launches nothing
    before = sum(LAUNCHES.values())
    via_wrapper = fused_conv3x3(*t, stride=stride, dilation=dilation, act=act,
                                residual=None if r is None else torch.from_numpy(r))
    assert torch.equal(via_wrapper, got)
    assert sum(LAUNCHES.values()) == before


@pytest.mark.parametrize("cout,relu", [(32, True), (1, False)])
def test_fused_conv3d_plain_matches_jax(rng, cout, relu):
    x, w, scale, bias = _operands(rng, (1, 6, 8, 12, 32), (3, 3, 3, 32, cout))
    want = _jax_conv(x, w, scale, bias, stride=1, dilation=1,
                     act="relu" if relu else "none", residual=None)
    t = [torch.from_numpy(a) for a in (x, w, scale, bias)]
    got = fused_conv3d_plain(*t, relu=relu)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CONV_ATOL)
    assert torch.equal(fused_conv3d(*t, relu=relu), got)


def test_bf16_plain_rounds_before_residual():
    """bf16 epilogue order: the activation output is cast to bf16 and the
    residual added in bf16, as in the TPU kernel."""
    x = torch.zeros(1, 4, 4, 32, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 32, 32, dtype=torch.bfloat16)
    scale = torch.ones(32)
    # bf16 keeps 8 significant bits: 1 + 2^-8 + 2^-10 rounds up to 1 + 2^-7,
    # and adding 2^-8 then ties to even at 1 + 2^-6.  Summed in float32
    # first, 1 + 2^-7 + 2^-10 would round to 1 + 2^-7.
    bias = torch.full((32,), 1.0 + 2.0 ** -8 + 2.0 ** -10)
    res = torch.full((1, 4, 4, 32), 2.0 ** -8, dtype=torch.bfloat16)
    got = fused_conv3x3_plain(x, w, scale, bias, residual=res)
    assert got.dtype == torch.bfloat16
    assert torch.all(got == 1.0 + 2.0 ** -6)


def test_wrapper_refuses_other_devices():
    x = torch.empty(1, 4, 4, 32, device="meta")
    w = torch.empty(3, 3, 32, 32, device="meta")
    s = torch.empty(32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_conv3x3(x, w, s, s)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_conv3d(x[None], w[None], s, s)


@pytest.fixture(scope="module")
def v1_pair():
    """A Flax-initialised v1 with randomised BatchNorm (running stats and
    affine), and the port model carrying the same weights."""
    model = jax_build_model({"type": "MobileStereoNet", "parameters": {}})
    img = jnp.zeros((1, 16, 16, 3), jnp.float32)
    variables = jax.jit(lambda k: model.init(k, img, img, train=False))(
        jax.random.PRNGKey(0))
    gen = np.random.default_rng(7)

    def randomize(path, leaf):
        name, shape = str(path[-1].key), np.shape(leaf)
        in_bn = str(path[-2].key) == "BatchNorm_0"
        if name == "mean":
            return gen.normal(0, 0.3, shape).astype(np.float32)
        if name in ("var", "scale"):
            return gen.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "bias" and in_bn:
            return gen.normal(0, 0.1, shape).astype(np.float32)
        return np.asarray(leaf)

    variables = jax.tree_util.tree_map_with_path(randomize, variables)
    port = build_model({"type": "MobileStereoNet", "parameters": {}},
                       device="cpu")
    port.load_state_dict(from_jax_variables(variables))
    return variables, port


def _sub(variables, name):
    return {"params": variables["params"][name],
            "batch_stats": variables["batch_stats"][name]}


def test_fast_cost_filter_matches_flax(rng, v1_pair):
    variables, port = v1_pair
    vol = rng.normal(size=(1, 8, 8, 16, 32)).astype(np.float32)
    want = JaxCostFilter3D(32).apply(_sub(variables, "CostFilter3D_0"),
                                     jnp.asarray(vol), False)
    plan = build_cost_filter_plan(port.cost_filter, dtype=torch.float32)
    assert len(plan) == 5
    got = fast_cost_filter(torch.from_numpy(vol), plan)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=_stack_atol(want))


def test_fast_encoder_matches_flax(rng, v1_pair):
    variables, port = v1_pair
    img = rng.uniform(-1, 1, (1, 64, 128, 3)).astype(np.float32)
    want = JaxFeatureEncoder(32, 3).apply(_sub(variables, "FeatureEncoder_0"),
                                          jnp.asarray(img), False)
    plan = build_encoder_plan(port.feature_extractor, dtype=torch.float32)
    assert len(plan.stages) == 3
    got = fast_encoder(torch.from_numpy(img), plan)
    assert got.shape == (1, 8, 16, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=_stack_atol(want))


@pytest.mark.parametrize("level", [0, 2])
def test_fast_refine_matches_flax(rng, v1_pair, level):
    variables, port = v1_pair
    h, w = 8 << level, 16 << level
    disp = rng.uniform(0, 20, (1, h, w, 1)).astype(np.float32)
    guide = rng.uniform(-1, 1, (1, 64, 128, 3)).astype(np.float32)
    want = np.asarray(JaxRefineNet(32).apply(
        _sub(variables, f"RefineNet_{level}"), jnp.asarray(disp),
        jnp.asarray(guide), train=False))
    plan = build_refine_plan(port.refine_layer[level], dtype=torch.float32)
    assert len(plan.specs) == 14
    got = fast_refine(torch.from_numpy(disp), torch.from_numpy(guide), plan)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_stack_atol(want))
