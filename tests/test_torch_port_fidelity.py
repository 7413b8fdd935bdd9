"""The fidelity of the port's training steps, on the CPU.

Slow tier: the port's bf16 kernel train step against the JAX package's own
bf16 kernel train step.

Weights: a Flax v1, v2 or v3 from the JAX package's train-start init
(``train/init.py``), BatchNorm running stats randomised, moved into the
port with ``from_jax_variables``; batch 2 at 32 x 64, the shape and seeds
of tests/test_torch_port_v2v3_train.py.  The oracle is Flax's float32
gradient of the SequenceLoss (``model.apply(..., train=True)``).  Both
packages then take the first step in bfloat16 on the kernel path: the
JAX package's ``models/fast_train.fast_train_forward`` of the model built
with ``dtype=bfloat16`` (its Pallas kernels in interpret mode, as its own
tests run them) and the port's ``fast_train_forward(..., dtype=
torch.bfloat16)`` (the kernels' plain versions on CPU tensors).

For each encoder leaf whose Flax gradient norm is at least 1e-3 (the rule
of tests/test_torch_port_v2v3_train.py), the relative L2 distance of each
package's bf16 gradient from the Flax float32 gradient.  Held: the port's
distance over all those leaves together at most 1.5 x the JAX package's,
and no single leaf of the port's over 3 x the JAX package's.  The
distances are printed leaf by leaf (``-s``).

Tier 1: the two backwards that made two runs of one float32 v2 kernel step
on the card differ (``tools/fidelity_probe.py nondeterminism``) are gone
from the step.  The 2x bilinear disparity upsample (``ops.sampling.
_Upsample2x``) gives ``F.interpolate``'s values bit for bit and its
gradient within 1e-12 (float64) and 1e-6 (float32, relative) without
``upsample_bilinear2d_backward``, whose CUDA form adds with atomics; the
encoder's plain convs (``fast_train._PlainConv``) give ``F.conv2d``'s
values and, on the CPU, its gradients bit for bit; the float32 v2 step's
backward graph holds neither torch node.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_stereo_matcher_tpu.models import build_model as jax_build_model
from realtime_stereo_matcher_tpu.models.fast_train import (
    fast_train_forward as jax_fast_train_forward,
)
from realtime_stereo_matcher_tpu.train.init import (
    reference_initialize as jax_reference_initialize,
)
from realtime_stereo_matcher_tpu.train.loss import (
    sequence_loss as jax_sequence_loss,
)
from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.models.convert import from_jax_variables
from realtime_stereo_matcher_tpu_torch.models.fast_train import (
    _conv2d_nhwc,
    fast_train_forward,
)
from realtime_stereo_matcher_tpu_torch.ops import resize_bilinear
from realtime_stereo_matcher_tpu_torch.parallel import halo
from realtime_stereo_matcher_tpu_torch.train.loss import sequence_loss

VARIANTS = {"v1": "MobileStereoNet", "v2": "MobileStereoNetV2",
            "v3": "MobileStereoNetV3"}
B, H, W = 2, 32, 64
# leaves counted: a Flax float32 gradient norm of at least this
MIN_NORM = 1e-3
# the port's encoder distance against the JAX package's: all leaves
# together, and each leaf
ALL_RATIO, LEAF_RATIO = 1.5, 3.0


def _batch_np(seed=7):
    gen = np.random.default_rng(seed)
    left = gen.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    right = np.roll(left, -3, axis=2) + gen.normal(0, 4, left.shape)
    right = np.clip(right, 0, 255).astype(np.float32)
    flow = -gen.uniform(0, 40, (B, H, W, 1)).astype(np.float32)
    valid = (gen.uniform(size=(B, H, W)) > 0.2).astype(np.float32)
    return left, right, flow, valid


def _variables(model, variant):
    dummy = jnp.zeros((1, H, W, 3), jnp.float32)
    variables = jax.jit(lambda k: model.init(k, dummy, dummy, train=True))(
        jax.random.PRNGKey(0))
    variables = jax_reference_initialize(dict(variables),
                                         jax.random.PRNGKey(1),
                                         model_type=VARIANTS[variant])
    gen = np.random.default_rng(3)

    def randomize(path, leaf):
        name, shape = str(path[-1].key), np.shape(leaf)
        if name == "mean":
            return gen.normal(0, 0.3, shape).astype(np.float32)
        if name == "var":
            return gen.uniform(0.5, 1.5, shape).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(randomize, variables)


def _jax_grads(variant, variables, batch) -> tuple[dict, dict]:
    """Flax's float32 gradient and the JAX bf16 kernel step's, by the
    port's names."""
    spec = {"type": VARIANTS[variant], "parameters": {}}
    f32 = jax_build_model(spec)
    bf16 = jax_build_model(spec, dtype=jnp.bfloat16)
    left, right, flow, valid = (jnp.asarray(a) for a in batch)
    stats = variables["batch_stats"]

    def flax_loss(p):
        preds, _ = f32.apply({"params": p, "batch_stats": stats}, left, right,
                             train=True, mutable=["batch_stats"])
        return jax_sequence_loss(preds, flow, valid)

    def kernel_loss(p):
        preds, _ = jax_fast_train_forward(bf16, p, stats, left, right,
                                          train=True)
        return jax_sequence_loss(preds, flow, valid)

    return tuple(
        from_jax_variables({"params": jax.grad(fn)(variables["params"])})
        for fn in (jax.jit(flax_loss), kernel_loss))


def _port_grads(variant, variables, batch) -> dict:
    model = build_model({"type": VARIANTS[variant], "parameters": {}},
                        device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    model.train()
    left, right, flow, valid = (torch.from_numpy(a) for a in batch)
    preds, _ = fast_train_forward(model, left, right, dtype=torch.bfloat16)
    sequence_loss(preds, flow, valid).backward()
    return {k: p.grad.detach().float() for k, p in model.named_parameters()}


def _distances(grads: dict, want: dict, keys) -> tuple[dict, float]:
    per = {k: float((grads[k].float() - want[k]).norm() / want[k].norm())
           for k in keys}
    num = sum(float((grads[k].float() - want[k]).norm()) ** 2 for k in keys)
    den = sum(float(want[k].norm()) ** 2 for k in keys)
    return per, (num / den) ** 0.5


@pytest.mark.slow  # the JAX kernel path in interpret mode
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bf16_encoder_gradients_no_farther_than_the_jax_packages(variant):
    spec = {"type": VARIANTS[variant], "parameters": {}}
    variables = _variables(jax_build_model(spec), variant)
    batch = _batch_np()
    flax, jax_bf16 = _jax_grads(variant, variables, batch)
    port = _port_grads(variant, variables, batch)
    keys = [k for k in flax if k.startswith("feature_extractor.")
            and float(flax[k].norm()) >= MIN_NORM]
    assert keys, variant
    jax_per, jax_all = _distances(jax_bf16, flax, keys)
    port_per, port_all = _distances(port, flax, keys)
    print(f"\n{variant} bf16 encoder gradients, relative L2 from Flax "
          f"float32 ({len(keys)} leaves; JAX / port / ratio):")
    for k in keys:
        print(f"  {k}: {jax_per[k]:.4f} / {port_per[k]:.4f} / "
              f"{port_per[k] / jax_per[k]:.2f}")
    print(f"  all: {jax_all:.4f} / {port_all:.4f} / "
          f"{port_all / jax_all:.2f}")
    assert port_all <= ALL_RATIO * jax_all, (variant, port_all, jax_all)
    over = {k: (port_per[k], jax_per[k]) for k in keys
            if port_per[k] > LEAF_RATIO * jax_per[k]}
    assert not over, (variant, over)


# ---------------------------------------------------------------------------
# the float32 step's backward sums in a fixed order
# ---------------------------------------------------------------------------


def _graph_names(t: torch.Tensor) -> set:
    names, seen, todo = set(), set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(node.name())
        todo.extend(n for n, _ in node.next_functions)
    return names


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 1, 1, 1), (2, 1, 6, 2),
                                   (3, 8, 4, 1)])
def test_disparity_upsample_has_a_fixed_order_backward(shape):
    gen = np.random.default_rng(11)
    out_hw = (2 * shape[1], 2 * shape[2])
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
        x = torch.from_numpy(gen.normal(size=shape)).to(dtype)
        g = torch.from_numpy(gen.normal(size=(shape[0], *out_hw,
                                              shape[3]))).to(dtype)
        xg = x.clone().requires_grad_()
        y = resize_bilinear(xg, out_hw)
        names = _graph_names(y)
        assert "_Upsample2xBackward" in names
        assert not any(n.startswith("UpsampleBilinear2D") for n in names)
        (got,) = torch.autograd.grad(y, xg, g)
        xr = x.permute(0, 3, 1, 2).clone().requires_grad_()
        want_y = torch.nn.functional.interpolate(
            xr, size=out_hw, mode="bilinear", align_corners=False)
        (want,) = torch.autograd.grad(want_y, xr, g.permute(0, 3, 1, 2))
        assert torch.equal(y.detach(), resize_bilinear(x, out_hw))
        err = float((got - want.permute(0, 2, 3, 1)).abs().max())
        assert err <= tol * float(want.abs().max()), (dtype, err)
        # the refinements' upsample: halo.resize_rows on one rank
        y1 = halo.resize_rows(xg, out_hw, halo.ONE, mode="bilinear")
        assert torch.equal(y1, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
def test_plain_conv_is_f_conv2d_with_a_deterministic_backward(dtype, stride):
    gen = torch.Generator().manual_seed(12)
    x = torch.randn((2, 9, 11, 5), generator=gen).to(dtype).requires_grad_()
    w = torch.randn((7, 5, 3, 3), generator=gen).to(dtype).requires_grad_()
    y = _conv2d_nhwc(x, w, stride=stride)
    assert "_PlainConvBackward" in _graph_names(y)
    g = torch.randn(y.shape, generator=gen).to(dtype)
    want_y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w,
                                        stride=stride, padding=1)
    assert torch.equal(y, want_y.permute(0, 2, 3, 1))
    got = torch.autograd.grad(y, (x, w), g)
    want = torch.autograd.grad(want_y, (x, w), g.permute(0, 3, 1, 2))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    (dw,) = torch.autograd.grad(_conv2d_nhwc(x.detach(), w, stride=stride),
                                w, g)
    assert torch.equal(dw, want[1])


def test_v2_step_backward_has_no_atomic_torch_node():
    """The float32 v2 kernel step's backward graph: neither of the torch
    nodes whose CUDA backward made two runs differ."""
    model = build_model({"type": "MobileStereoNetV2", "parameters": {}},
                        device="cpu").train()
    left, right, flow, valid = (torch.from_numpy(a) for a in _batch_np())
    preds, _ = fast_train_forward(model, left, right)
    names = _graph_names(sequence_loss(preds, flow, valid))
    assert {"_Upsample2xBackward", "_PlainConvBackward"} <= names
    assert not [n for n in names if n.startswith(
        ("UpsampleBilinear2D", "ConvolutionBackward"))]
