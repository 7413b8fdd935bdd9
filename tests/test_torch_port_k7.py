"""K7, the stride-2 training conv ``conv3x3_s2``, against JAX, on the CPU.

The JAX package's ``kernels/train_conv.py`` ``conv3x3_s2`` is a custom-VJP
stride-2 3x3 conv (torch padding 1): its forward is XLA, its backward runs
the zero-upsampled cotangent through the flat stride-1 kernels.  The port's
``conv3x3_s2`` is a ``torch.autograd.Function`` with the same design (the
forward plain ``F.conv2d``, dx on K1, dW on K4; on CPU tensors the kernels'
plain versions).  Held here, at 32 -> 32 on (2, 16, 32), the shape of the
JAX package's tests/test_train_conv.py:

* output, dx and dW against JAX ``conv3x3_s2`` and ``jax.grad`` of it
  (Pallas in interpret mode), within 1e-5 of the output's scale (float32
  sums of <= 288 products in another order);
* the same against ``lax.conv_general_dilated`` and its ``jax.grad``;
* ``torch.autograd.gradcheck`` in float64 (its fast mode: 9,216 weights
  make the full Jacobian slow);
* other channel pairs and odd sizes raise, naming ROADMAP.md.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_stereo_matcher_tpu.kernels.train_conv import (
    conv3x3_s2 as jax_conv3x3_s2,
)
from realtime_stereo_matcher_tpu_torch.kernels import train_conv
from realtime_stereo_matcher_tpu_torch.kernels.train_conv import conv3x3_s2

SHAPE = (2, 16, 32)


def _lax_s2(x, w):
    return jax.lax.conv_general_dilated(
        x, w, (2, 2), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)


def _operands(rng):
    x = rng.standard_normal((*SHAPE, 32)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 32, 32)) * 0.2).astype(np.float32)
    cot = rng.standard_normal((SHAPE[0], SHAPE[1] // 2, SHAPE[2] // 2, 32)
                              ).astype(np.float32)
    return x, w, cot


def _port(x, w, cot):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = conv3x3_s2(xt, wt)
    y.backward(torch.from_numpy(cot))
    return y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


def _assert_scaled(got, want, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                               err_msg=what)


@pytest.mark.parametrize("oracle", ["jax_conv3x3_s2", "lax"])
def test_conv3x3_s2_matches_jax(rng, oracle):
    x, w, cot = _operands(rng)
    fn = jax_conv3x3_s2 if oracle == "jax_conv3x3_s2" else _lax_s2
    want_y, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(cot))
    y, dx, dw = _port(x, w, cot)
    assert y.shape == (SHAPE[0], SHAPE[1] // 2, SHAPE[2] // 2, 32)
    for got, want, what in ((y, want_y, "y"), (dx, want_dx, "dx"),
                            (dw, want_dw, "dW")):
        _assert_scaled(got, want, what)


def test_conv3x3_s2_backward_runs_the_training_kernels(rng, monkeypatch):
    """dx goes through K1 (stride 1, dilation 1, 32 -> 32) and dW through
    K4 on the zero-upsampled cotangent; the forward calls neither."""
    calls = []
    k1, k4 = train_conv.fused_conv3x3, train_conv.dw_reduce

    def spy_k1(x, w, *args, **kwargs):
        calls.append(("K1", tuple(x.shape), kwargs.get("dilation")))
        return k1(x, w, *args, **kwargs)

    def spy_k4(x, g, dilation=1):
        calls.append(("K4", tuple(g.shape), dilation))
        assert torch.equal(g[:, 1::2], torch.zeros_like(g[:, 1::2]))
        assert torch.equal(g[:, :, 1::2], torch.zeros_like(g[:, :, 1::2]))
        return k4(x, g, dilation)

    monkeypatch.setattr(train_conv, "fused_conv3x3", spy_k1)
    monkeypatch.setattr(train_conv, "dw_reduce", spy_k4)
    x, w, cot = _operands(rng)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = conv3x3_s2(xt, wt)
    assert calls == []
    y.backward(torch.from_numpy(cot))
    assert calls == [("K1", (*SHAPE, 32), 1), ("K4", (*SHAPE, 32), 1)]


def test_conv3x3_s2_passes_gradcheck():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 6, 8, 32, generator=gen,
                    dtype=torch.float64).requires_grad_()
    w = (torch.randn(3, 3, 32, 32, generator=gen, dtype=torch.float64)
         * 0.2).requires_grad_()
    assert torch.autograd.gradcheck(conv3x3_s2, (x, w), fast_mode=True)


@pytest.mark.parametrize("x_shape,w_shape", [
    ((2, 16, 32, 3), (3, 3, 3, 32)),      # the encoder's 3 -> 32 first conv
    ((2, 16, 32, 32), (3, 3, 32, 4)),     # another output width
    ((2, 15, 32, 32), (3, 3, 32, 32)),    # odd H
    ((2, 16, 33, 32), (3, 3, 32, 32)),    # odd W
])
def test_conv3x3_s2_raises_on_other_shapes(x_shape, w_shape):
    with pytest.raises(ValueError, match="ROADMAP.md"):
        conv3x3_s2(torch.zeros(x_shape), torch.zeros(w_shape))
