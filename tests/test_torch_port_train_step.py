"""The port's loss, optimizer, init, data and trainer against the JAX
package, on the CPU.

* ``sequence_loss`` / ``flow_map_metrics`` against the JAX package's within
  1e-6 relative (both reduce in float32);
* the OneCycle schedule against ``optax.linear_onecycle_schedule`` (through
  the JAX package's ``onecycle_schedule``) at step 0, across the warm-up, at
  its boundaries and past its end, within 1e-6 relative;
* clip + AdamW + schedule against the JAX package's optax chain over three
  steps (one with the gradient norm under the clip), parameters within 1e-6
  of each leaf's largest magnitude (the two round the AdamW arithmetic
  differently, measured <= 4 float32 ulp);
* ``make_scene`` (numpy only) against the JAX package's ``make_scene`` with
  cv2 on: disparity and validity exact, images within 1 LSB on at most 1e-3
  of the pixels (measured <= 1.1e-4, float32 sums in another order);
* the train-start init in distribution against the JAX package's;
* ``load_config`` against the JAX package's on every reference config;
* ``train()`` for 2 steps at 32 x 64 on the kernel path, a checkpoint round
  trip, and ``fast_kernels="on"`` refusing a model the kernels do not serve.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import realtime_stereo_matcher_tpu.data.synthetic as jax_synthetic
from realtime_stereo_matcher_tpu.config import load_config as jax_load_config
from realtime_stereo_matcher_tpu.models import build_model as jax_build_model
from realtime_stereo_matcher_tpu.train.init import (
    reference_initialize as jax_reference_initialize,
)
from realtime_stereo_matcher_tpu.train.loss import (
    flow_map_metrics as jax_flow_map_metrics,
    sequence_loss as jax_sequence_loss,
)
from realtime_stereo_matcher_tpu.train.optim import (
    make_optimizer as jax_make_optimizer,
)
from realtime_stereo_matcher_tpu_torch.config import load_config
from realtime_stereo_matcher_tpu_torch.data.synthetic import (
    SyntheticBatches,
    make_scene,
)
from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.models.convert import from_jax_variables
from realtime_stereo_matcher_tpu_torch.train.init import reference_initialize
from realtime_stereo_matcher_tpu_torch.train.loss import (
    flow_map_metrics,
    sequence_loss,
)
from realtime_stereo_matcher_tpu_torch.train.optim import (
    make_optimizer,
    onecycle_schedule,
)
from realtime_stereo_matcher_tpu_torch.train.trainer import (
    create_train_state,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    train,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
V1 = {"type": "MobileStereoNet", "parameters": {}}


def _loss_inputs(rng, b=2, h=16, w=24):
    flow = -rng.uniform(0, 30, (b, h, w, 1)).astype(np.float32)
    flow[0, 0, 0, 0] = -800.0  # beyond max_flow_magnitude: masked out
    valid = (rng.uniform(size=(b, h, w)) > 0.3).astype(np.float32)
    preds = [-rng.uniform(0, 30, (b, h // 2, w // 2, 1)).astype(np.float32)]
    preds += [flow + rng.normal(0, s, flow.shape).astype(np.float32)
              for s in (3.0, 0.7)]
    return preds, flow, valid


def test_sequence_loss_and_metrics_match_jax(rng):
    preds, flow, valid = _loss_inputs(rng)
    for gamma, max_flow in ((0.9, 700.0), (0.8, 20.0)):
        want = float(jax_sequence_loss([jnp.asarray(p) for p in preds],
                                       jnp.asarray(flow), jnp.asarray(valid),
                                       loss_gamma=gamma,
                                       max_flow_magnitude=max_flow))
        got = float(sequence_loss([torch.from_numpy(p) for p in preds],
                                  torch.from_numpy(flow),
                                  torch.from_numpy(valid), loss_gamma=gamma,
                                  max_flow_magnitude=max_flow))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    want = jax_flow_map_metrics(jnp.asarray(flow), jnp.asarray(preds[-1]),
                                jnp.asarray(valid))
    got = flow_map_metrics(torch.from_numpy(flow), torch.from_numpy(preds[-1]),
                           torch.from_numpy(valid))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("num_steps", [10, 100000])
def test_onecycle_schedule_matches_optax(num_steps):
    _, want = jax_make_optimizer(2e-4, num_steps, 1e-5)
    got = onecycle_schedule(2e-4, num_steps)
    total = num_steps + 100
    peak = int(0.01 * total)
    steps = sorted({0, 1, 2, peak - 1, peak, peak + 1, total // 2, total - 1,
                    total, total + 1, 2 * total}
                   | set(range(0, peak + 2, max(1, peak // 7))))
    for s in steps:
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6,
                                   err_msg=f"step {s}")
    assert got(peak) == pytest.approx(2e-4)


def test_clip_adamw_step_matches_optax_chain(rng):
    shapes = {"a": (3, 3, 4, 8), "b": (8,), "c": (5, 7)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    lr, n_steps, wd = 5e-2, 20, 1e-2
    tx, _ = jax_make_optimizer(lr, n_steps, wd)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)

    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    port_tx, _ = make_optimizer(tp.values(), lr, n_steps, wd)
    for scale in (3.0, 0.05, 2.0):  # global norms above, below, above 1
        grads = {k: (rng.normal(0, 1, s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, v in grads.items():
            tp[k].grad = torch.from_numpy(v)
        port_tx.step()
        for k in shapes:
            want = np.asarray(jp[k])
            np.testing.assert_allclose(
                tp[k].detach().numpy(), want, rtol=1e-6,
                atol=1e-6 * float(np.abs(want).max()), err_msg=k)


@pytest.mark.parametrize("seed,hw,max_disp", [(0, (48, 64), 16.0),
                                              (5, (40, 72), 24.0),
                                              (10 ** 6, (240, 320), 96.0)])
def test_make_scene_matches_jax_numpy_path(seed, hw, max_disp):
    """The port's numpy scene against the JAX package's scene made with cv2
    (its resize and remap), as the JAX package makes it wherever cv2 is
    installed."""
    pytest.importorskip("cv2", reason="the JAX package's cv2 path needs cv2")
    assert jax_synthetic.cv2 is not None
    want = jax_synthetic.make_scene(seed, *hw, max_disp=max_disp)
    got = make_scene(seed, *hw, max_disp=max_disp)
    for name, g, w in zip(("left", "right", "disp", "valid"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    for g, w in zip(got[:2], want[:2]):
        diff = np.abs(g.astype(np.int16) - w.astype(np.int16))
        assert diff.max() <= 1
        assert (diff > 0).mean() <= 1e-3, float((diff > 0).mean())


def test_synthetic_batches_contract():
    data = SyntheticBatches(2, (24, 40), n_batches=2, seed0=3, max_disp=8.0)
    batches = list(data)
    assert len(batches) == len(data) == 2
    names, img1, img2, flow, valid = batches[1]
    assert names == ["synthetic://5", "synthetic://6"]
    assert img1.shape == img2.shape == (2, 24, 40, 3)
    assert flow.shape == (2, 24, 40, 1) and valid.shape == (2, 24, 40)
    assert img1.dtype == flow.dtype == valid.dtype == torch.float32
    disp = make_scene(5, 24, 40, max_disp=8.0)[2]
    np.testing.assert_array_equal(flow[0, ..., 0].numpy(), -disp)
    assert [n for n, *_ in data] == [b[0] for b in batches]  # re-iterable


def test_reference_initialize_matches_jax_in_distribution():
    # a shallower v1 (every layer kind, fewer of them): the JAX init's
    # sibling lookup is quadratic in the number of leaves
    small = {"type": "MobileStereoNet",
             "parameters": {"down_factor": 2, "refine_dilates": [1, 8]}}
    model = jax_build_model(small)
    img = jnp.zeros((1, 16, 16, 3), jnp.float32)
    variables = jax.jit(lambda k: model.init(k, img, img, train=True))(
        jax.random.PRNGKey(0))
    want = from_jax_variables(jax_reference_initialize(
        dict(variables), jax.random.PRNGKey(3), model_type="MobileStereoNet"))
    port = build_model(small, device="cpu")
    with torch.no_grad():
        for m in port.modules():  # make the reset of BatchNorm visible
            if isinstance(m, torch.nn.BatchNorm2d | torch.nn.BatchNorm3d):
                m.weight.fill_(3.0)
                m.running_var.fill_(3.0)
    reference_initialize(port, torch.Generator().manual_seed(0))
    got = port.state_dict()
    bn = {f"{name}.{k}" for name, m in port.named_modules()
          if isinstance(m, torch.nn.BatchNorm2d | torch.nn.BatchNorm3d)
          for k in ("weight", "bias", "running_mean", "running_var")}
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k in bn:  # scale 1, bias 0, mean 0, var 1 on both
            assert torch.equal(g, w), k
        if k in bn or w.numel() < 256:  # BatchNorm, and the heads' biases
            continue
        ratio = float(g.std()) / float(w.std())
        assert abs(ratio - 1) < 0.15, (k, ratio)
        assert abs(float(g.mean())) < 0.2 * float(w.std()), k
        if k.startswith("cost_filter"):  # uniform: same bound
            assert float(g.abs().max()) <= float(w.abs().max()) * 1.01, k
    a = build_model(V1, device="cpu")
    b = build_model(V1, device="cpu")
    reference_initialize(a, torch.Generator().manual_seed(5))
    reference_initialize(b, torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                b.state_dict().values()))


def test_load_config_matches_jax():
    for path in sorted((ROOT / "configure").glob("*.json")):
        got, want = load_config(path), jax_load_config(path)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), path.name


def _tiny_config(tmp_path, **train_kw):
    cfg = load_config(ROOT / "configure" / "stereo_net_config.json")
    cfg.path = str(tmp_path / "exp")
    cfg.data.image_size = [32, 64]
    cfg.train.batch_size = 2
    for k, v in train_kw.items():
        setattr(cfg.train, k, v)
    return cfg


def test_train_takes_two_kernel_path_steps_on_cpu(tmp_path):
    cfg = _tiny_config(tmp_path, fast_kernels="on")
    data = SyntheticBatches(2, (32, 64), n_batches=1, max_disp=16.0)
    seen = []
    path = train(cfg, max_steps=1, data_loader=data, device="cpu",
                 on_step=lambda s, m: seen.append((s, float(m["live_loss"]))))
    assert [s for s, _ in seen] == [0, 1]
    assert all(np.isfinite(v) for _, v in seen)
    assert pathlib.Path(path).name == "480P_STEREO_NET-epoch-2.ckpt"
    ckpt = torch.load(path, weights_only=True)
    assert ckpt["step"] == 2


def test_checkpoint_round_trip(tmp_path):
    cfg = _tiny_config(tmp_path)
    data = SyntheticBatches(2, (32, 64), n_batches=2, max_disp=16.0)
    (_, img1, img2, flow, valid), batch2 = list(data)
    model, tx, _, state = create_train_state(cfg, seed=1, device="cpu")
    step = make_train_step(model, tx, cfg.train.loss.parameters)
    step(state, img1, img2, flow, valid)
    save_checkpoint(tmp_path / "a.ckpt", state)

    model2, tx2, _, state2 = create_train_state(cfg, seed=2, device="cpu")
    restore_checkpoint(tmp_path / "a.ckpt", state2)
    assert state2.step == 1
    for (k, a), b in zip(model.state_dict().items(),
                         model2.state_dict().values()):
        assert torch.equal(a, b), k
    # the optimizer's moments and schedule count came back too
    moments, moments2 = (t.adamw.state_dict()["state"] for t in (tx, tx2))
    assert moments.keys() == moments2.keys()
    for i in moments:
        for k, v in moments[i].items():
            assert torch.equal(v, moments2[i][k]), (i, k)
    assert tx2.scheduler.last_epoch == tx.scheduler.last_epoch == 1
    # so the next step is the same on both, up to the order in which the
    # CPU's threaded conv backward sums (measured <= 1.5e-8)
    step2 = make_train_step(model2, tx2, cfg.train.loss.parameters)
    step(state, *batch2[1:])
    step2(state2, *batch2[1:])
    for (k, a), b in zip(model.state_dict().items(),
                         model2.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=k)


def test_fast_kernels_on_refuses_an_unsupported_model(tmp_path):
    cfg = _tiny_config(tmp_path, fast_kernels="on")
    cfg.model.parameters = {"hidden_dim": 16}  # the kernels are 32 wide
    data = SyntheticBatches(2, (32, 64), n_batches=1, max_disp=16.0)
    with pytest.raises(ValueError, match="kernel train path does not"):
        train(cfg, max_steps=1, data_loader=data, device="cpu")
    cfg.train.fast_kernels = "auto"  # falls back to the plain step
    assert train(cfg, max_steps=1, data_loader=data, device="cpu").endswith(
        "epoch-2.ckpt")


def test_train_needs_a_data_loader_and_cuda_by_default(tmp_path):
    cfg = _tiny_config(tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train(cfg, max_steps=1, device="cpu")
    if not torch.cuda.is_available():
        data = SyntheticBatches(2, (32, 64), max_disp=16.0)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train(cfg, max_steps=1, data_loader=data)
