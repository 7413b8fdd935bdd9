"""The port's training data path against the JAX package, on the CPU.

Each test feeds the same inputs, made from a seed with numpy, to the JAX
package's function and to its counterpart in the port:

* ``data/device_augment.py``: ``apply_augment`` on params drawn by JAX's
  ``draw_params`` and passed as numpy, for the synthetic configs' spec (no
  flip, no y-jitter) and the reference config's (``do_flip "h"``,
  ``yjitter``, ``saturation_range``), the asymmetric and symmetric colour
  branches, the eraser on and off: images within 1e-2 of 255 levels, flow
  within 1e-4 px, valid equal (float32 sums in another order: the two means
  and the resample's two-tap sums); ``adjust_hue`` within 1e-3 levels.
  The port's own draws: 4096 samples inside their ranges, the orders
  permutations, each Bernoulli rate within 4 sigma of its probability, the
  same bits for the same (seed, step), and a batch augmented in two halves
  equal to the whole;
* ``data/device_cache.py``: ``pack_synthetic``, ``pack_dataset`` (with the
  sentinel), ``fetch_scene_batch`` and ``index_batches``: disparity quanta
  and indices exact, images within 1 level on at most 1e-3 of the values
  (the port's numpy scenes against cv2's, tests/test_torch_port_eval.py);
* ``data/augment.py``: ``resize_linear`` against ``cv2.resize``, and
  ``FlowAugmentor`` / ``SparseFlowAugmentor`` against the JAX package's
  (which resizes with cv2 here) with the same per-sample rng: uint8 images
  and float32 flow equal bit for bit (the share of uint8 values that
  differ, measured: 0), ``rgb_to_lab`` / ``transfer_color`` within 1e-9;
* ``data/loader.py`` and ``build_train_dataset``: the same batches, names
  and epochs as the JAX package's loader;
* ``train/freeze.py``: one float32 step of a small v1 with every BatchNorm
  frozen against JAX's ``make_train_step(freeze_bn=True)``: the loss within
  1e-4 relative and gradients within the rule of
  tests/test_torch_port_train_model.py, running stats unchanged in both;
* ``utils/logger.py``: ``MetricLogger``'s rows equal to JAX's.
"""

import dataclasses
import json
import pathlib
import re

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from realtime_stereo_matcher_tpu.config import load_config as jax_load_config
from realtime_stereo_matcher_tpu.data import augment as jax_augment
from realtime_stereo_matcher_tpu.data import device_augment as jax_da
from realtime_stereo_matcher_tpu.data import device_cache as jax_cache
from realtime_stereo_matcher_tpu.data import loader as jax_loader
from realtime_stereo_matcher_tpu.data.datasets import (
    build_train_dataset as jax_build_train_dataset,
)
from realtime_stereo_matcher_tpu.data.synthetic import (
    SyntheticStereo as JaxSyntheticStereo,
    make_scene as jax_make_scene,
)
from realtime_stereo_matcher_tpu.models import build_model as jax_build_model
from realtime_stereo_matcher_tpu.train.freeze import frozen_bn_apply
from realtime_stereo_matcher_tpu.train.init import (
    reference_initialize as jax_reference_initialize,
)
from realtime_stereo_matcher_tpu.train.loss import (
    sequence_loss as jax_sequence_loss,
)
from realtime_stereo_matcher_tpu.train.trainer import (
    TrainState as JaxTrainState,
    make_train_step as jax_make_train_step,
)
from realtime_stereo_matcher_tpu.utils.logger import (
    MetricLogger as JaxMetricLogger,
)
from realtime_stereo_matcher_tpu_torch.config import load_config
from realtime_stereo_matcher_tpu_torch.data import augment
from realtime_stereo_matcher_tpu_torch.data import device_augment as da
from realtime_stereo_matcher_tpu_torch.data import device_cache
from realtime_stereo_matcher_tpu_torch.data.datasets import (
    ConcatDataset,
    build_train_dataset,
)
from realtime_stereo_matcher_tpu_torch.data.loader import (
    StereoDataLoader,
    fetch_dataloader,
)
from realtime_stereo_matcher_tpu_torch.data.synthetic import SyntheticStereo
from realtime_stereo_matcher_tpu_torch.models import build_model
from realtime_stereo_matcher_tpu_torch.models.convert import from_jax_variables
from realtime_stereo_matcher_tpu_torch.train.freeze import frozen_bn
from realtime_stereo_matcher_tpu_torch.train.loss import sequence_loss
from realtime_stereo_matcher_tpu_torch.train.optim import make_optimizer
from realtime_stereo_matcher_tpu_torch.train.trainer import (
    TrainState,
    make_train_step,
)
from realtime_stereo_matcher_tpu_torch.utils.logger import MetricLogger

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the synthetic configs' aug params and the reference config's, crop cut
SYNTH_AUG = load_config(ROOT / "configure" /
                        "stereo_net_v2_synthetic_config.json").aug_params()
REF_AUG = load_config(ROOT / "configure" / "stereo_net_config.json").aug_params()
SRC_HW, CROP = (64, 96), (40, 56)
# per-pixel bounds of the device augmentation against JAX
IMG_TOL, FLOW_TOL = 1e-2, 1e-4


def _raw_batch(rng, b, hw=SRC_HW):
    """Noise images and a smooth flow: a slanted plane per sample, as the
    synthetic scenes' ground truth is.  (The sample positions sit one
    float32 ulp apart between the packages where XLA fuses ``x * s - 0.5``
    into one rounding; on a noise flow of 40 px/px that alone moves the
    resampled flow by up to 3.4e-4 px.)"""
    img1 = rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8)
    img2 = rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float32)
    a, gx, gy = (rng.uniform(lo, hi, (b, 1, 1)).astype(np.float32)
                 for lo, hi in ((5, 30), (-0.1, 0.1), (-0.1, 0.1)))
    flow = -(a + gx * xx + gy * yy)[..., None]
    return img1, img2, flow


def _jax_params(spec, keys, overrides):
    """JAX draws per key, the overrides set per sample, stacked (numpy)."""
    draws = [jax.tree_util.tree_map(np.asarray, jax_da.draw_params(k, spec))
             for k in keys]
    for d, o in zip(draws, overrides):
        d.update({k: np.asarray(v) for k, v in o.items()})
    return {k: np.stack([d[k] for d in draws]) for k in draws[0]}


@pytest.mark.parametrize("aug", [SYNTH_AUG, REF_AUG], ids=["synthetic", "ref"])
def test_apply_augment_matches_jax(aug, rng):
    aug = dict(aug, crop_size=CROP)
    spec = da.AugmentSpec.from_aug_params(aug, SRC_HW)
    jspec = jax_da.AugmentSpec.from_aug_params(aug, SRC_HW)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    b = 8
    keys = jax.random.split(jax.random.PRNGKey(3), b)
    # every (asymmetric, eraser on, flip) combination
    overrides = [{"asym": bool(i & 1), "eraser_on": bool(i & 2),
                  "eraser_two": bool(i & 4), "flip_h": bool(i & 4)}
                 for i in range(b)]
    params = _jax_params(jspec, keys, overrides)
    img1, img2, flow = _raw_batch(rng, b)
    want = jax.jit(jax.vmap(lambda p, x1, x2, f: jax_da.apply_augment(
        jspec, p, x1, x2, f)))(params, img1, img2, flow)
    want = [np.asarray(w) for w in want]
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    got = [t.numpy() for t in da.apply_augment(
        spec, tparams, torch.from_numpy(img1), torch.from_numpy(img2),
        torch.from_numpy(flow))]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=IMG_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=IMG_TOL)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=FLOW_TOL)
    np.testing.assert_array_equal(got[3], want[3])


def test_adjust_hue_matches_jax(rng):
    x = rng.uniform(0, 255, (4, 33, 47, 3)).astype(np.float32)
    x[0, :4] = 128.0  # gray pixels (no hue) and saturated channels
    x[1, :4, :, 0] = 255.0
    shift = rng.uniform(-0.5, 0.5, (4, 1, 1)).astype(np.float32)
    want = np.asarray(jax_da.adjust_hue(jnp.asarray(x), jnp.asarray(shift)))
    got = da.adjust_hue(torch.from_numpy(x), torch.from_numpy(shift)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_draws_in_range_and_keyed_by_step():
    aug = dict(REF_AUG, crop_size=CROP)
    spec = da.AugmentSpec.from_aug_params(aug, SRC_HW)
    n = 4096
    u = torch.rand((n, da.N_UNIFORMS), generator=da.step_generator(11, "cpu"))
    p = da.draw_params(spec, u)
    h, w = SRC_HW
    min_s = max((CROP[0] + 8) / h, (CROP[1] + 8) / w)
    orders = p["color_order"].sort(-1).values
    assert torch.equal(orders, torch.arange(4).expand(n, 2, 4))
    for j, (lo, hi) in enumerate([spec.brightness, spec.contrast,
                                  spec.saturation, (-spec.hue, spec.hue)]):
        f = p["color_factors"][..., j]
        assert bool(((f >= lo) & (f <= hi)).all()), j
    # symmetric samples share both views' order and factors
    sym = ~p["asym"]
    assert torch.equal(p["color_order"][sym, 0], p["color_order"][sym, 1])
    assert bool((p["scale_x"] >= min_s).all() & (p["scale_y"] >= min_s).all())
    top = 2.0 ** (spec.max_scale + spec.max_stretch)
    assert float(p["scale_x"].max()) <= top and float(p["scale_y"].max()) <= top
    rects = p["eraser_rects"]
    assert bool(((rects[..., 0] >= 0) & (rects[..., 0] < w)).all())
    assert bool(((rects[..., 1] >= 0) & (rects[..., 1] < h)).all())
    assert bool(((rects[..., 2:] >= 50) & (rects[..., 2:] < 100)).all())
    assert bool(((p["crop_u"] >= 0) & (p["crop_u"] < 1)).all())
    assert set(p["yjitter_delta"].unique().tolist()) == {-2.0, -1.0, 0.0, 1.0,
                                                         2.0}
    for key, prob in (("asym", spec.asymmetric_prob),
                      ("eraser_on", spec.eraser_prob), ("eraser_two", 0.5),
                      ("flip_h", 0.5), ("flip_v", 0.1)):
        rate = float(p[key].float().mean())
        assert abs(rate - prob) <= 4 * np.sqrt(prob * (1 - prob) / n), key
    # the same (seed, step): the same bits; another step or sample differs
    again = torch.rand((n, da.N_UNIFORMS),
                       generator=da.step_generator(11, "cpu"))
    assert torch.equal(u, again)
    other = torch.rand((n, da.N_UNIFORMS),
                       generator=da.step_generator(12, "cpu"))
    assert float((u == other).float().mean()) < 1e-3
    assert len({tuple(r) for r in u[:64].tolist()}) == 64


def test_device_augment_is_keyed_by_step_and_split_free(rng):
    spec = da.AugmentSpec.from_aug_params(dict(SYNTH_AUG, crop_size=CROP),
                                          SRC_HW)
    aug = da.make_device_augment(spec)
    batch = [torch.from_numpy(a) for a in _raw_batch(rng, 4)]
    whole = aug(5, *batch)
    for a, b in zip(whole, aug(5, *batch)):
        assert torch.equal(a, b)
    assert not torch.equal(whole[0], aug(6, *batch)[0])
    halves = [aug(5, *(t[s] for t in batch), first=s.start, total=4)
              for s in (slice(0, 2), slice(2, 4))]
    for k in range(4):
        assert torch.equal(whole[k], torch.cat([h[k] for h in halves]))


def _images_close(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_pack_synthetic_and_fetch_match_jax(tmp_path):
    kw = dict(length=5, seed0=7, image_hw=(48, 64), max_disp=24.0)
    got = device_cache.pack_synthetic(SyntheticStereo(**kw), tmp_path / "p")
    want = jax_cache.pack_synthetic(JaxSyntheticStereo(**kw),
                                    cache_dir=str(tmp_path / "j"))
    np.testing.assert_array_equal(got["disp_q"], want["disp_q"])
    assert got["disp_q"].dtype == np.uint16
    for k in ("img1", "img2"):
        assert got[k].dtype == np.uint8
        _images_close(got[k], want[k])
    # the port's cache: its own key, read back whole
    (cached,) = (tmp_path / "p").glob("*.npz")
    assert cached == device_cache.cache_path(SyntheticStereo(**kw),
                                             tmp_path / "p")
    assert re.fullmatch(r"torch_s7_n5_48x64_d24_[0-9a-f]{12}\.npz",
                        cached.name)
    again = device_cache.pack_synthetic(SyntheticStereo(**kw), tmp_path / "p")
    for k in got:
        np.testing.assert_array_equal(again[k], got[k])

    resident = device_cache.DeviceResidentScenes(want, device="cpu")
    jresident = jax_cache.DeviceResidentScenes(want)
    assert resident.nbytes() == jresident.nbytes()
    assert (resident.length, resident.image_hw) == (5, (48, 64))
    idx = np.array([4, 0, 2], np.int32)
    got_b = resident.fetch(torch.from_numpy(idx))
    want_b = jax_cache.fetch_scene_batch(jresident.arrays, jnp.asarray(idx))
    for g, w in zip(got_b, want_b):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    gen = resident.index_batches(2, epoch0=3)
    jgen = jresident.index_batches(2, seed=1234, epoch0=3)
    for _ in range(7):
        g, w = next(gen), next(jgen)
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


class _SparseScenes:
    """A raw dataset with sparse ground truth (a third of it invalid)."""

    def __init__(self, n, hw=(40, 56), seed=11):
        rng = np.random.default_rng(seed)
        self.samples = []
        for i in range(n):
            img1, img2, flow, valid = _host_inputs(rng, hw)
            self.samples.append(([f"s{i}"], img1, img2, flow[..., :1], valid))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def test_pack_dataset_with_the_sentinel_matches_jax():
    ds = _SparseScenes(6)
    got = device_cache.pack_dataset(ds)
    want = jax_cache.pack_dataset(ds)
    assert got["fp"] == want["fp"] == device_cache.GENERIC_FIXED_POINT
    np.testing.assert_array_equal(got["disp_q"], want["disp_q"])
    assert (got["disp_q"] == device_cache.SENTINEL).any()  # invalid columns
    for k in ("img1", "img2"):
        np.testing.assert_array_equal(got[k], want[k])
    resident = device_cache.DeviceResidentScenes(want, device="cpu")
    idx = np.array([5, 1], np.int32)
    flow = resident.fetch(torch.from_numpy(idx))[2].numpy()
    want_flow = np.asarray(jax_cache.fetch_scene_batch(
        jax_cache.DeviceResidentScenes(want).arrays, jnp.asarray(idx),
        want["fp"])[2])
    np.testing.assert_array_equal(flow, want_flow)
    assert float(flow.min()) == -1024.0
    with pytest.raises(ValueError, match="resident budget"):
        device_cache.pack_dataset(ds, max_bytes=1)
    synthetic = SyntheticStereo(length=2, image_hw=(40, 56), max_disp=20.0)
    synthetic.out_dtype = np.uint8  # as fetch_dataloader(raw=True)
    packed = device_cache.pack_dataset(synthetic)
    np.testing.assert_array_equal(
        packed["disp_q"], np.round(-np.stack([synthetic[i][3][..., 0]
                                              for i in range(2)]) * 128))


@pytest.mark.parametrize("dtype, channels", [(np.uint8, None), (np.uint8, 3),
                                             (np.uint8, 2), (np.float32, 2)])
def test_resize_linear_matches_cv2(channels, dtype, rng):
    """The same bits as cv2 on uint8 images and two-channel float32 ones
    (the flow): the two the augmentors resize.  (cv2 maps float32 with 1,
    3 or 4 channels on another path, ~1e-5 relative away.)"""
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(4, 90, 2))
        fx, fy = (float(2 ** v) for v in rng.uniform(-0.9, 1.2, 2))
        shape = (h, w) if channels is None else (h, w, channels)
        img = (rng.integers(0, 256, shape).astype(np.uint8) if dtype == np.uint8
               else rng.normal(0, 50, shape).astype(np.float32))
        got = augment.resize_linear(img, fx, fy)
        want = cv2.resize(img, (int(round(w * fx)), int(round(h * fy))),
                          interpolation=cv2.INTER_LINEAR)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _host_inputs(rng, hw=(72, 100)):
    img1 = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    img2 = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    disp = rng.uniform(0, 30, hw).astype(np.float32)
    flow = np.stack([-disp, np.zeros_like(disp)], -1)
    valid = (rng.uniform(size=hw) > 0.3).astype(np.float32)
    return img1, img2, flow, valid


@pytest.mark.parametrize("aug", [SYNTH_AUG, REF_AUG], ids=["synthetic", "ref"])
def test_flow_augmentor_matches_jax(aug, rng):
    aug = dict(aug, crop_size=(48, 64))
    port, jaxa = augment.FlowAugmentor(**aug), jax_augment.FlowAugmentor(**aug)
    for seed in range(12):
        img1, img2, flow, _ = _host_inputs(rng)
        got = port(img1, img2, flow, rng=np.random.default_rng(seed))
        want = jaxa(img1, img2, flow, rng=np.random.default_rng(seed))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_sparse_flow_augmentor_matches_jax(rng):
    aug = dict(crop_size=(48, 64), min_scale=-0.2, max_scale=0.4,
               do_flip="hf", yjitter=False, saturation_range=(0.7, 1.3))
    port = augment.SparseFlowAugmentor(**aug)
    jaxa = jax_augment.SparseFlowAugmentor(**aug)
    for seed in range(12):
        img1, img2, flow, valid = _host_inputs(rng)
        got = port(img1, img2, flow, valid, rng=np.random.default_rng(seed))
        want = jaxa(img1, img2, flow, valid, rng=np.random.default_rng(seed))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_color_transfer_matches_jax(rng):
    img = rng.uniform(0, 255, (20, 30, 3))
    np.testing.assert_allclose(augment.rgb_to_lab(img / 255.0),
                               jax_augment.rgb_to_lab(img / 255.0), atol=1e-9)
    mean, std = np.array([50.0, 5.0, -5.0]), np.array([20.0, 10.0, 12.0])
    np.testing.assert_allclose(augment.transfer_color(img, mean, std),
                               jax_augment.transfer_color(img, mean, std),
                               atol=1e-9)


def _same_batches(port_loader, jax_loader_, epochs=2):
    for _ in range(epochs):
        got, want = list(port_loader), list(jax_loader_)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g[0] == w[0]
            for a, b in zip(g[1:], w[1:]):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


def test_loader_matches_jax_with_host_augmentation():
    aug = dict(SYNTH_AUG, crop_size=(40, 56))
    kw = dict(length=6, seed0=100, image_hw=(64, 96), max_disp=16.0)
    port = StereoDataLoader(SyntheticStereo(dict(aug), **kw), 2,
                            num_workers=2)
    jaxl = jax_loader.StereoDataLoader(JaxSyntheticStereo(dict(aug), **kw), 2,
                                       num_workers=2)
    assert len(port) == len(jaxl) == 3
    # the JAX scenes through both augmentors: the same batches, epoch by
    # epoch (the port's own scenes sit a level apart on a few pixels)
    scenes = {i: jax_make_scene(100 + i, 64, 96, max_disp=16.0)
              for i in range(6)}
    port.dataset._cache, jaxl.dataset._cache = dict(scenes), dict(scenes)
    _same_batches(port, jaxl)
    assert port.epoch == jaxl.epoch == 2


def test_build_train_dataset_and_fetch_dataloader_match_jax():
    path = ROOT / "configure" / "stereo_net_v2_synthetic_config.json"
    cfg, jcfg = load_config(path), jax_load_config(path)
    for c in (cfg, jcfg):
        c.train.datasets = ["synthetic_3", "synthetic"]
    for raw in (False, True):
        got = build_train_dataset(cfg, raw=raw)
        want = jax_build_train_dataset(jcfg, raw=raw)
        assert isinstance(got, ConcatDataset)
        assert [len(d) for d in got.datasets] == [
            len(d) for d in want.datasets] == [3, 2000]
        assert [d.augmentor is None for d in got.datasets] == [raw, raw]
        assert got.datasets[0].augmentor is None or (
            got.datasets[0].augmentor.crop_size == (240, 320))
    loader = fetch_dataloader(cfg, raw=True)
    jloader = jax_loader.fetch_dataloader(jcfg, raw=True)
    assert (loader.batch_size, len(loader)) == (jloader.batch_size,
                                                len(jloader)) == (8, 250)
    assert all(d.out_dtype == np.uint8 for d in loader.dataset.datasets)
    cfg.train.datasets = ["no_such_set"]
    with pytest.raises(ValueError, match="unknown training dataset"):
        build_train_dataset(cfg)


def test_freeze_bn_step_matches_jax():
    """One float32 step of a small v1 with frozen BatchNorm (32 x 64, batch
    2): loss within 1e-4 relative, gradients per parameter within max(6 x
    the JAX step's reversed-batch floor, 1e-2) relative L2 (leaves of norm
    < 1e-3 skipped), running stats unchanged in both.  The cost filter's
    head bias shifts every disparity's logit alike, which the soft-argmin
    ignores: its gradient is zero but for float32 round-off, 1.6e-3 in JAX
    here and ~1e-8 in the port; it is held under 1e-2 in both."""
    v1 = {"type": "MobileStereoNet", "parameters": {}}
    b, h, w = 2, 32, 64
    gen = np.random.default_rng(5)
    left = gen.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    right = np.clip(np.roll(left, -3, axis=2) + gen.normal(0, 4, left.shape),
                    0, 255).astype(np.float32)
    flow = -gen.uniform(0, 40, (b, h, w, 1)).astype(np.float32)
    valid = (gen.uniform(size=(b, h, w)) > 0.2).astype(np.float32)

    jmodel = jax_build_model(v1)
    dummy = jnp.zeros((1, h, w, 3), jnp.float32)
    # the tree's shapes alone (no compile): reference_initialize sets every
    # leaf
    variables = jax.eval_shape(
        lambda k: jmodel.init(k, dummy, dummy, train=True),
        jax.random.PRNGKey(0))
    variables = dict(jax_reference_initialize(
        dict(variables), jax.random.PRNGKey(1), model_type="MobileStereoNet"))
    # running stats as a trained model has them (the step normalizes with
    # them): means about 0, variances about 1
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(
            gen.normal(0, 0.3, a.shape) if path[-1].key == "mean"
            else gen.uniform(0.5, 1.5, a.shape), jnp.float32),
        variables["batch_stats"])
    loss_params = {"loss_gamma": 0.9, "max_flow_magnitude": 700}

    apply = frozen_bn_apply(jmodel)

    def loss_fn(params, l, r, f, v):
        preds, _ = apply({"params": params,
                          "batch_stats": variables["batch_stats"]}, l, r,
                         train=True, mutable=["batch_stats"])
        return jax_sequence_loss(preds, f, v, **loss_params)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    jloss, jgrads = grad_fn(variables["params"], left, right, flow, valid)
    _, jgrads_rev = grad_fn(variables["params"], left[::-1], right[::-1],
                            flow[::-1], valid[::-1])
    # the JAX package's frozen step moves no running stat
    tx = optax.adamw(1e-4)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                batch_stats=variables["batch_stats"],
                opt_state=tx.init(variables["params"]))
    jstep = jax_make_train_step(jmodel, tx, loss_params, freeze_bn=True)
    jstate2, jmetrics = jax.jit(jstep)(jstate, left, right, flow, valid)
    np.testing.assert_allclose(float(jmetrics["live_loss"]), float(jloss),
                               rtol=1e-6)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jstate2.batch_stats, variables["batch_stats"])

    model = build_model(v1, device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = [torch.from_numpy(np.ascontiguousarray(a))
             for a in (left, right, flow, valid)]
    # the step's forward and backward (its AdamW clips the gradients in
    # place, so they are held here, before it)
    with frozen_bn(model):
        loss = sequence_loss(model(*batch[:2]), *batch[2:], **loss_params)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad()
    tx_port, _ = make_optimizer(model.parameters(), 2e-4, 100, 1e-5)
    step = make_train_step(model, tx_port, loss_params, freeze_bn=True)
    _, metrics = step(TrainState(model, tx_port), *batch)
    assert float(metrics["live_loss"]) == float(loss.detach())
    assert model.training and all(
        m.training for m in model.modules())  # modes given back
    after = model.state_dict()
    stats = ("running_mean", "running_var", "num_batches_tracked")
    for k, v in before.items():
        if k.endswith(stats):
            assert torch.equal(after[k], v), k
    # the step trained: every parameter with a gradient moved
    for k, g in grads.items():
        assert torch.equal(after[k], before[k]) == (not bool(g.any())), k
    want = from_jax_variables({"params": jgrads})
    rev = from_jax_variables({"params": jgrads_rev})
    checked = 0
    for k, g in grads.items():
        if k == "cost_filter.12.bias":
            assert float(want[k].norm()) < 1e-2 and float(g.norm()) < 1e-2
            continue
        if not bool(want[k].any()):
            # the last refine level's head is dead at these weights (its
            # relu(disp + delta) is 0 everywhere): no gradient in either
            assert not bool(g.any()), k
            checked += 1
            continue
        norm = float(want[k].norm()) + 1e-20
        if norm < 1e-3:
            continue
        diff = float((g - want[k]).norm()) / norm
        floor = float((want[k] - rev[k]).norm()) / norm
        assert diff <= max(6.0 * floor, 1e-2), (k, diff, floor)
        checked += 1
    assert checked > 0.9 * len(want)


def test_metric_logger_rows_match_jax(tmp_path):
    gen = np.random.default_rng(2)
    port = MetricLogger(tmp_path / "p", sum_freq=3, lr_fn=lambda s: 1e-4 * s,
                        tensorboard=False)
    jaxl = JaxMetricLogger(tmp_path / "j", sum_freq=3,
                           lr_fn=lambda s: 1e-4 * s, tensorboard=False)
    for s in range(10):
        m = {"live_loss": float(gen.uniform(1, 5)), "epe": float(gen.uniform())}
        for logger in (port, jaxl):
            logger.write_scalars(s, {"live_loss": m["live_loss"],
                                     "learning_rate": 1e-4 * s})
            logger.push(m, step=s + 40)
    port.close()
    jaxl.close()

    def rows(d):
        return [{k: v for k, v in json.loads(line).items() if k != "time"}
                for line in (d / "scalars.jsonl").read_text().splitlines()]

    got, want = rows(tmp_path / "p"), rows(tmp_path / "j")
    assert got == want and len(got) == 13
    assert [r["step"] for r in got if "epe" in r] == [41, 44, 47]
