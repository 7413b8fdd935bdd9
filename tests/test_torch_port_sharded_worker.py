"""Sharded inference of the port as one rank runs it, and the JAX-free
tests of ``parallel/sharded_infer.py``, ``disparity_sharding.py`` and
``halo.py``.

This file imports torch and the port only: run as a script it is one rank
of a group of ``WORLD`` gloo ranks (``RSM_*`` env vars, set by
``spawn_ranks``), the worker of ``tests/test_torch_port_sharded.py``, which
runs each case's one-process forward and holds every rank to it.  The
cases (``CASES``) are v1, v2, v3 and V4 at small widths (hidden 8, refine
dilations (1, 8); V4 ``volume_size`` and ``hg_size`` 8), plain and kernel
path (the kernels' plain versions on the CPU), float64 and float32, at
64 x 96 and 52 x 90, over 2, 3 and 4 of the ranks:

* 64 x 96 over 4 ranks: 2 coarse rows a rank, so the dilation-8 convs of
  the 1/4-resolution refine (4 rows a rank) take rows from two ranks;
* 64 x 96 over 3 ranks: 2 row shards, so rank 2 is off the spatial axis
  (and rank 3 outside the forward);
* 52 x 90 pads to 56 x 96 (v1 / v2 / v3): 7 coarse rows, one row shard,
  the disparity axis alone sharded.

Each rank also runs the disparity-sharded coarse stage and V4 volume on
seeded features (held to the JAX package's on its 8-device CPU mesh), the
row halos of ``EXCHANGES`` (held to ``take_rows`` of the whole tensor) and
the collective audit of one sharded v1 frame.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # run as a script from any directory
    sys.path.insert(0, str(ROOT))

from realtime_stereo_matcher_tpu_torch.models import build_model  # noqa: E402
from realtime_stereo_matcher_tpu_torch.models.fast_infer import (  # noqa: E402
    make_fast_forward,
)
from realtime_stereo_matcher_tpu_torch.models.stereo_net_v4 import (  # noqa: E402
    interweave_cost,
)
from realtime_stereo_matcher_tpu_torch.parallel import (  # noqa: E402
    distributed,
    halo,
)
from realtime_stereo_matcher_tpu_torch.parallel.comm_audit import audit  # noqa: E402
from realtime_stereo_matcher_tpu_torch.parallel.disparity_sharding import (  # noqa: E402
    make_sharded_coarse_fn,
    make_sharded_v4_volume_fn,
)
from realtime_stereo_matcher_tpu_torch.parallel.mesh import (  # noqa: E402
    Axis,
    prefix_axis,
)
from realtime_stereo_matcher_tpu_torch.parallel.sharded_infer import (  # noqa: E402
    make_sharded_infer,
    n_spatial,
)
from realtime_stereo_matcher_tpu_torch.ops import (  # noqa: E402
    difference_cost_volume,
    soft_argmin,
)

WORLD = 4
_SMALL = {"max_disp": 95, "hidden_dim": 8, "refine_dilates": [1, 8]}
MODELS = {
    "v1": {"type": "MobileStereoNet", "parameters": _SMALL},
    "v2": {"type": "MobileStereoNetV2", "parameters": _SMALL},
    "v3": {"type": "MobileStereoNetV3", "parameters": _SMALL},
    "v4": {"type": "MobileStereoNetV4",
           "parameters": {"max_disp": 32, "volume_size": 8, "hg_size": 8}},
}
SIZES = {"even": (64, 96), "odd": (52, 90)}
DTYPES = {"f64": torch.float64, "f32": torch.float32}


def _case(model, path, dtype, size, ranks):
    return f"{model}_{path}_{dtype}_{size}_r{ranks}", (model, path, dtype,
                                                       size, ranks)


CASES = dict(_case(*c) for c in [
    ("v1", "plain", "f64", "even", 4), ("v1", "plain", "f64", "even", 3),
    ("v1", "plain", "f64", "even", 2), ("v1", "plain", "f32", "odd", 4),
    ("v1", "plain", "f32", "even", 4), ("v1", "kernel", "f64", "even", 4),
    ("v1", "kernel", "f64", "even", 3), ("v1", "kernel", "f32", "odd", 4),
    ("v1", "kernel", "f32", "even", 2), ("v1", "kernel", "f64", "odd", 3),
    ("v2", "plain", "f64", "even", 4), ("v2", "plain", "f32", "odd", 2),
    ("v2", "kernel", "f64", "even", 3), ("v2", "kernel", "f32", "even", 4),
    ("v3", "plain", "f64", "even", 4), ("v3", "plain", "f64", "even", 2),
    ("v3", "plain", "f32", "odd", 3), ("v3", "kernel", "f64", "even", 4),
    ("v3", "kernel", "f32", "odd", 4), ("v3", "kernel", "f64", "even", 3),
    ("v4", "plain", "f64", "even", 4), ("v4", "plain", "f64", "even", 3),
    ("v4", "plain", "f64", "odd", 2), ("v4", "plain", "f32", "even", 4),
    ("v4", "plain", "f32", "odd", 3),
])
# the case whose collectives the ranks audit
AUDIT_CASE = "v1_kernel_f64_even_r4"
# the disparity-sharded coarse stage and V4 volume on seeded features
COARSE_D, COARSE_FEAT = 16, (1, 8, 24, 8)
V4_SHIFTS, V4_FEAT = 16, (1, 32, 8, 24)
# (fill, lo, hi) halos of 2-row shards over the 4 ranks: deeper than one
# shard (rows from several ranks), one row, one side only
EXCHANGES = [("zeros", 5, 3), ("edge", 5, 3), ("zeros", 1, 1),
             ("edge", 1, 1), ("zeros", 2, 0), ("edge", 0, 4)]


def exchange_source() -> torch.Tensor:
    """The whole (1, 8, 3, 2) tensor whose 2-row shards the ranks hold."""
    return torch.arange(48, dtype=torch.float64).view(1, 8, 3, 2) + 1


@torch.no_grad()
def case_model(name: str, dtype=torch.float64, seed: int = 0,
               **overrides) -> torch.nn.Module:
    """``MODELS[name]`` from ``seed`` on the CPU in ``dtype``, its
    BatchNorms' statistics and affines drawn too (so that eval BatchNorm
    is no identity)."""
    config = {"type": MODELS[name]["type"],
              "parameters": dict(MODELS[name]["parameters"], **overrides)}
    gen = torch.Generator().manual_seed(seed)
    model = build_model(config, device="cpu", generator=gen)
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            c = m.num_features
            m.running_mean.copy_(torch.rand(c, generator=gen) * 0.2 - 0.1)
            m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
            m.weight.copy_(torch.rand(c, generator=gen) + 0.5)
            m.bias.copy_(torch.rand(c, generator=gen) * 0.2 - 0.1)
    return model.to(dtype).eval()


def frames(size: str, seed: int = 0) -> tuple:
    """A seeded (1, H, W, 3) uint8-range float32 pair: the right view is
    the left shifted 3 px plus noise."""
    h, w = SIZES[size]
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (1, h, w + 3, 3)).astype(np.float32)
    right = np.clip(left[:, :, 3:] + rng.normal(0, 8, (1, h, w, 3)), 0, 255)
    return (torch.from_numpy(np.ascontiguousarray(left[:, :, :w])),
            torch.from_numpy(right.astype(np.float32)))


def one_process(name: str) -> list:
    """Case ``name``'s one-process forward (``model(left, right)`` or
    ``make_fast_forward``) in this process."""
    model_name, path, dt, size, _ = CASES[name]
    model = case_model(model_name, DTYPES[dt])
    left, right = frames(size)
    with torch.no_grad():
        if path == "plain":
            return model(left, right)
        return make_fast_forward(model, dtype=DTYPES[dt])(left, right)


def sharded(name: str) -> list | None:
    """Case ``name``'s sharded forward on this rank (None off its ranks)."""
    model_name, path, dt, size, ranks = CASES[name]
    model = case_model(model_name, DTYPES[dt])
    fwd = make_sharded_infer(model, fast=path == "kernel", dtype=DTYPES[dt],
                             ranks=ranks)
    return fwd(*frames(size))


def coarse_features(seed: int = 1) -> tuple:
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(COARSE_FEAT, generator=gen) for _ in range(2))


def v4_features(seed: int = 2) -> tuple:
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(V4_FEAT, generator=gen) for _ in range(2))


def v4_volume_model() -> torch.nn.Module:
    return case_model("v4", torch.float32, volume_size=V4_SHIFTS)


def worker(out_dir: str) -> None:
    """One rank: every case, the coarse stage and V4 volume on seeded
    features, the audit; results to ``<out_dir>/rank<r>.pt``."""
    torch.set_num_threads(1)
    if not distributed.initialize(device="cpu", timeout_s=120):
        raise RuntimeError("the worker runs as a rank (RSM_* env vars)")
    try:
        rank = torch.distributed.get_rank()
        out = {"rank": rank, "cases": {}}
        for name in CASES:
            out["cases"][name] = sharded(name)
        model = case_model("v1", torch.float32)
        with torch.no_grad():
            out["coarse"] = make_sharded_coarse_fn(
                prefix_axis(WORLD), COARSE_D,
                cost_filter=model.cost_filter)(*coarse_features())
            out["v4_volume"] = make_sharded_v4_volume_fn(
                prefix_axis(WORLD), v4_volume_model())(*v4_features())
        axis = prefix_axis(WORLD)
        mine = halo.take_rows(exchange_source(), axis, dim=1)
        out["exchange"] = {f"{fill}{lo}{hi}": halo.exchange(mine, lo, hi, axis,
                                                         dim=1, fill=fill)
                           for fill, lo, hi in EXCHANGES}
        report = audit(sharded, AUDIT_CASE)
        out["audit"] = {k: report[k] for k in ("per_op", "per_what",
                                               "total_bytes")}
        torch.save(out, pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        distributed.shutdown()


# ---------------------------------------------------------------------------
# JAX-free tests: one process, axes of one rank
# ---------------------------------------------------------------------------

ONE = Axis(None, 0, 1)


@pytest.fixture(scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_shard_counts_follow_the_jax_rule():
    """The largest k <= n dividing the coarsest rows; 720p v1 has 90 coarse
    rows (3 shards on 4 ranks), V4 45 floor rows (1 shard on 2)."""
    assert n_spatial(90, 4) == 3 and n_spatial(90, 2) == 2
    assert n_spatial(45, 2) == 1 and n_spatial(45, 4) == 3
    assert n_spatial(24, 4) == 4 and n_spatial(7, 4) == 1
    assert n_spatial(8, 3) == 2


@pytest.mark.parametrize("fill", halo.FILLS)
def test_exchange_of_one_rank_pads(fill):
    x = torch.arange(12.0).view(1, 3, 4)
    y = halo.exchange(x, 2, 1, ONE, dim=1, fill=fill)
    assert y.shape == (1, 6, 4)
    assert torch.equal(y[:, 2:5], x)
    edge = fill == "edge"
    assert torch.equal(y[:, :2], (x[:, :1] if edge else 0 * x[:, :1]).expand(
        1, 2, 4))
    assert torch.equal(y[:, 5:], x[:, 2:] if edge else 0 * x[:, 2:])
    assert torch.equal(halo.take_rows(x, ONE, dim=1, lo=2, hi=1, fill=fill),
                       y)


def test_take_rows_splits_evenly():
    x = torch.arange(24.0).view(1, 6, 4)
    for k in range(3):
        axis = Axis(None, k, 3)
        assert torch.equal(halo.take_rows(x, axis, dim=1), x[:, 2 * k:2 * k + 2])
    with pytest.raises(ValueError, match="do not split"):
        halo.take_rows(x, Axis(None, 0, 4), dim=1)


def test_row_sharded_copy_shares_weights_and_runs_only_in_over_rows():
    model = case_model("v1")
    twin = halo.row_sharded(model.feature_extractor)
    assert all(a is b for a, b in zip(twin.parameters(),
                                      model.feature_extractor.parameters()))
    x = torch.randn(1, 16, 24, 3, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="outside over_rows"):
        twin(x)
    with halo.over_rows(ONE):
        assert torch.equal(twin(x), model.feature_extractor(x))


@pytest.mark.parametrize("name", ["v1", "v2", "v3", "v4"])
def test_one_rank_forward_is_the_one_process_forward(name, one_torch_thread):
    """Without a group every axis has one rank: the plain sharded forward
    is the model's forward (up to the soft-argmin's form)."""
    model = case_model(name)
    left, right = frames("odd")
    with torch.no_grad():
        want = model(left, right)
    got = make_sharded_infer(model, fast=False)(left, right)
    assert len(got) == len(want)
    for g, t in zip(got, want):
        assert g.shape == t.shape
        torch.testing.assert_close(g, t, rtol=1e-10, atol=1e-10)


def test_dispnetc_is_single_chip_by_design():
    model = build_model({"type": "MobileDispNetC",
                         "parameters": {"hidden_dim": 8, "max_disp": 32}},
                        device="cpu")
    with pytest.raises(NotImplementedError, match="single-chip by design"):
        make_sharded_infer(model)


def test_v4_has_no_kernel_path():
    with pytest.raises(NotImplementedError, match="no kernel path"):
        make_sharded_infer(case_model("v4"), fast=True)


def test_difference_slabs_tile_the_volume():
    left, right = coarse_features()
    want = difference_cost_volume(left, right, COARSE_D)
    got = torch.cat([difference_cost_volume(left, right, 4, shift0=d0)
                     for d0 in range(0, COARSE_D, 4)], dim=1)
    assert torch.equal(got, want)


def test_one_rank_coarse_stage_is_soft_argmin_of_the_filter():
    model = case_model("v1")
    left, right = (f.double() for f in coarse_features())
    with torch.no_grad():
        want = soft_argmin(model.cost_filter(
            difference_cost_volume(left, right, COARSE_D)), axis=1)
        got = make_sharded_coarse_fn(ONE, COARSE_D,
                                     cost_filter=model.cost_filter)(left, right)
    torch.testing.assert_close(got[..., 0], want, rtol=1e-12, atol=1e-12)


def _interweave_cost_before(conv3d, volume11, feat_l, feat_r, n_shifts,
                            chunk=None):
    """``interweave_cost`` as it was before it took ``shift0``, verbatim
    but for its docstring and checks."""
    from realtime_stereo_matcher_tpu_torch.models.stereo_net_v4 import (
        DEPTH_BLOCKS, _blockwise_conv, _reduce)

    b, c, h, w = feat_l.shape
    conv0 = conv3d[0]
    k = conv0.weight[:, 0]
    kl, kr = k[:, 0::2], k[:, 1::2]
    a = _blockwise_conv(feat_l, kl, DEPTH_BLOCKS)
    bc = _blockwise_conv(feat_r, kr, DEPTH_BLOCKS)
    ct = _blockwise_conv(feat_l[..., :w - 1], kl[..., :1], DEPTH_BLOCKS,
                         (1, 0, 1, 1))
    cr = _blockwise_conv(feat_r[..., 1:], kr[..., 2:], DEPTH_BLOCKS,
                         (0, 1, 1, 1))
    bias0 = conv0.bias.repeat(DEPTH_BLOCKS).view(1, 1, -1, 1, 1)
    colw = torch.arange(w, device=feat_l.device)
    chunk = min(chunk or n_shifts, n_shifts)
    slabs = []
    for s0 in range(0, n_shifts, chunk):
        shifts = torch.arange(s0, min(s0 + chunk, n_shifts),
                              device=feat_l.device)
        n_s = len(shifts)
        keep = colw[None, :] >= shifts[:, None]
        at_s = (colw[None, :] == shifts[:, None]).to(a.dtype)
        idx = (colw[None, :] - shifts[:, None]).clamp(min=0)
        stack = bc[..., idx.reshape(-1)].view(b, -1, h, n_s, w)
        z = a[:, None] + stack.permute(0, 3, 1, 2, 4)
        z = z - at_s[None, :, None, None, :] * ct[:, None]
        last = (w - 1 - shifts).clamp(0, w - 1)
        cr_last = cr[..., last].permute(0, 3, 1, 2)
        cr_last = cr_last * (shifts >= 1).to(cr.dtype)[None, :, None, None]
        z = torch.cat([z[..., :w - 1], z[..., w - 1:] - cr_last[..., None]],
                      dim=-1)
        z = (z + bias0.to(z.dtype)).reshape(b * n_s, -1, h, w)
        vol = _reduce(conv3d, volume11, z, keep, b)
        slabs.append(vol.view(b, n_s, h, w) * keep[None, :, None, :])
    return torch.cat(slabs, dim=1)


@pytest.mark.parametrize("chunk", [4, 16])
def test_interweave_shift_offset_tiles_the_volume(chunk):
    """``interweave_cost`` at ``shift0=0`` is what it was before it took a
    shift offset, bit for bit; its slabs at offsets tile the volume."""
    model = v4_volume_model()
    fl, fr = v4_features()
    with torch.no_grad():
        before = _interweave_cost_before(model.conv3d, model.volume11, fl, fr,
                                         V4_SHIFTS, chunk)
        whole = interweave_cost(model.conv3d, model.volume11, fl, fr,
                                V4_SHIFTS, chunk)
        slabs = [interweave_cost(model.conv3d, model.volume11, fl, fr, 4,
                                 chunk, shift0=s)
                 for s in range(0, V4_SHIFTS, 4)]
    assert torch.equal(whole, before)
    torch.testing.assert_close(torch.cat(slabs, dim=1), whole, rtol=1e-6,
                               atol=1e-6)


if __name__ == "__main__":
    worker(sys.argv[1])
