"""Benchmark validators (port of
``realtime_stereo_matcher_tpu/eval/validators.py``; reference
evaluate_stereo.py).

Per-dataset validation with the metric math of the JAX package, line for
line, including the reference's subtleties:

* inputs padded to /64 with the replicate-mode centered InputPadder
  (reference :121-122);
* valid mask = dataset validity AND pred not-NaN AND ``flow_pr < 0.0``
  (the negative-flow convention, reference :135-139);
* KITTI: D1 = 100 * mean over *all pooled pixels* of EPE > 1 (reference
  :153-161); ETH3D/Middlebury: bad0.5/1/3/5 averaged *per image* first
  (reference :83-96, :248-278); Things: additional |gt| < 192 mask (:193);
  ETH3D drops images with EPE > 80 (:78-79); Middlebury valid uses
  ``valid >= -0.5`` and ``gt > -1000`` (:241-246).

FPS = 1 / the forward latency of the padded shape, measured once per
shape after warm-up and cached (``utils/timing.py``: CUDA events on the
card); the metrics never depend on it.  The JAX package's
``shape_bucket``, which padded past /64 to bound its recompiles, has no
counterpart: the port compiles nothing per shape.

The runner also takes the classical SGBM baseline (``classical/sgbm.py``),
as the JAX package's does: it runs on the host, and its FPS is the wall
clock of its one call.
"""

from __future__ import annotations

import logging
import os.path as osp
import time

import numpy as np
import torch

from realtime_stereo_matcher_tpu_torch import resolve_device
from realtime_stereo_matcher_tpu_torch.data import datasets
from realtime_stereo_matcher_tpu_torch.models.fast_infer import (
    has_kernel_path,
    make_fast_forward,
)
from realtime_stereo_matcher_tpu_torch.ops import InputPadder
from realtime_stereo_matcher_tpu_torch.utils.timing import forward_latency

# forwards that measure one padded shape's latency: untimed, then timed
LATENCY_WARMUP, LATENCY_ITERS = 3, 10


class ModelRunner:
    """``runner(left, right) -> [negative disparity maps]`` over one model.

    ``fast`` picks the forward of a model with a kernel path (v1, v2, v3;
    ``models/fast_infer.py``): ``"auto"`` (default) the kernel path in
    ``dtype`` on a CUDA device and the plain float32 model on the CPU;
    ``True`` the kernel path on either (on the CPU its kernels run their
    plain versions); ``False`` the plain float32 model.  A model without a
    kernel path (V4, DispNetC; the JAX package has none for them either)
    runs its plain forward: under ``"auto"`` on a CUDA device autocast to
    ``dtype`` (bf16 where the config asks for mixed precision, as the JAX
    package runs the Flax model in the config's dtype), else in float32;
    ``fast=True`` raises for it.  The kernel path folds the weights once,
    here, for every shape; its tile plans are cached per shape.  Nothing
    falls back: an error of the kernel path propagates.  ``device`` is
    resolved by ``resolve_device``, so without CUDA the default raises.

    A classical module (the SGBM baseline, not a ``torch.nn.Module``) runs
    on the host on the images copied there, as in the JAX package; its
    maps are returned on ``device``; ``fast=True`` raises for it.
    """

    def __init__(self, model, *, fast="auto",
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
        if fast not in ("auto", True, False):
            raise ValueError(f"fast must be 'auto', True or False, not "
                             f"{fast!r}")
        self.device = resolve_device(device)
        self.is_neural = isinstance(model, torch.nn.Module)
        self._latency: dict[tuple, float] = {}
        if not self.is_neural:
            if fast is True:
                raise NotImplementedError(
                    f"{type(model).__name__} is a host module with no "
                    f"kernel path")
            self.model, self.fast, self.dtype = model, False, torch.float32
            self._forward = self._host
            return
        self.model = model.to(self.device).eval()
        kernels = has_kernel_path(self.model)
        if fast is True and not kernels:
            raise NotImplementedError(
                f"{type(self.model).__name__} has no kernel path (nor has "
                f"it in the JAX package); run it with fast='auto' or False")
        on_cuda = self.device.type == "cuda"
        self.fast = kernels and (on_cuda if fast == "auto" else fast)
        autocast = not kernels and fast == "auto" and on_cuda
        self.dtype = dtype if self.fast or autocast else torch.float32
        self._forward = (make_fast_forward(self.model, dtype=dtype)
                         if self.fast else self._plain)

    @torch.no_grad()
    def _plain(self, left, right):
        with torch.autocast(self.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            return self.model(left, right)

    def _host(self, left, right):
        start = time.perf_counter()
        out = self.model(left, right)
        self._host_seconds = time.perf_counter() - start
        return [torch.from_numpy(d).to(self.device) for d in out]

    def __call__(self, left, right):
        return self._forward(left, right)

    def latency(self, left, right) -> float:
        """Seconds per forward at this padded shape, measured once per
        shape and cached (``utils/timing.py``); for a host module the wall
        clock of its last call, as the JAX package times it."""
        if not self.is_neural:
            return max(self._host_seconds, 1e-9)
        key = tuple(left.shape)
        if key not in self._latency:
            self._latency[key] = forward_latency(
                self._forward, left, right, iters=LATENCY_ITERS,
                warmup=LATENCY_WARMUP)
        return self._latency[key]


def _forward_timed(runner, image1, image2):
    """Final prediction (on the runner's device) + FPS of its shape."""
    out = runner(image1, image2)[-1]
    return out, 1.0 / runner.latency(image1, image2)


def _prep(image1, image2, device="cpu"):
    """(H, W, 3) -> padded (1, H64, W64, 3) pair on ``device`` + padder."""
    i1 = torch.from_numpy(np.asarray(image1, np.float32)[None]).to(device)
    i2 = torch.from_numpy(np.asarray(image2, np.float32)[None]).to(device)
    padder = InputPadder(i1.shape, divis_by=64)
    i1, i2 = padder.pad(i1, i2)
    return i1, i2, padder


def _predict(runner, image1, image2, flow_gt):
    """The runner's final prediction for one sample, unpadded to the
    ground truth's (H, W, 1) as float32 numpy, and the FPS."""
    i1, i2, padder = _prep(image1, image2, runner.device)
    flow_pr, fps = _forward_timed(runner, i1, i2)
    flow_pr = padder.unpad(flow_pr.float()).cpu().numpy()[0]
    if flow_pr.shape != flow_gt.shape:
        raise ValueError(f"prediction {flow_pr.shape} against ground truth "
                         f"{flow_gt.shape}")
    return flow_pr, fps


def validate_eth3d(runner, root=None) -> dict:
    """Reference validate_eth3d (evaluate_stereo.py:33-104)."""
    val_dataset = datasets.ETH3D(aug_params={}, root=root)
    out_list, epe_list, fps_list = [], [], []
    for val_id in range(len(val_dataset)):
        _, image1, image2, flow_gt, valid_gt = val_dataset[val_id]
        flow_pr, fps = _predict(runner, image1, image2, flow_gt)
        epe = np.sqrt(((flow_pr - flow_gt) ** 2).sum(-1)).flatten()
        fpr = flow_pr.flatten()
        val = ((valid_gt.flatten() >= 0.5) & ~np.isnan(fpr) & (fpr < 0.0))
        image_out = [float((epe > t)[val].mean())
                     for t in (0.5, 1.0, 3.0, 5.0)]
        image_epe = float(epe[val].mean())
        logging.info("ETH3D %d out of %d. EPE: %.4f, D1: %.4f, FPS: %.4f.",
                     val_id + 1, len(val_dataset), image_epe, image_out[1], fps)
        if image_epe > 80.0:
            continue
        epe_list.append(image_epe)
        out_list.append(image_out)
        fps_list.append(fps)
    epe = float(np.mean(epe_list))
    bads = 100 * np.mean(np.array(out_list), axis=0)
    fps = float(np.mean(fps_list))
    print("Validation ETH3D: EPE=%.4f, bad0.5=%.4f, bad1.0=%.4f, bad3.0=%.4f,"
          " bad5.0=%.4f, FPS=%.4f" % (epe, *bads, fps))
    return {"eth3d-epe": epe, "eth3d-bad0.5": bads[0], "eth3d-bad1.0": bads[1],
            "eth3d-bad3.0": bads[2], "eth3d-bad5.0": bads[3], "eth3d-fps": fps}


def validate_kitti(runner, root=None) -> dict:
    """Reference validate_kitti (evaluate_stereo.py:108-162)."""
    val_dataset = datasets.KITTI(aug_params={}, root=root, image_set="training")
    out_list, epe_list, fps_list = [], [], []
    for val_id in range(len(val_dataset)):
        _, image1, image2, flow_gt, valid_gt = val_dataset[val_id]
        flow_pr, fps = _predict(runner, image1, image2, flow_gt)
        epe = np.sqrt(((flow_pr - flow_gt) ** 2).sum(-1)).flatten()
        fpr = flow_pr.flatten()
        val = ((valid_gt.flatten() >= 0.5) & ~np.isnan(fpr) & (fpr < 0.0))
        out = epe > 1.0
        image_epe = float(epe[val].mean())
        image_out = float(out[val].mean())
        if val_id < 9 or (val_id + 1) % 10 == 0:
            logging.info("KITTI %d out of %d. EPE: %.4f, D1: %.4f, FPS: %.4f.",
                         val_id + 1, len(val_dataset), image_epe, image_out,
                         fps)
        epe_list.append(image_epe)
        out_list.append(out[val])
        fps_list.append(fps)
    epe = float(np.mean(epe_list))
    d1 = 100 * float(np.concatenate(out_list).mean())
    fps = float(np.mean(fps_list))
    print("Validation KITTI: EPE %.4f, D1 %.4f, FPS: %.4f" % (epe, d1, fps))
    return {"kitti-epe": epe, "kitti-d1": d1, "kitti-fps": fps}


def validate_things(runner, root=None) -> dict:
    """Reference validate_things (evaluate_stereo.py:166-212)."""
    val_dataset = datasets.SceneFlowDatasets(
        root=root, dstype="frames_finalpass", things_test=True)
    out_list, epe_list, fps_list = [], [], []
    for val_id in range(len(val_dataset)):
        _, image1, image2, flow_gt, valid_gt = val_dataset[val_id]
        flow_pr, fps = _predict(runner, image1, image2, flow_gt)
        epe = np.sqrt(((flow_pr - flow_gt) ** 2).sum(-1)).flatten()
        fpr = flow_pr.flatten()
        val = ((valid_gt.flatten() >= 0.5)
               & (np.abs(flow_gt).flatten() < 192)
               & ~np.isnan(fpr) & (fpr < 0.0))
        out = epe > 1.0
        epe_list.append(float(epe[val].mean()))
        out_list.append(out[val])
        fps_list.append(fps)
    epe = float(np.mean(epe_list))
    d1 = 100 * float(np.concatenate(out_list).mean())
    fps = float(np.mean(fps_list))
    print("Validation THINGS: EPE %.4f, D1 %.4f, FPS: %.4f" % (epe, d1, fps))
    return {"things-epe": epe, "things-d1": d1, "things-fps": fps}


def validate_middlebury(runner, split="F", root=None) -> dict:
    """Reference validate_middlebury (evaluate_stereo.py:216-286)."""
    val_dataset = datasets.Middlebury(aug_params={}, root=root, split=split)
    out_list, epe_list, fps_list = [], [], []
    for val_id in range(len(val_dataset)):
        _, image1, image2, flow_gt, valid_gt = val_dataset[val_id]
        flow_pr, fps = _predict(runner, image1, image2, flow_gt)
        epe = np.sqrt(((flow_pr - flow_gt) ** 2).sum(-1)).flatten()
        fpr = flow_pr.flatten()
        val = ((np.asarray(valid_gt).reshape(-1) >= -0.5)
               & (flow_gt[..., 0].reshape(-1) > -1000)
               & ~np.isnan(fpr) & (fpr < 0.0))
        image_out = [float((epe > t)[val].mean())
                     for t in (0.5, 1.0, 3.0, 5.0)]
        image_epe = float(epe[val].mean())
        logging.info("MIDDLEBURY %d out of %d. EPE: %.4f, D1: %.4f, FPS: %.4f.",
                     val_id + 1, len(val_dataset), image_epe, image_out[1], fps)
        epe_list.append(image_epe)
        out_list.append(image_out)
        fps_list.append(fps)
    epe = float(np.mean(epe_list))
    bads = 100 * np.mean(np.array(out_list), axis=0)
    fps = float(np.mean(fps_list))
    print("Validation Middlebury: EPE=%.4f, bad0.5=%.4f, bad1.0=%.4f,"
          " bad3.0=%.4f, bad5.0=%.4f, FPS=%.4f" % (epe, *bads, fps))
    return {"middlebury-epe": epe, "middlebury-bad0.5": bads[0],
            "middlebury-bad1.0": bads[1], "middlebury-bad3.0": bads[2],
            "middlebury-bad5.0": bads[3], "middlebury-fps": fps}


def validate_synthetic(runner, n_images: int = 40, image_hw=(320, 448), max_disp: float = 64.0) -> dict:
    """Held-out procedural scenes (data/synthetic.py, seeds >= 10**6) with
    KITTI-style metric math -- the convergence gate when no benchmark
    datasets are mounted."""
    from realtime_stereo_matcher_tpu_torch.data.synthetic import (
        SyntheticStereo,
    )

    val_dataset = SyntheticStereo(aug_params=None, length=n_images,
                                  seed0=10 ** 6, image_hw=image_hw,
                                  max_disp=max_disp)
    out_list, epe_list, fps_list = [], [], []
    for val_id in range(len(val_dataset)):
        _, image1, image2, flow_gt, valid_gt = val_dataset[val_id]
        flow_pr, fps = _predict(runner, image1, image2, flow_gt)
        epe = np.sqrt(((flow_pr - flow_gt) ** 2).sum(-1)).flatten()
        fpr = flow_pr.flatten()
        val = ((valid_gt.flatten() >= 0.5) & ~np.isnan(fpr) & (fpr < 0.0))
        out = epe > 1.0
        epe_list.append(float(epe[val].mean()))
        out_list.append(out[val])
        fps_list.append(fps)
    epe = float(np.mean(epe_list))
    d1 = 100 * float(np.concatenate(out_list).mean())
    fps = float(np.mean(fps_list))
    print("Validation SYNTHETIC: EPE %.4f, D1 %.4f, FPS: %.4f" % (epe, d1, fps))
    return {"synthetic-epe": epe, "synthetic-d1": d1, "synthetic-fps": fps}


def run_validation(runner, dataset_names, *, data_root=None) -> dict:
    """Dispatch per config ``test.datasets`` (reference main, :322-337)."""

    def sub(name):
        return osp.join(data_root, name) if data_root else None

    results = {}
    for dataset in dataset_names:
        if dataset == "eth3d":
            results.update(validate_eth3d(runner, root=sub("ETH3D")))
        elif dataset == "kitti":
            results.update(validate_kitti(runner, root=sub("KITTI")))
        elif dataset in [f"middlebury_{s}" for s in "FHQ"] + ["middlebury_2014"]:
            results.update(validate_middlebury(
                runner, split=dataset.split("_")[-1], root=sub("Middlebury")))
        elif dataset == "things":
            results.update(validate_things(runner, root=sub("SceneFlow")))
        elif dataset == "synthetic":
            results.update(validate_synthetic(runner))
        else:
            raise ValueError(f"unknown test dataset: {dataset}")
    return results
