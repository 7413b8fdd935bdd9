"""Kernel-path inference for MobileStereoNet v1, v2 and v3 (port of
``realtime_stereo_matcher_tpu/models/fast_infer.py``).

``make_fast_forward(model)`` returns ``forward(left, right) -> [negative
disparity maps]`` that computes ``model(left, right)`` (eval mode) with every
3x3, 4x4 and 3x3x3 convolution on the hand-written kernels.  Per frame:

* v1 and v2: 56 stride-1 3x3 launches (7 per view in the encoder, 14 per
  RefineNet; v2's three 7 -> 32 refine entries among them), 6 stride-2 3x3
  launches (3 per view) and 5 3x3x3 launches (the cost filter);
* v3: 69 stride-1 3x3 launches (12 per view in the U-Net, 15 per
  RefineNet), 6 4x4 stride-2 launches (3 per view) and 5 3x3x3 launches.

v2's refinements warp the right RGB, v3's the right features, by the
disparity with the banded warp at ``refine_max_shifts`` (the kernel path
of the JAX package does the same; ``model(..., banded_warp=True)`` is the
plain path with that warp).

Normalization, the cost volume, soft-argmin, the resizes, the warp and v3's
up-projections and 1x1 skip mixes are plain PyTorch, as they were plain XLA
in the JAX package.

Inputs are zero-padded to a multiple of 2^down_factor, exactly as the model
pads them; the TPU-only alignment pad of the JAX package is not needed.
Weights are folded once, here, in the path's dtype.

A frame runs in stages: ``rsm.extract`` (normalise, pad, both views'
encoder or U-Net), ``rsm.cost`` (volume, cost filter, soft-argmin) and one
``rsm.refine.<level>`` a refine level (``.0`` to ``.2``); under a profiler each is a span inside
``rsm.forward`` (``utils/spans.py``).  On a CUDA device the forward replays
them as CUDA graphs, one per stage, once it has seen an input key twice
(:class:`GraphPolicy`): the same kernels and plain ops in the same order on
the same stream, issued by one ``cudaGraphLaunch`` call in each stage's
span instead of some 340-400 launches from Python.  The first call
of a key runs eagerly, the second captures (in the span ``rsm.capture``).
On CPU tensors every call runs eagerly.

MobileStereoNetV4 and MobileDispNetC have no kernel path, as in the JAX
package (:func:`has_kernel_path`): they run their plain forward.
"""

from __future__ import annotations

import collections
import functools
import types

import torch

from realtime_stereo_matcher_tpu_torch.kernels.cost_filter3d import (
    build_cost_filter_plan,
    fast_cost_filter,
)
from realtime_stereo_matcher_tpu_torch.kernels.encoder import (
    build_encoder_plan,
    fast_encoder,
)
from realtime_stereo_matcher_tpu_torch.kernels.refine_stack import (
    build_refine_plan,
    fast_refine,
)
from realtime_stereo_matcher_tpu_torch.kernels.unet import (
    build_unet_plan,
    fast_unet,
)
from realtime_stereo_matcher_tpu_torch.models.layers import normalize_images
from realtime_stereo_matcher_tpu_torch.models.stereo_net import (
    MobileStereoNet,
    MobileStereoNetV2,
    MobileStereoNetV3,
    _coarse_disparity,
    _full_res_nearest,
    refine_max_shifts,
)
from realtime_stereo_matcher_tpu_torch.ops import pad_to_multiple
from realtime_stereo_matcher_tpu_torch.utils.spans import (
    refine_span_names,
    span,
)


# the models with a kernel path (v1 and v2 share one)
KERNEL_PATH_MODELS = (MobileStereoNet, MobileStereoNetV2, MobileStereoNetV3)
# input keys whose graphs a forward keeps (:class:`GraphPolicy`)
MAX_GRAPH_KEYS = 4


def has_kernel_path(model) -> bool:
    """Whether ``make_fast_forward`` takes ``model`` (by its type)."""
    return type(model) in KERNEL_PATH_MODELS


def make_fast_forward(model, *, dtype=torch.bfloat16):
    """Build the kernel-path forward of a v1, v2 or v3 model (batch any,
    eval mode).

    The returned function takes NHWC uint8-range images on the model's
    device and returns 3 (B, H, W, 1) float32 negative disparity maps,
    coarse to fine, tensors of its own on every call.  On a CUDA device it
    replays CUDA graphs of its stages for inputs whose key it has seen
    before (:class:`GraphPolicy`); ``forward.graph_stats`` counts its calls
    by how they ran."""
    if not has_kernel_path(model):
        raise NotImplementedError(
            f"the kernel path supports MobileStereoNet v1, v2 and v3, not "
            f"{type(model).__name__}; see ROADMAP.md")
    stages = _stages(model, dtype)
    return GraphPolicy(functools.partial(run_stages, stages),
                       functools.partial(capture_stages, stages),
                       functools.partial(graph_key, dtype=dtype))


def _stages(model, dtype):
    """(span, fn(frame)) for each stage of the frame, in order; each fn
    reads and sets fields of the frame (:func:`run_stages`).  v1 and v2
    extract with the encoder and guide every refinement by the images (v2
    warps the right one); v3 extracts a U-Net pyramid whose finer levels
    are the refinements' guides."""
    v3 = type(model) is MobileStereoNetV3
    warp = type(model) is MobileStereoNetV2
    down = model.down_factor
    align = 2 ** down
    vol_disp = (model.max_disp + 1) // align
    if v3:
        unet_plan = build_unet_plan(model.feature_extractor, dtype=dtype)
    else:
        enc_plan = build_encoder_plan(model.feature_extractor, dtype=dtype)
    cf_plan = build_cost_filter_plan(model.cost_filter, dtype=dtype)
    refine_plans = [build_refine_plan(r, dtype=dtype) for r in
                    (model.refine_layers if v3 else model.refine_layer)]
    shifts = refine_max_shifts(model.max_disp, down)
    levels = len(refine_plans)

    def extract(f):
        f.left, f.orig_hw = pad_to_multiple(
            normalize_images(f.left_img, dtype), align)
        right, _ = pad_to_multiple(normalize_images(f.right_img, dtype), align)
        if v3:
            f.lf, *f.l_guides = fast_unet(f.left, unet_plan)
            f.rf, *f.r_guides = fast_unet(right, unet_plan)
        else:
            f.lf = fast_encoder(f.left, enc_plan)
            f.rf = fast_encoder(right, enc_plan)
            f.l_guides = [f.left] * levels
            f.r_guides = [right if warp else None] * levels

    def cost(f):
        f.x = _coarse_disparity(f.lf, f.rf, vol_disp,
                                lambda vol: fast_cost_filter(vol, cf_plan))

    def refine(i):
        def run(f):
            f.x = fast_refine(f.x, f.l_guides[i], refine_plans[i],
                              f.r_guides[i], shifts[i])
            f.maps.append(_full_res_nearest(f.x, f.left.shape[1:3],
                                            f.orig_hw))
        return run

    return (("rsm.extract", extract), ("rsm.cost", cost),
            *zip(refine_span_names(levels), map(refine, range(levels))))


def _frame(left_img, right_img):
    return types.SimpleNamespace(left_img=left_img, right_img=right_img,
                                 maps=[])


@torch.no_grad()
def run_stages(stages, left_img, right_img):
    """A frame run eagerly: each stage in its span inside ``rsm.forward``,
    then the maps negated."""
    f = _frame(left_img, right_img)
    with span("rsm.forward"):
        for name, stage in stages:
            with span(name):
                stage(f)
        return [-1.0 * m for m in f.maps]


@torch.no_grad()
def capture_stages(stages, left_img, right_img):
    """Capture each stage of a frame in a CUDA graph of its own, on static
    copies of these inputs, and return ``replay(left_img, right_img)``.

    As ``export.aot_compile`` does, the frame first runs once on the side
    stream that then captures.  The graphs share one memory pool, so
    ``replay`` runs them in the order they were captured: it copies the
    inputs into the static ones and replays the extract graph in
    ``rsm.extract``, then each other graph in its stage's span, all inside
    ``rsm.forward`` and on the current stream; it returns the graphs'
    maps negated, new tensors that no later replay overwrites."""
    dev = left_img.device
    f = _frame(left_img.clone(memory_format=torch.contiguous_format),
               right_img.clone(memory_format=torch.contiguous_format))
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)
    pool = torch.cuda.graph_pool_handle()
    graphs = []
    with span("rsm.capture"), torch.cuda.stream(side):
        run_stages(stages, f.left_img, f.right_img)
        for name, stage in stages:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=side):
                stage(f)
            graphs.append((name, graph))
    main.wait_stream(side)
    (extract_name, extract), rest = graphs[0], graphs[1:]

    @torch.no_grad()
    def replay(left, right):
        with span("rsm.forward"):
            with span(extract_name):
                f.left_img.copy_(left)
                f.right_img.copy_(right)
                extract.replay()
            for name, graph in rest:
                with span(name):
                    graph.replay()
            return [-1.0 * m for m in f.maps]

    return replay


def graph_key(left_img, right_img, *, dtype):
    """The key under which a call's stages are captured (device, the path's
    dtype, each input's shape and dtype), or None where the call always runs
    eagerly: CPU tensors, or a stream capture in progress."""
    if (left_img.device.type != "cuda"
            or torch.cuda.is_current_stream_capturing()):
        return None
    return (left_img.device, dtype, tuple(left_img.shape), left_img.dtype,
            tuple(right_img.shape), right_img.dtype)


class GraphPolicy:
    """A frame that replays what it has captured, by what its calls show.

    ``GraphPolicy(eager, capture, key)(left, right)``: where ``key(left,
    right)`` is None, ``eager(left, right)``.  Else the key's first call
    runs ``eager`` (which also builds the kernels and pays their one-time
    set-up); its second call runs ``capture(left, right)``, which returns
    the key's ``replay``, and then ``replay(left, right)``; every later call
    ``replay``.  At most ``MAX_GRAPH_KEYS`` (4) keys are kept, first sights
    included, the least recently used dropped with its graphs: inputs of
    ever new sizes, as a validator over Middlebury or ETH3D gives, never
    capture, and a few sizes (KITTI's) keep theirs.

    ``graph_stats`` counts the calls: ``eager``, ``captured`` (the calls
    that captured) and ``replayed``."""

    def __init__(self, eager, capture, key):
        self._eager, self._capture, self._key = eager, capture, key
        self._replays = collections.OrderedDict()  # key -> replay or None
        self.graph_stats = {"eager": 0, "captured": 0, "replayed": 0}

    def __call__(self, left_img, right_img):
        key = self._key(left_img, right_img)
        if key is None:
            return self._run("eager", self._eager, left_img, right_img)
        if key not in self._replays:
            self._replays[key] = None
            if len(self._replays) > MAX_GRAPH_KEYS:
                self._replays.popitem(last=False)
            return self._run("eager", self._eager, left_img, right_img)
        self._replays.move_to_end(key)
        replay = self._replays[key]
        if replay is not None:
            return self._run("replayed", replay, left_img, right_img)
        replay = self._replays[key] = self._capture(left_img, right_img)
        return self._run("captured", replay, left_img, right_img)

    def _run(self, how, fn, left_img, right_img):
        self.graph_stats[how] += 1
        return fn(left_img, right_img)
