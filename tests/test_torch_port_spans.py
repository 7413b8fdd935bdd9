"""The port's stage spans (``utils/spans.py``) on the CPU.

Under ``torch.profiler`` a kernel-path frame (v2, v3) records ``rsm.forward``
holding ``rsm.extract``, ``rsm.cost`` and ``rsm.refine.0`` to ``.2`` in that
order; a v2 kernel-path training step with the resident fetch and the
batched augmentation records ``rsm.fetch``, ``rsm.augment`` and
``rsm.step`` holding the forward's stages, then ``rsm.loss``,
``rsm.backward`` and ``rsm.optimizer``.  The kernel wrappers run their plain
versions on CPU tensors.  With no profiler a span is one shared null
context, a frame checks 6 times and a step 11, and what the paths compute
is bit-equal with and without the profiler.

On the card, a traced eager trigger's launch calls are one to one with its
device operations, and a replayed trigger (``models/fast_infer.py``'s CUDA
graphs) runs the same operations from ten launch calls.

This file imports no JAX.  Its card tests run on the card by

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_spans.py
"""

import collections
import json
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from realtime_stereo_matcher_tpu_torch.data import device_augment, device_cache  # noqa: E402
from realtime_stereo_matcher_tpu_torch.models import (  # noqa: E402
    build_model,
    fast_infer,
    fast_train,
)
from realtime_stereo_matcher_tpu_torch.train.optim import make_optimizer  # noqa: E402
from realtime_stereo_matcher_tpu_torch.train.trainer import TrainState  # noqa: E402
from realtime_stereo_matcher_tpu_torch.utils import profiler, spans  # noqa: E402

MODELS = {"v2": "MobileStereoNetV2", "v3": "MobileStereoNetV3"}
PARAMS = {"down_factor": 3, "max_disp": 48, "hidden_dim": 32}
FRAME = (2, 32, 64)        # batch, height, width
SCENES, SCENE_HW, CROP = 4, (40, 72), (32, 64)
STAGES = ("rsm.extract", "rsm.cost", "rsm.refine.0", "rsm.refine.1",
          "rsm.refine.2")
STEP_STAGES = STAGES + ("rsm.loss", "rsm.backward", "rsm.optimizer")
LOSS = {"loss_gamma": 0.9, "max_flow_magnitude": 700}


def _model(kind, seed=0, device="cpu"):
    torch.manual_seed(seed)
    return build_model({"type": MODELS[kind], "parameters": dict(PARAMS)},
                       device=device)


def _frame_inputs(seed=1):
    g = torch.Generator().manual_seed(seed)
    b, h, w = FRAME
    return [torch.randint(0, 256, (b, h, w, 3), generator=g).float()
            for _ in range(2)]


class _Trainer:
    """A v2 kernel-path step in float32 over four resident scenes, fed by
    the resident fetch and the batched augmentation."""

    def __init__(self, seed=0):
        self.model = _model("v2", seed)
        self.model.train()
        tx, _ = make_optimizer(self.model.parameters(), 2e-4, 100, 1e-5)
        self.state = TrainState(self.model, tx)
        self.step_fn = fast_train.make_fast_train_step(
            self.model, tx, LOSS, dtype=torch.float32)
        g = torch.Generator().manual_seed(seed + 1)
        h, w = SCENE_HW
        imgs = [torch.randint(0, 256, (SCENES, h, w, 3), generator=g,
                              dtype=torch.uint8) for _ in range(2)]
        disp = torch.randint(0, 20 * 512, (SCENES, h, w), generator=g)
        self.arrays = (*imgs, disp.to(torch.int16))
        self.augment = device_augment.make_device_augment(
            device_augment.AugmentSpec(src_hw=SCENE_HW, crop_size=CROP))

    def step(self, k):
        idx = torch.tensor([k % SCENES, (k + 1) % SCENES])
        batch = self.augment(k, *device_cache.fetch_scene_batch(
            self.arrays, idx))
        self.state, metrics = self.step_fn(self.state, *batch)
        return batch, metrics


def _program_spans(prof):
    """(name, start, end) of every ``rsm.`` host span, by start."""
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith("rsm.")]
    return sorted(out, key=lambda s: s[1])


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _program_spans(prof)


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _assert_in_order(found):
    for a, b in zip(found, found[1:]):
        assert a[2] <= b[1], (a, b)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_frame_records_forward_with_its_stages_in_order(kind):
    forward = fast_infer.make_fast_forward(_model(kind).eval(),
                                           dtype=torch.float32)
    left, right = _frame_inputs()
    _, found = _profiled(lambda: forward(left, right))
    assert [s[0] for s in found] == ["rsm.forward", *STAGES]
    outer, stages = found[0], found[1:]
    assert all(_inside(s, outer) for s in stages)
    _assert_in_order(stages)


def test_training_step_records_fetch_augment_and_step_stages():
    trainer = _Trainer()
    _, found = _profiled(lambda: trainer.step(0))
    names = [s[0] for s in found]
    assert names == ["rsm.fetch", "rsm.augment", "rsm.step", *STEP_STAGES]
    fetch, augment, step, stages = found[0], found[1], found[2], found[3:]
    _assert_in_order([fetch, augment, step])
    assert all(_inside(s, step) for s in stages)
    _assert_in_order(stages)


def test_span_is_the_shared_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert spans.span("rsm.a") is spans.span("rsm.b") is spans._NULL
    assert profiler.span is spans.span
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert spans.span("rsm.a") is not spans._NULL
    assert spans.refine_span_names(3) == ("rsm.refine.0", "rsm.refine.1",
                                          "rsm.refine.2")
    assert spans.refine_span_names(3) is spans.refine_span_names(3)


def _counting(monkeypatch, modules):
    calls = []

    def counted(name):
        calls.append(name)
        return spans.span(name)

    for module in modules:
        monkeypatch.setattr(module, "span", counted)
    return calls


def test_a_frame_checks_six_times_and_a_step_eleven(monkeypatch):
    calls = _counting(monkeypatch, [fast_infer, fast_train, device_cache,
                                    device_augment])
    forward = fast_infer.make_fast_forward(_model("v2").eval(),
                                           dtype=torch.float32)
    forward(*_frame_inputs())
    assert calls == ["rsm.forward", *STAGES]
    calls.clear()
    _Trainer().step(0)
    assert sorted(calls) == sorted(["rsm.fetch", "rsm.augment", "rsm.step",
                                    *STEP_STAGES])


def _assert_bit_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_frame_is_bit_equal_with_and_without_the_profiler(kind):
    forward = fast_infer.make_fast_forward(_model(kind).eval(),
                                           dtype=torch.float32)
    left, right = _frame_inputs()
    plain = forward(left, right)
    traced, found = _profiled(lambda: forward(left, right))
    assert found
    _assert_bit_equal(plain, traced)


def test_training_steps_are_bit_equal_with_and_without_the_profiler():
    runs = []
    for traced in (False, True):
        trainer = _Trainer()
        for k in range(2):
            if traced:
                (batch, metrics), _ = _profiled(lambda: trainer.step(k))
            else:
                batch, metrics = trainer.step(k)
        runs.append((list(batch), metrics,
                     {n: t.detach().clone()
                      for n, t in trainer.model.state_dict().items()}))
    (b0, m0, s0), (b1, m1, s1) = runs
    _assert_bit_equal(b0, b1)
    assert m0.keys() == m1.keys()
    _assert_bit_equal([m0[k] for k in sorted(m0)], [m1[k] for k in sorted(m1)])
    assert s0.keys() == s1.keys()
    _assert_bit_equal([s0[k] for k in sorted(s0)], [s1[k] for k in sorted(s1)])


def test_profiler_trace_file_holds_the_program_spans(tmp_path):
    forward = fast_infer.make_fast_forward(_model("v2").eval(),
                                           dtype=torch.float32)
    with profiler.trace(str(tmp_path)):
        forward(*_frame_inputs())
    (path,) = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"rsm.forward", *STAGES} <= names


def _card_v2_frame():
    """A bf16 v2 forward on the card and a trigger of 4 pairs, float32 and
    uint8 copies of the same values; the float32 key is warmed up (eager,
    captured, replayed), the uint8 key is new."""
    model = build_model({"type": MODELS["v2"], "parameters": {
        **PARAMS, "max_disp": 192}}, device="cuda").eval()
    forward = fast_infer.make_fast_forward(model, dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(0)
    left, right = [torch.randint(0, 256, (4, 256, 512, 3), generator=g,
                                 device="cuda", dtype=torch.uint8)
                   for _ in range(2)]
    for _ in range(3):
        forward(left.float(), right.float())
    torch.cuda.synchronize()
    return forward, left, right


def _traced_trigger(forward, left, right):
    """The :class:`stereobench.stages.Stages` of one traced trigger."""
    from stereobench import stages

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("bench.window"):
            forward(left, right)
            torch.cuda.synchronize()
    return stages.reduce(prof, window_span="bench.window", units=1)


@pytest.mark.cuda
def test_traced_v2_trigger_launches_match_its_device_operations():
    """On the card: the launch calls inside ``rsm.forward`` of a traced
    eager trigger (4 pairs; the first call of its input key) are one to one
    with the device operations it ran, and its operations on the port's
    kernels are the wrappers' own count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from realtime_stereo_matcher_tpu_torch.kernels import LAUNCHES
    from stereobench import stages, yardstick

    forward, left, right = _card_v2_frame()
    LAUNCHES.clear()
    eager = forward.graph_stats["eager"]
    st = _traced_trigger(forward, left, right)
    assert forward.graph_stats["eager"] == eager + 1
    assert st.has_program
    launches = st.launches(stages.FRAME)
    assert launches > sum(LAUNCHES.values()) > 0
    assert launches == st.device_ops(stages.FRAME)
    assert st.unlaunched_ops() == 0
    assert st.syncs(stages.FRAME) == 0
    port = [n for n, _, _ in st.launched_ops(stages.FRAME)
            if yardstick.is_port_kernel(n)]
    assert len(port) == sum(LAUNCHES.values())
    assert st.device_ms(["rsm.extract", "rsm.cost", "rsm.refine"]) == \
        pytest.approx(st.device_ms(stages.FRAME), rel=0.05)


def _op_name(name):
    """A device operation's name, with CUPTI's names of a copy or a memset
    made one: a graph's copy node reads ``Memcpy DtoD (Device -> Device)``
    or ``memcpy128``, its memset node ``Memset (Unknown)`` where the same
    call run eagerly reads ``Memset (Device)``."""
    if name.startswith(("Memcpy DtoD", "memcpy")):
        return "memcpy"
    return "memset" if name.startswith("Memset") else name


@pytest.mark.cuda
def test_traced_v2_replayed_trigger_runs_the_eager_operations():
    """On the card: a replayed trigger (the third call of its key) makes
    ten launch calls inside ``rsm.forward``, the two input copies, five
    ``cudaGraphLaunch`` (one in each stage's span) and the three negations;
    its device operations are the eager trigger's, by name and count, and
    the two copies; each has its launch, and the stages' device ms add up
    to the frame's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from stereobench import stages

    forward, left, right = _card_v2_frame()
    eager = _traced_trigger(forward, left, right)
    forward(left, right)                       # captures
    replayed = _traced_trigger(forward, left, right)
    assert forward.graph_stats == {"eager": 2, "captured": 2, "replayed": 2}

    calls = collections.Counter(
        "cudaGraphLaunch" if c.name.startswith("cudaGraphLaunch") else
        "kernel" if c.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
        else c.name for c in replayed.calls_in(stages.FRAME)
        if stages.is_launch(c.name))
    assert calls == {"cudaMemcpyAsync": 2, "cudaGraphLaunch": 5, "kernel": 3}
    assert replayed.launches(stages.FRAME) == 10
    for name in STAGES:
        assert sum(c.name.startswith("cudaGraphLaunch")
                   for c in replayed.calls_in([name])) == 1, name

    def ops(st):
        return collections.Counter(_op_name(n) for n, _, _ in
                                   st.launched_ops(stages.FRAME))

    assert ops(replayed) == ops(eager) + collections.Counter(memcpy=2)
    assert replayed.unlaunched_ops() == 0
    assert replayed.syncs(stages.FRAME) == 0
    assert replayed.device_ms(["rsm.extract", "rsm.cost", "rsm.refine"]) == \
        pytest.approx(replayed.device_ms(stages.FRAME), rel=0.05)
