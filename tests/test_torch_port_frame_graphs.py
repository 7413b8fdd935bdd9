"""When the kernel-path frame (``models/fast_infer.py``) replays CUDA graphs.

On the CPU, the capture policy (:class:`fast_infer.GraphPolicy`) with a fake
capturer whose replay writes into static buffers, as a graph does: a key's
first call runs eagerly and its second captures; later calls replay; CPU
tensors and calls made during a stream capture never capture; the least
recently used key is dropped at the bound; ``graph_stats`` counts every call;
every call returns tensors of its own.

On the card (``-m cuda``), v1, v2 and v3 at 256 x 512, batch 1 and 4, uint8
and float32 inputs: the replayed maps equal the eager ones bit for bit, and
maps kept from one call are unchanged after a replay on other inputs.

This file imports no JAX.  Its card tests run on the card by

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_frame_graphs.py
"""

import functools
import pathlib
import sys
import types

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from realtime_stereo_matcher_tpu_torch.models import build_model, fast_infer  # noqa: E402

MODELS = {"v1": "MobileStereoNet", "v2": "MobileStereoNetV2",
          "v3": "MobileStereoNetV3"}


class _FakeGraphs:
    """An eager frame and a capturer whose replay, like a graph's, copies
    its inputs into static buffers and computes into a static output, then
    returns that output negated."""

    def __init__(self):
        self.captured = []

    def eager(self, left, right):
        return [-1.0 * (left + right)]

    def capture(self, left, right):
        self.captured.append(tuple(left.shape))
        static_in = [left.clone(), right.clone()]
        static_out = torch.empty_like(left)

        def replay(l2, r2):
            static_in[0].copy_(l2)
            static_in[1].copy_(r2)
            torch.add(*static_in, out=static_out)
            return [-1.0 * static_out]

        return replay


def _by_shape(left, right):
    return tuple(left.shape)


def _inputs(h, w=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand((1, h, w, 3), generator=g) * 255 for _ in range(2)]


def _policy():
    fake = _FakeGraphs()
    return fake, fast_infer.GraphPolicy(fake.eager, fake.capture, _by_shape)


def _first_call_eager_second_captures():
    fake, forward = _policy()
    a = _inputs(2)
    first = forward(*a)
    assert forward.graph_stats == {"eager": 1, "captured": 0, "replayed": 0}
    assert fake.captured == []
    second = forward(*a)
    assert forward.graph_stats == {"eager": 1, "captured": 1, "replayed": 0}
    assert fake.captured == [(1, 2, 4, 3)]
    assert torch.equal(first[0], second[0])


def _later_calls_replay():
    fake, forward = _policy()
    for seed in range(5):
        x = _inputs(2, seed=seed)
        assert torch.equal(forward(*x)[0], fake.eager(*x)[0])
    assert forward.graph_stats == {"eager": 1, "captured": 1, "replayed": 3}
    assert len(fake.captured) == 1


def _cpu_tensors_never_capture():
    fake = _FakeGraphs()
    forward = fast_infer.GraphPolicy(
        fake.eager, fake.capture,
        functools.partial(fast_infer.graph_key, dtype=torch.float32))
    a = _inputs(2)
    for _ in range(4):
        forward(*a)
    assert forward.graph_stats == {"eager": 4, "captured": 0, "replayed": 0}
    assert fake.captured == []
    # the port's own forward on the CPU: every call eager
    torch.manual_seed(0)
    model = build_model({"type": MODELS["v2"], "parameters": {
        "down_factor": 3, "max_disp": 48, "hidden_dim": 32}},
        device="cpu").eval()
    port = fast_infer.make_fast_forward(model, dtype=torch.float32)
    x = _inputs(32, 64)
    outs = [port(*x) for _ in range(3)]
    assert port.graph_stats == {"eager": 3, "captured": 0, "replayed": 0}
    for a_map, b_map in zip(outs[0], outs[2]):
        assert torch.equal(a_map, b_map)


def _calls_during_a_capture_never_capture():
    with pytest.MonkeyPatch.context() as mp:
        _capturing_cuda_calls(mp)


def _capturing_cuda_calls(mp):
    """The key needs a CUDA tensor; a stand-in with its device, shape and
    dtype is all that :func:`fast_infer.graph_key` reads."""
    cuda = types.SimpleNamespace(device=torch.device("cuda", 0),
                                 shape=(1, 8, 8, 3), dtype=torch.uint8)
    capturing = {"now": True}
    mp.setattr(torch.cuda, "is_current_stream_capturing",
               lambda: capturing["now"])
    calls = []
    forward = fast_infer.GraphPolicy(
        lambda l, r: calls.append("eager"),
        lambda l, r: calls.append("capture") or (lambda l2, r2: None),
        functools.partial(fast_infer.graph_key, dtype=torch.bfloat16))
    for _ in range(3):
        forward(cuda, cuda)
    assert calls == ["eager"] * 3
    assert forward.graph_stats == {"eager": 3, "captured": 0, "replayed": 0}
    capturing["now"] = False
    assert fast_infer.graph_key(cuda, cuda, dtype=torch.bfloat16) == (
        torch.device("cuda", 0), torch.bfloat16, (1, 8, 8, 3), torch.uint8,
        (1, 8, 8, 3), torch.uint8)
    forward(cuda, cuda)
    forward(cuda, cuda)
    assert calls == ["eager"] * 4 + ["capture"]


def _least_recently_used_key_is_dropped():
    assert fast_infer.MAX_GRAPH_KEYS == 4
    fake, forward = _policy()
    a, b, c, d, e = (_inputs(h) for h in range(1, 6))
    for x in (a, b, c, d):
        forward(*x)        # seen: a, b, c, d
    forward(*a)            # a captured, now the most recent
    forward(*e)            # e seen: b, the least recent, dropped
    forward(*a)            # a replayed
    assert forward.graph_stats == {"eager": 5, "captured": 1, "replayed": 1}
    forward(*b)            # b is new again: eager; c dropped
    forward(*c)            # c is new again: eager; d dropped
    forward(*d)            # d is new again: eager; e dropped
    forward(*a)            # a, still kept: replayed
    forward(*e)            # e is new again: eager; b dropped
    forward(*c)            # c captured
    assert forward.graph_stats == {"eager": 9, "captured": 2, "replayed": 2}
    forward(*b)            # b is new again: eager; d dropped
    forward(*a)            # a replayed, e next to go
    forward(*d)            # d is new again: eager; e dropped
    forward(*e)            # e is new again: eager; c dropped
    forward(*c)            # c is new again: eager; b dropped
    assert forward.graph_stats == {"eager": 13, "captured": 2, "replayed": 3}
    assert fake.captured == [(1, 1, 4, 3), (1, 3, 4, 3)]


def _graph_stats_count_every_call():
    _, forward = _policy()
    sizes = [1, 2, 1, 1, 3, 2, 2, 2, 4, 5, 6, 1, 3, 3, 1, 5]
    for h in sizes:
        forward(*_inputs(h))
    assert sum(forward.graph_stats.values()) == len(sizes)


def _every_call_returns_tensors_of_its_own():
    _, forward = _policy()
    a, b = _inputs(2, seed=0), _inputs(2, seed=1)
    outs = [forward(*a) for _ in range(3)] + [forward(*b)]
    assert forward.graph_stats == {"eager": 1, "captured": 1, "replayed": 2}
    kept = [o[0].clone() for o in outs]
    ptrs = {o[0].data_ptr() for o in outs}
    assert len(ptrs) == len(outs)
    forward(*b)
    for o, k in zip(outs, kept):
        assert torch.equal(o[0], k)
    assert not torch.equal(outs[2][0], outs[3][0])


CASES = {
    "first_call_eager_second_captures": _first_call_eager_second_captures,
    "later_calls_replay": _later_calls_replay,
    "cpu_tensors_never_capture": _cpu_tensors_never_capture,
    "calls_during_a_capture_never_capture": _calls_during_a_capture_never_capture,
    "least_recently_used_key_is_dropped": _least_recently_used_key_is_dropped,
    "graph_stats_count_every_call": _graph_stats_count_every_call,
    "every_call_returns_tensors_of_its_own": _every_call_returns_tensors_of_its_own,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_policy(case):
    CASES[case]()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

HW = (256, 512)
PARAMS = {"down_factor": 3, "max_disp": 192, "hidden_dim": 32}


@functools.cache
def _card_forward(kind):
    torch.manual_seed(0)
    model = build_model({"type": MODELS[kind], "parameters": dict(PARAMS)},
                        device="cuda").eval()
    return fast_infer.make_fast_forward(model, dtype=torch.bfloat16)


def _card_inputs(batch, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randint(0, 256, (batch, *HW, 3), generator=g, device="cuda")
            .to(dtype) for _ in range(2)]


def _assert_bit_equal(a, b):
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == torch.float32
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32],
                         ids=["uint8", "float32"])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_replayed_frame_is_the_eager_frame(kind, batch, dtype):
    """Call 1 of a key runs eagerly, call 2 captures, call 3 replays: the
    three give the same maps bit for bit, and the maps kept from calls 1-3
    are unchanged after a replay on other inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    forward = _card_forward(kind)
    a, b = _card_inputs(batch, dtype, 0), _card_inputs(batch, dtype, 1)
    before = dict(forward.graph_stats)
    outs = [forward(*a) for _ in range(3)]
    after = {k: forward.graph_stats[k] - before[k] for k in before}
    assert after == {"eager": 1, "captured": 1, "replayed": 1}
    kept = [[m.clone() for m in o] for o in outs]
    other = forward(*b)
    assert forward.graph_stats["replayed"] == before["replayed"] + 2
    torch.cuda.synchronize()
    for o in outs[1:]:
        _assert_bit_equal(outs[0], o)
    for o, k in zip(outs, kept):
        _assert_bit_equal(o, k)
    assert not torch.equal(other[-1], outs[2][-1])
    assert other[-1].shape == (batch, *HW, 1)
