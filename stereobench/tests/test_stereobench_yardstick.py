"""The benchmark's arithmetic against hand counts."""

import math
import types

import pytest
import torch
from torch import nn

from stereobench import trace, yardstick
from stereobench.run import _load_file, HERE


def test_percentile_matches_hand_counts():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert yardstick.percentile(xs, 50) == 3.0
    # rank (5 - 1) * 0.95 = 3.8: 4 + 0.8 * (5 - 4)
    assert yardstick.percentile(xs, 95) == pytest.approx(4.8)
    assert yardstick.percentile(xs, 0) == 1.0
    assert yardstick.percentile(xs, 100) == 5.0
    assert yardstick.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        yardstick.percentile([], 50)


def test_union_of_intervals_counts_overlap_once():
    ivs = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert yardstick.union_intervals(ivs) == [(0.0, 3.0), (5.0, 6.0)]
    assert yardstick.covered(ivs, 0.0, 10.0) == pytest.approx(4.0)
    assert yardstick.covered(ivs, 2.5, 5.5) == pytest.approx(1.0)
    assert yardstick.gaps(ivs, -1.0, 7.0) == [(-1.0, 0.0), (3.0, 5.0), (6.0, 7.0)]


def test_least_seconds_takes_the_larger_bound():
    # 989 GFLOP: 1 ms of operations; 3.35 GB: 1 ms of bytes
    assert yardstick.least_seconds(989e9, 0) == pytest.approx(1e-3)
    assert yardstick.least_seconds(0, 3.35e9) == pytest.approx(1e-3)
    assert yardstick.least_seconds(2 * 989e9, 3.35e9) == pytest.approx(2e-3)


def test_conv_work_counts_one_conv_by_hand():
    conv = nn.Conv2d(4, 8, 3, padding=1, bias=False)
    x = torch.empty(2, 4, 10, 12, device="meta")
    flops, seconds = yardstick.conv_work(conv.to("meta"), (x,))
    macs = 2 * 8 * 10 * 12 * 4 * 9
    assert flops == 2 * macs
    nbytes = 2 * (2 * 4 * 10 * 12 + 8 * 4 * 9 + 2 * 8 * 10 * 12)
    assert seconds == pytest.approx(yardstick.least_seconds(2 * macs, nbytes))
    # backward: the weight gradient, and the input gradient only where the
    # input needs one
    f2, s2 = yardstick.conv_work(conv.to("meta"), (x,), backward=True)
    assert f2 == 2 * flops and s2 == pytest.approx(2 * seconds)
    xg = x.clone().requires_grad_()
    f3, s3 = yardstick.conv_work(conv.to("meta"), (xg,), backward=True)
    assert f3 == 3 * flops and s3 == pytest.approx(3 * seconds)


def test_conv_work_counts_a_transposed_conv_by_hand():
    up = nn.ConvTranspose2d(6, 3, 2, stride=2).to("meta")
    x = torch.empty(1, 6, 5, 7, device="meta")
    flops, _ = yardstick.conv_work(up, (x,))
    assert flops == 2 * (5 * 7 * 6) * 3 * 4


def test_model_flops_agrees_with_conv_work_on_a_conv_stack():
    net = nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), nn.ReLU(),
                        nn.Conv2d(8, 8, 3, padding=1)).to("meta")
    x = torch.empty(1, 3, 16, 16, device="meta")
    assert yardstick.model_flops(net, (x,)) == yardstick.conv_work(net, (x,))[0]


@pytest.mark.parametrize("name, group", [
    ("void rsm::tc::conv_tc_kernel<1>(rsm::tc::ConvArgs)", "fused_conv3x3 32->32"),
    ("void rsm::tc::conv_tc_kernel<(int)3>(rsm::tc::ConvArgs)", "fused_conv3d 32->32"),
    ("void rsm::tc::conv_nin_tc_kernel<7>(args)", "fused_conv3x3 7->32"),
    ("void rsm::tc::conv_s2_tc_kernel<4>(args)", "fused_conv4x4_s2 32->32"),
    ("void rsm::tc::conv3d_nout_tc_kernel(args)", "fused_conv3d 32->1"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::Foo>(int)",
     "plain: at::native::vectorized_elementwise_kernel"),
])
def test_kernel_group(name, group):
    assert yardstick.kernel_group(name) == group


def test_conv_and_port_kernel_patterns():
    assert yardstick.is_port_kernel("void rsm::tc::conv_tc_kernel<1>(x)")
    assert not yardstick.is_port_kernel("sm90_xmma_fprop_implicit_gemm_bf16")
    assert yardstick.is_conv_kernel("sm90_xmma_fprop_implicit_gemm_bf16")
    assert yardstick.is_conv_kernel("void cutlass::Kernel2<cutlass_80_tensorop>(x)")
    assert not yardstick.is_conv_kernel(
        "void at::native::vectorized_elementwise_kernel<4>(int)")


def _trace():
    ks = [trace.Kernel("void rsm::tc::conv_tc_kernel<1>(a)", 0.0, 2.0),
          trace.Kernel("sm90_xmma_fprop_implicit_gemm", 1.0, 3.0),
          trace.Kernel("void at::native::elementwise_kernel<1>(a)", 5.0, 6.0),
          trace.Kernel("void at::native::elementwise_kernel<1>(a)", 9.0, 12.0)]
    spans = [("bench.window", 0.0, 10.0, 5.0), ("bench.wait for trigger", 3.0, 5.0, 0.0),
             ("bench.synchronize", 6.0, 10.0, 0.0), ("bench.fetch and augment", 4.6, 4.8, 0.25),
             ("bench.fetch and augment", 11.0, 12.0, 9.0)]
    return trace.Trace(ks, spans, 0.0, 10.0, units=2)


def test_trace_busy_idle_and_gaps():
    tr = _trace()
    assert tr.busy_s() == pytest.approx(3.0 + 1.0 + 1.0)  # last one clipped
    assert tr.outside("bench.wait for trigger") == [(0.0, 3.0), (5.0, 10.0)]
    assert tr.busy_s([(0.0, 3.0), (5.0, 10.0)]) == pytest.approx(3.0 + 1.0 + 1.0)
    assert tr.busy_s([(2.0, 5.5)]) == pytest.approx(1.0 + 0.5)
    assert tr.device_s(yardstick.is_conv_kernel) == pytest.approx(4.0)
    assert tr.idle_gaps() == [("bench.synchronize", 3.0),
                              ("bench.wait for trigger", 2.0)]
    assert dict(tr.by_group())["fused_conv3x3 32->32"] == pytest.approx(2.0)
    # only the spans that start inside the sub-window
    assert tr.span_device_s("bench.fetch and augment") == pytest.approx(0.25)


def _reader(name):
    return _load_file(HERE / "metrics" / f"{name}.py").read


def test_readers_against_hand_counts():
    tr = _trace()
    w = types.SimpleNamespace(
        trace=tr, latencies_s=[0.010, 0.012, 0.011, 0.030], failed=0,
        host_s=[0.002, 0.004], service_s=[0.25, 0.75], units=4, window_s=2.0,
        flops_per_unit=989e9,
        conv_least_s_per_unit=0.5, setup_s=7.5)
    assert _reader("idle_pct.train")(w) == pytest.approx(50.0)
    # the wait for the trigger (3-5 s) left out: 5 s busy of 8 s serving
    assert _reader("idle_pct.stream")(w) == pytest.approx(100.0 * (1 - 5.0 / 8.0))
    # 2 units x 0.5 s of least time over 4 s of conv kernels
    assert _reader("conv_roofline_pct.stream")(w) == pytest.approx(25.0)
    # 2 s of non-port kernels inside the window over 2 units
    assert _reader("plain_ms.stream")(w) == pytest.approx(
        (2.0 + 1.0 + 1.0) / 2 * 1e3)
    # 4 x 989 GFLOP in 2 s at 989 TFLOP/s
    assert _reader("mfu.train")(w) == pytest.approx(0.2)
    # 2 untraced triggers x 989 GFLOP in 1 s of service, whatever the rate
    assert _reader("mfu.stream")(w) == pytest.approx(0.2)
    w.window_s = 20.0
    assert _reader("mfu.stream")(w) == pytest.approx(0.2)
    assert _reader("mfu.train")(w) == pytest.approx(0.02)
    w.window_s = 2.0
    assert _reader("host_ms.stream")(w) == pytest.approx(3.0)
    assert _reader("frame_p50_ms")(w) == pytest.approx(11.5)
    assert _reader("frame_p95_ms")(w) == pytest.approx(
        (0.012 + 0.85 * (0.030 - 0.012)) * 1e3)
    assert _reader("setup_s")(w) == 7.5
    w.pairs_per_unit = 32
    assert _reader("train_pairs_per_s")(w) == pytest.approx(4 * 32 / 2.0)
    assert _reader("data_ms.train")(w) == pytest.approx(0.25 / 2 * 1e3)
    for name in ("conv_roofline_pct", "plain_ms", "host_ms"):
        assert _reader(f"{name}.train")(w) == _reader(f"{name}.stream")(w)
    w.failed = 1
    assert math.isinf(_reader("frame_p95_ms")(w))


def test_readers_find_nothing_without_a_trace():
    w = types.SimpleNamespace(trace=None, host_s=[], service_s=[], units=0)
    for name in ("idle_pct.stream", "conv_roofline_pct.stream",
                 "plain_ms.stream", "host_ms.stream", "mfu.stream",
                 "data_ms.train", "train_pairs_per_s"):
        assert _reader(name)(w) is None
