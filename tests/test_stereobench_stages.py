"""The benchmark's reduction of the program's stages (``stereobench/stages.py``)
against hand counts, on hand-built profiler events: the program's ``rsm.``
spans, the CUDA runtime calls that launch work or block the host, the
device operations they launched (one from the backward's own thread), and
the device mirrors of the annotations.  The benchmark's own reduction
(``stereobench/trace.py``) and its eleven per-layer readers read the same
with the program's events in the trace and without them.
"""

import importlib.util
import pathlib
import sys
import types

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from stereobench import stages, trace  # noqa: E402

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
PORT_CONV = "void rsm::tc::conv_tc_kernel<1>(a)"
ELEMENTWISE = "void at::native::elementwise_kernel<1>(a)"


def _evt(name, start_us, end_us, *, device=CPU, corr=0, thread=1,
         annotation=False, device_us=0.0):
    return types.SimpleNamespace(
        name=name, device_type=device, id=corr, thread=thread,
        time_range=types.SimpleNamespace(start=start_us, end=end_us),
        is_user_annotation=annotation, device_time_total=device_us)


def _prof(events):
    return types.SimpleNamespace(events=lambda: events)


# one traced trigger, in us: the benchmark's spans around the program's
BENCH_FRAME = [
    _evt("bench.window", 0, 10_000),
    _evt("bench.wait for trigger", 0, 100),
    _evt("bench.forward enqueue", 100, 5_000, device_us=4_900),
    _evt("bench.synchronize", 5_000, 7_000),
    _evt("bench.wait for trigger", 7_000, 10_000),
]
PROGRAM_FRAME = [
    _evt("rsm.forward", 200, 4_800),
    _evt("rsm.extract", 300, 1_000),
    _evt("rsm.cost", 1_100, 2_000),
    _evt("rsm.refine.0", 2_100, 2_900),
    _evt("rsm.refine.1", 3_000, 3_800),
    _evt("rsm.refine.2", 3_900, 4_700),
    # launches: two in extract, a kernel and a memset in cost, one a level
    # (refine.1's through cuLaunchKernel), and a copy to the host after them
    _evt("cudaLaunchKernel", 400, 410, corr=1),
    _evt("cudaLaunchKernel", 500, 510, corr=2),
    _evt("cudaLaunchKernel", 1_200, 1_210, corr=3),
    _evt("cudaMemsetAsync", 1_300, 1_310, corr=4),
    _evt("cudaLaunchKernel", 2_200, 2_210, corr=5),
    _evt("cuLaunchKernel", 3_100, 3_110, corr=6),
    _evt("cudaLaunchKernel", 4_000, 4_010, corr=7),
    _evt("cudaMemcpyAsync", 4_750, 4_760, corr=8),
    _evt("cudaStreamSynchronize", 5_100, 6_900, corr=9),
    # the device mirrors of the annotations
    _evt("rsm.forward", 1_000, 6_100, device=CUDA, corr=10, annotation=True),
    _evt("rsm.extract", 1_000, 2_500, device=CUDA, corr=11, annotation=True),
    _evt("rsm.refine.2", 4_600, 6_000, device=CUDA, corr=12, annotation=True),
]
DEVICE_FRAME = [
    _evt(PORT_CONV, 1_000, 2_000, device=CUDA, corr=1),
    _evt(ELEMENTWISE, 2_000, 2_500, device=CUDA, corr=2),
    _evt(PORT_CONV, 2_500, 3_000, device=CUDA, corr=3),
    _evt("Memset (Device)", 3_000, 3_100, device=CUDA, corr=4),
    _evt(ELEMENTWISE, 3_100, 4_100, device=CUDA, corr=5),
    _evt(PORT_CONV, 4_400, 4_600, device=CUDA, corr=6),
    _evt(ELEMENTWISE, 4_600, 6_000, device=CUDA, corr=7),
    _evt("Memcpy DtoH (Device -> Pageable)", 6_000, 6_100, device=CUDA, corr=8),
]


def _frame(program=True):
    return BENCH_FRAME + DEVICE_FRAME + (PROGRAM_FRAME if program else [])


def _stages(events, units=1):
    return stages.reduce(_prof(events), window_span="bench.window", units=units)


def test_frame_launches_syncs_and_device_time_by_stage():
    st = _stages(_frame())
    assert st.launches(stages.FRAME) == 8
    assert st.device_ops(stages.FRAME) == 8
    # the copy to the host blocks; the synchronise lies outside the frame
    assert st.syncs(stages.FRAME) == 1
    assert st.syncs(["bench.synchronize"]) == 1
    assert st.launches(["rsm.extract"]) == 2
    assert st.device_ms(["rsm.extract"]) == pytest.approx(1.5)
    assert st.launches(["rsm.cost"]) == 2
    assert st.device_ms(["rsm.cost"]) == pytest.approx(0.6)
    # every refine level, and one alone
    assert st.launches(["rsm.refine"]) == 3
    assert st.device_ms(["rsm.refine"]) == pytest.approx(1.0 + 0.2 + 1.4)
    assert st.device_ms(["rsm.refine.1"]) == pytest.approx(0.2)
    assert st.device_ms(stages.FRAME) == pytest.approx(4.8)
    assert st.unlaunched_ops() == 0
    assert st.host_ms("rsm.forward") == pytest.approx(4.6)
    assert st.host_ms("rsm.refine") == pytest.approx(2.4)


def test_per_unit_counts_divide_by_the_units():
    st = _stages(_frame(), units=2)
    assert st.launches(stages.FRAME) == 4
    assert st.device_ms(["rsm.extract"]) == pytest.approx(0.75)


def test_stage_table_holds_each_stage_found():
    got = stages.table(_stages(_frame()), stages.FRAME)
    assert got["launches"] == 8 and got["syncs"] == 1
    assert set(got["stages"]) == {"rsm.extract", "rsm.cost", "rsm.refine"}
    assert got["stages"]["rsm.refine"]["launches"] == 3
    assert got["unlaunched_ops"] == 0


def test_an_operation_without_its_launch_is_counted_apart():
    events = [e for e in _frame() if e.name != "cuLaunchKernel"]
    st = _stages(events)
    assert st.launches(stages.FRAME) == 7
    assert st.device_ops(stages.FRAME) == 7
    assert st.unlaunched_ops() == 1


def test_the_backward_thread_launches_count_in_the_backward():
    step = [
        _evt("bench.window", 0, 10_000),
        _evt("bench.step", 100, 9_000),
        _evt("rsm.step", 200, 8_800),
        _evt("rsm.loss", 300, 1_000),
        _evt("rsm.backward", 1_100, 6_000),
        _evt("rsm.optimizer", 6_100, 8_700),
        _evt("cudaLaunchKernel", 400, 410, corr=1),
        # autograd's device thread, while the step's thread waits in backward
        _evt("cudaLaunchKernel", 1_500, 1_510, corr=2, thread=7),
        _evt("cudaLaunchKernel", 2_500, 2_510, corr=3, thread=7),
        _evt("cudaLaunchKernel", 6_500, 6_510, corr=4),
        _evt("cudaMemcpyAsync", 7_000, 7_010, corr=5),
        _evt(ELEMENTWISE, 500, 900, device=CUDA, corr=1),
        _evt(ELEMENTWISE, 1_600, 2_600, device=CUDA, corr=2),
        _evt(PORT_CONV, 2_600, 3_100, device=CUDA, corr=3),
        _evt(ELEMENTWISE, 6_600, 6_900, device=CUDA, corr=4),
        _evt("Memcpy DtoD (Device -> Device)", 7_100, 7_200, device=CUDA,
             corr=5),
        _evt("rsm.backward", 1_600, 3_100, device=CUDA, corr=6,
             annotation=True),
    ]
    st = _stages(step)
    assert st.device_ms(["rsm.backward"]) == pytest.approx(1.0 + 0.5)
    assert st.launches(["rsm.backward"]) == 2
    assert st.launches(stages.STEP) == 5
    # a copy on the card does not block the host
    assert st.syncs(stages.STEP) == 0


def test_idle_gaps_take_the_innermost_program_span():
    events = _frame()
    tr = trace.reduce(_prof(events), window_span="bench.window", units=1)
    st = _stages(events)
    labelled = st.idle_gaps(tr)
    assert [g[1] for g in labelled] == [g[1] for g in tr.idle_gaps()]
    # 0-1 ms: the device waits while the host is in extract (mid 0.5 ms)
    assert ("rsm.extract", pytest.approx(1e-3)) in labelled
    # 4.1-4.4 ms: mid 4.25 ms, inside refine.2's host span
    assert ("rsm.refine.2", pytest.approx(0.3e-3)) in labelled
    assert ("bench.wait for trigger", pytest.approx(3.9e-3)) in labelled
    # the benchmark's own labels name only its spans
    assert {g[0] for g in tr.idle_gaps()} <= {s.name for s in BENCH_FRAME}


def test_a_program_without_spans_reads_none():
    st = _stages(_frame(program=False))
    assert not st.has_program
    for read in (st.launches, st.syncs, st.device_ms, st.device_ops):
        assert read(stages.FRAME) is None
        assert read(stages.STEP) is None
    got = stages.table(st, stages.FRAME)
    assert got["launches"] is None and got["stages"] == {}


def test_the_window_must_be_there_once():
    with pytest.raises(RuntimeError, match="spans 'bench.window'"):
        _stages(DEVICE_FRAME + PROGRAM_FRAME)


# the benchmark's eleven per-layer readers
PER_LAYER = ("host_ms.stream", "conv_roofline_pct.stream", "plain_ms.stream",
             "mfu.stream", "idle_pct.stream", "host_ms.train",
             "conv_roofline_pct.train", "plain_ms.train", "data_ms.train",
             "mfu.train", "idle_pct.train")


def _reader(name):
    """A per-layer reader, loaded from its file as ``stereobench.run`` loads
    it (``stereobench.run`` itself is not imported: its import blocks JAX for
    the rest of the process)."""
    path = ROOT / "stereobench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "stereobench.metrics." + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _window(tr):
    return types.SimpleNamespace(
        trace=tr, host_s=[0.004, 0.005], service_s=[0.011, 0.012], units=3,
        window_s=0.05, flops_per_unit=1e9, conv_least_s_per_unit=2e-4)


@pytest.mark.parametrize("name", PER_LAYER)
def test_existing_readers_read_the_same_with_the_program_events(name):
    fetch = [_evt("bench.fetch and augment", 5_000, 5_050, device_us=300)]
    read = _reader(name)
    with_program = trace.reduce(_prof(_frame() + fetch),
                                window_span="bench.window", units=1)
    without = trace.reduce(_prof(_frame(program=False) + fetch),
                           window_span="bench.window", units=1)
    # no program annotation is counted as a device operation
    assert [k.name for k in with_program.kernels] == [
        k.name for k in without.kernels]
    got, want = read(_window(with_program)), read(_window(without))
    assert want is not None
    assert got == want


def test_idle_time_adds_up_by_the_innermost_span():
    events = _frame()
    tr = trace.reduce(_prof(events), window_span="bench.window", units=2)
    st = _stages(events, units=2)
    by_span = st.idle_ms_by_span(tr)
    assert by_span == pytest.approx({"bench.wait for trigger": 3.9 / 2,
                                     "rsm.extract": 1.0 / 2,
                                     "rsm.refine.2": 0.3 / 2})
    assert list(by_span)[0] == "bench.wait for trigger"
