"""What the per-layer readers under ``metrics/`` compute from a run's
window (``loops/<loop>.Window``) and its traced sub-window; each returns
None where it finds nothing to read."""

from __future__ import annotations

from stereobench.yardstick import PEAK_FLOPS, is_conv_kernel, is_port_kernel

# the host span of an open loop's wait for a trigger's due time
WAIT_SPAN = "bench.wait for trigger"


def host_ms(window):
    """Mean host time of a trigger's forward call, or a step's fetch +
    augment + step call, from the call to its return with no synchronise
    (ms); the traced ones are left out, as the profiler slows the host."""
    if not window.host_s:
        return None
    return sum(window.host_s) / len(window.host_s) * 1e3


def conv_roofline_pct(window):
    """The least time of every convolution of the traced units
    (``yardstick.conv_work`` on the reference, bf16 bytes) over the device
    time of the kernels that compute convolutions (%)."""
    tr = window.trace
    if tr is None:
        return None
    device_s = tr.device_s(is_conv_kernel)
    if device_s <= 0:
        return None
    return 100.0 * window.conv_least_s_per_unit * tr.units / device_s


def plain_ms(window):
    """Device time a traced unit of the kernels that are not the port's own
    (ms)."""
    tr = window.trace
    if tr is None:
        return None
    return tr.device_s(lambda name: not is_port_kernel(name)) / tr.units * 1e3


def mfu_pct(window):
    """Model FLOPs of the units completed in the window (``FlopCounterMode``
    on the reference at the cell's shapes) over the window's time and the
    card's dense bf16 peak, 989 TFLOP/s (%)."""
    if window.units == 0:
        return None
    return 100.0 * window.flops_per_unit * window.units / window.window_s / PEAK_FLOPS


def mfu_service_pct(window):
    """Model FLOPs of the untraced triggers over the time the system spent
    serving them (each from its call to the end of the synchronise after
    its answer) and the card's dense bf16 peak (%).  An open loop's window
    time is set by the offered rate; its service time is the program's."""
    if not window.service_s:
        return None
    return (100.0 * window.flops_per_unit * len(window.service_s)
            / sum(window.service_s) / PEAK_FLOPS)


def idle_pct(window):
    """Share of the traced sub-window in which no operation ran on the
    device (%)."""
    tr = window.trace
    if tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def idle_in_service_pct(window):
    """Share of the traced sub-window, less the stretches in which the host
    waited for the next trigger, in which no operation ran on the device
    (%): an open loop's wait for its due time is the camera's, not the
    program's."""
    tr = window.trace
    if tr is None:
        return None
    serving = tr.outside(WAIT_SPAN)
    serving_s = sum(e - s for s, e in serving)
    if serving_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s(serving) / serving_s)
