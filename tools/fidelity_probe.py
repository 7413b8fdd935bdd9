#!/usr/bin/env python3
"""Two numerical probes of the port's training steps on one CUDA card.

    python3 tools/fidelity_probe.py dispnetc [--out DIR]
    python3 tools/fidelity_probe.py nondeterminism [--out DIR]

``dispnetc``: the first float32 training step of MobileDispNetC at its
repo config (``configure/disp_net_c_config.json``: batch 8, 256 x 320,
the train-start init of ``create_train_state``, one seeded synthetic
batch: the step ``chip_smoke.py`` phase 10c checks) on the card and on the
CPU, both held layer by layer to the CPU's float64 step.  Every module's
output (forward, in call order), the gradient reaching it (backward, in
the order the backward reaches it) and every parameter's gradient is
compared by relative L2; named: the first whose card value strays past
1e-5 while the CPU's does not, and the first that strays past 10 x the
CPU's.  Counted: the outputs on the other side of 0 from float64's (a
ReLU's or leaky ReLU's input there switches its slope).  Then the card's
whole step again under other cuDNN settings (``benchmark``,
``deterministic``, cuDNN off: PyTorch's own convolutions); every device
kernel of the step by the profiler; and for the conv of the worst
parameter its kernels and how far its weight gradient's float64 sum
cancels (``||sum |x| |g|| / ||sum x g||``).

``nondeterminism``: the first float32 step of v2's repo config on the
kernel path (``chip_smoke._dp_step``: batch 8, 240 x 320) run twice, with
the count of gradients that differ between the two runs, (a) by default,
(b) under ``torch.use_deterministic_algorithms(True, warn_only=True)``,
and (c) with one suspect at a time made deterministic (:func:`det_backward`:
the suspect alone runs under deterministic algorithms, forward and
backward).  Then in rounds: the backward traced node by node twice, the
first node whose gradients in are the same bits in both runs and whose
gradients out are not is named, its suspect made deterministic, and the
step traced again, until no node differs or the node is no suspect's.

Both print one JSON line and write it to ``DIR/<probe>.json`` (default
``chiprun_out/fidelity``), then the card's ``nvidia-smi`` name and power
limit as the last line.  TF32 is off, as in ``chip_smoke.py``.  Needs one
CUDA card and nvcc (the kernel step builds the kernels); imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import pathlib
import subprocess
import sys
import time
import warnings

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repo root is on the path from here)
from realtime_stereo_matcher_tpu_torch.config import load_config  # noqa: E402
from realtime_stereo_matcher_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticBatches,
)
from realtime_stereo_matcher_tpu_torch.kernels import refine_stack  # noqa: E402
from realtime_stereo_matcher_tpu_torch.models import fast_train  # noqa: E402
from realtime_stereo_matcher_tpu_torch.train.loss import (  # noqa: E402
    build_loss_function,
)
from realtime_stereo_matcher_tpu_torch.train.trainer import (  # noqa: E402
    create_train_state,
)

# a module's card output strays where its relative L2 from float64 passes
STRAY = 1e-5


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.double().cpu()
    return float((got.double().cpu() - want).norm()) / (
        float(want.norm()) + 1e-30)


# ---------------------------------------------------------------------------
# dispnetc: the float32 step layer by layer
# ---------------------------------------------------------------------------


def _first_tensor(out):
    if torch.is_tensor(out):
        return out
    if isinstance(out, (tuple, list)):
        return next((t for t in out if torch.is_tensor(t)), None)
    return None


def traced_step(model, batch, loss_fn, dtype) -> dict:
    """One plain train-mode step of a copy of ``model`` in ``dtype`` with
    every module's output and the gradient reaching it recorded by name
    (``name#i`` for the i-th call of a module called more than once), in
    call order and in the order the backward reaches them."""
    model = copy.deepcopy(model).to(dtype).train()
    fwd, bwd, calls = {}, {}, {}

    def hook(name):
        def record(_, __, out):
            t = _first_tensor(out)
            if t is None or not t.is_floating_point():
                return
            i = calls.get(name, 0)
            calls[name] = i + 1
            key = f"{name}#{i}"
            fwd[key] = t.detach().double().cpu()
            if t.requires_grad:
                t.register_hook(lambda g: bwd.__setitem__(
                    key, g.detach().double().cpu()))
        return record

    handles = [m.register_forward_hook(hook(n or "model"))
               for n, m in model.named_modules()]
    img1, img2, flow, valid = batch
    preds = model(img1.to(dtype), img2.to(dtype))
    loss = loss_fn(preds, flow, valid)
    loss.backward()
    for h in handles:
        h.remove()
    grads = {k: p.grad.detach().double().cpu()
             for k, p in model.named_parameters()}
    return dict(loss=float(loss.detach()), fwd=fwd, bwd=bwd, grads=grads)


def _first_stray(card: dict, cpu: dict) -> str | None:
    return next((k for k in card if card[k] > STRAY >= cpu[k]), None)


def _first_ratio_stray(card: dict, cpu: dict, ratio: float = 10.0):
    """The first key where the card strays past ``STRAY`` and past
    ``ratio`` x the CPU's distance (the CPU's float32 passes ``STRAY``
    itself at many layers of the backward)."""
    return next((k for k in card
                 if card[k] > max(STRAY, ratio * cpu[k])), None)


def _layer_table(card: dict, cpu: dict, upto: int = 12) -> list:
    rows, first = [], _first_stray(card, cpu)
    keys = list(card)
    end = keys.index(first) + 1 if first else min(len(keys), upto)
    for k in keys[max(0, end - upto):end]:
        rows.append([k, card[k], cpu[k]])
    return rows


def _worst_grad(grads: dict, want: dict) -> tuple[float, str]:
    rel = {k: rel_l2(g, want[k]) for k, g in grads.items()
           if float(want[k].norm()) >= 1e-3}
    k = max(rel, key=rel.get)
    return rel[k], k


@contextlib.contextmanager
def cudnn_setting(**flags):
    saved = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(torch.backends.cudnn, k, v)


def _module_kernels(model, name: str, batch, loss_fn) -> list:
    """The device kernels (by the profiler) of module ``name``'s forward
    and backward in float32 on the inputs the step gave it: the names of
    its algorithms."""
    from torch.profiler import ProfilerActivity, profile

    model = copy.deepcopy(model).float().train()
    mod = dict(model.named_modules())[name.split("#")[0]]
    call, seen = int(name.split("#")[1]), []

    def keep(_, args):
        seen.append([a.detach().clone().requires_grad_(a.is_floating_point())
                     for a in args if torch.is_tensor(a)])

    handle = mod.register_forward_pre_hook(keep)
    img1, img2, _, _ = batch
    with torch.no_grad():
        model(img1, img2)
    handle.remove()
    inputs = seen[call]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        out = _first_tensor(mod(*inputs))
        out.backward(torch.ones_like(out))
        if out.is_cuda:
            torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type.name == "CUDA"})


def probe_dispnetc(device) -> dict:
    cfg = load_config(ROOT / "configure" / "disp_net_c_config.json")
    hw, b = tuple(cfg.data.image_size), cfg.train.batch_size
    model, *_ = create_train_state(cfg, device="cpu")
    loss_fn = build_loss_function({"type": cfg.train.loss.type,
                                   "parameters": cfg.train.loss.parameters})
    batch = next(iter(SyntheticBatches(
        b, hw, seed0=chip_smoke.SEED, max_disp=96.0 * hw[1] / 640)))[1:]
    card_batch = tuple(t.to(device) for t in batch)
    t0 = time.perf_counter()
    want = traced_step(model, batch, loss_fn, torch.float64)
    cpu = traced_step(model, batch, loss_fn, torch.float32)
    card_model = copy.deepcopy(model).to(device)
    card = traced_step(card_model, card_batch, loss_fn, torch.float32)
    steps_s = time.perf_counter() - t0

    def by_key(side, what):
        return {k: rel_l2(v, want[what][k]) for k, v in side[what].items()}

    fwd_card, fwd_cpu = by_key(card, "fwd"), by_key(cpu, "fwd")

    def flips(side):  # outputs on the other side of 0 from float64's
        return {k: int(((v > 0) != (want["fwd"][k] > 0)).sum())
                for k, v in side["fwd"].items()}
    # the backward reaches the modules in reverse call order
    order = list(reversed(list(want["fwd"])))
    bwd_card = {k: rel_l2(card["bwd"][k], want["bwd"][k]) for k in order
                if k in want["bwd"] and k in card["bwd"]}
    bwd_cpu = {k: rel_l2(cpu["bwd"][k], want["bwd"][k]) for k in bwd_card}
    out = dict(
        batch=b, crop=hw, steps_s=steps_s, stray=STRAY,
        loss=dict(cpu_float64=want["loss"], cpu_float32=cpu["loss"],
                  card_float32=card["loss"]),
        grad_worst=dict(card=_worst_grad(card["grads"], want["grads"]),
                        cpu=_worst_grad(cpu["grads"], want["grads"])),
        sign_flips={k: [n, flips(cpu)[k]] for k, n in flips(card).items()
                    if n or flips(cpu)[k]},
        forward=dict(first_stray=_first_stray(fwd_card, fwd_cpu),
                     worst_card=max(fwd_card.values()),
                     worst_cpu=max(fwd_cpu.values()),
                     table=_layer_table(fwd_card, fwd_cpu)),
        backward=dict(first_stray=_first_stray(bwd_card, bwd_cpu),
                      first_10x_cpu=_first_ratio_stray(bwd_card, bwd_cpu),
                      worst_card=max(bwd_card.values()),
                      worst_cpu=max(bwd_cpu.values()),
                      table=[[k, bwd_card[k], bwd_cpu[k]]
                             for k in bwd_card]))
    # the parameters' gradients, in the order the backward makes them
    params = [k for k in reversed(list(want["grads"]))
              if float(want["grads"][k].norm()) >= 1e-3]
    p_card = {k: rel_l2(card["grads"][k], want["grads"][k]) for k in params}
    p_cpu = {k: rel_l2(cpu["grads"][k], want["grads"][k]) for k in params}
    out["params"] = dict(
        first_stray=_first_stray(p_card, p_cpu),
        first_10x_cpu=_first_ratio_stray(p_card, p_cpu),
        card_over_10x_cpu=[[k, p_card[k], p_cpu[k]] for k in params
                           if p_card[k] > 10 * p_cpu[k]],
        table=[[k, p_card[k], p_cpu[k]] for k in params])
    settings = {"default": {}, "benchmark": dict(benchmark=True),
                "deterministic": dict(deterministic=True),
                "cudnn_off": dict(enabled=False)}
    out["settings"] = {}
    for name, flags in settings.items():
        with cudnn_setting(**flags):
            step = traced_step(card_model, card_batch, loss_fn, torch.float32)
        out["settings"][name + "_params"] = {
            k: rel_l2(step["grads"][k], want["grads"][k]) for k in params}
        out["settings"][name + "_sign_flips"] = {
            k: n for k, n in flips(step).items() if n}
        fc = by_key(step, "fwd")
        bc = {k: rel_l2(step["bwd"][k], want["bwd"][k]) for k in bwd_card}
        out["settings"][name] = dict(
            grad_worst=_worst_grad(step["grads"], want["grads"]),
            forward_first_stray=_first_stray(fc, fwd_cpu),
            forward_worst=max(fc.values()),
            backward_first_stray=_first_stray(bc, bwd_cpu),
            backward_worst=max(bc.values()))
    out["step_kernels"] = _step_kernels(card_model, card_batch, loss_fn)
    worst = out["grad_worst"]["card"][1].rsplit(".", 1)[0]
    out["worst_param_module"] = dict(
        name=worst, kernels=_module_kernels(card_model, f"{worst}#0",
                                            card_batch, loss_fn))
    if type(dict(model.named_modules())[worst]) is torch.nn.Conv2d:
        out["worst_param_module"].update(
            _wgrad_condition(model, worst, batch, loss_fn))
    return out


def _step_kernels(model, batch, loss_fn) -> list:
    """Every device kernel of the float32 card step, by the profiler, with
    its count: the names say each one's arithmetic (``ffma``, ``tf32``)."""
    from torch.profiler import ProfilerActivity, profile

    model = copy.deepcopy(model).float().train()
    img1, img2, flow, valid = batch
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        loss_fn(model(img1, img2), flow, valid).backward()
        if img1.is_cuda:
            torch.cuda.synchronize()
    return sorted([e.key[:160], e.count] for e in prof.key_averages()
                  if e.device_type.name == "CUDA")


def _wgrad_condition(model, name: str, batch, loss_fn) -> dict:
    """The float64 weight gradient of conv ``name`` (over both its calls)
    against the same sum of absolute terms: ``||sum |x| * |g|||`` over
    ``||sum x * g||``, how far its float32 sum cancels, and the terms a
    weight sums."""
    model = copy.deepcopy(model).double().train()
    conv = dict(model.named_modules())[name]
    seen = []

    def keep(_, args, out):
        x = args[0]
        out.register_hook(lambda g: seen.append((x.detach(), g.detach())))

    handle = conv.register_forward_hook(keep)
    img1, img2, flow, valid = batch
    loss_fn(model(img1.double(), img2.double()), flow, valid).backward()
    handle.remove()
    kw = dict(stride=conv.stride, padding=conv.padding,
              dilation=conv.dilation, groups=conv.groups)
    shape = conv.weight.shape
    grad = sum(torch.nn.grad.conv2d_weight(x, shape, g, **kw)
               for x, g in seen)
    absolute = sum(torch.nn.grad.conv2d_weight(x.abs(), shape, g.abs(), **kw)
                   for x, g in seen)
    terms = sum(g.shape[0] * g.shape[2] * g.shape[3] for _, g in seen)
    return dict(condition=float(absolute.norm() / grad.norm()),
                terms_per_weight=terms,
                grad_matches_step=rel_l2(grad, conv.weight.grad))


# ---------------------------------------------------------------------------
# nondeterminism: the float32 v2 kernel step run twice
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms inside the block (``warn_only``: an op
    without a deterministic form runs as it is)."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


class _DetBackward(torch.autograd.Function):
    """``fn(*args)`` run under deterministic algorithms, forward and
    backward, the rest of the step not: the forward is run again with grad
    in the backward and differentiated there.  Some ops pick their
    deterministic form in the forward (``F.interpolate``'s bilinear mode
    then runs a decomposition whose backward is ``index_put``)."""

    @staticmethod
    def forward(ctx, fn, args, kwargs, pos, *tensors):
        ctx.fn, ctx.args, ctx.kwargs, ctx.pos = fn, args, kwargs, pos
        ctx.save_for_backward(*tensors)
        with torch.no_grad(), deterministic():
            return fn(*args, **kwargs)

    @staticmethod
    def backward(ctx, grad):
        leaves = [t.detach().requires_grad_(t.requires_grad)
                  for t in ctx.saved_tensors]
        args = list(ctx.args)
        for i, leaf in zip(ctx.pos, leaves):
            args[i] = leaf
        need = [leaf for leaf in leaves if leaf.requires_grad]
        with torch.enable_grad(), deterministic():
            out = ctx.fn(*args, **ctx.kwargs)
            got = iter(torch.autograd.grad(out, need, grad))
        return (None, None, None, None,
                *[next(got) if leaf.requires_grad else None
                  for leaf in leaves])


def det_backward(fn):
    """``fn`` with its backward alone under deterministic algorithms."""

    def run(*args, **kwargs):
        pos = [i for i, a in enumerate(args) if torch.is_tensor(a)]
        if not any(args[i].requires_grad for i in pos):
            return fn(*args, **kwargs)
        return _DetBackward.apply(fn, args, kwargs, pos,
                                  *[args[i] for i in pos])

    return run


# the suspects: (label, module, attribute) patched at the step's call site
SUSPECTS = {
    "cost volume (shift_stack's index backward)": (
        fast_train, "difference_cost_volume"),
    "bilinear disparity upsample (F.interpolate backward)": (
        refine_stack, "resize_rows"),
    "banded warp (index_select taps)": (
        refine_stack, "warp_rows"),
    "plain convs (cuDNN: encoder stride-2 and head)": (
        fast_train, "_conv2d_nhwc"),
}


# the autograd node names each suspect's backward runs
NODE_SUSPECTS = {
    "cost volume (shift_stack's index backward)": ("IndexBackward0",),
    "bilinear disparity upsample (F.interpolate backward)": (
        "UpsampleBilinear2DBackward0", "UpsampleBilinear2DBackward1",
        "_Upsample2xBackward"),
    "banded warp (index_select taps)": ("IndexSelectBackward0",),
    "plain convs (cuDNN: encoder stride-2 and head)": (
        "ConvolutionBackward0",),
}


@contextlib.contextmanager
def patched(names):
    saved = []
    for label in names:
        mod, attr = SUSPECTS[label]
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, det_backward(getattr(mod, attr)))
    try:
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def _differing(runs: list) -> int:
    a, b = runs[0]["grads"], runs[1]["grads"]
    return sum(not torch.equal(a[k], b[k]) for k in a)


def probe_nondeterminism(device) -> dict:
    cfg, batch = chip_smoke._dp_config_and_batch(device)

    def twice():
        return [chip_smoke._dp_step(cfg, device, torch.float32, batch)
                for _ in range(2)]

    runs = twice()
    out = dict(gradients=len(runs[0]["grads"]), default=_differing(runs),
               default_again=_differing(twice()))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            det = twice()
        finally:
            torch.use_deterministic_algorithms(False)
    out["deterministic"] = _differing(det)
    out["deterministic_warnings"] = sorted({
        str(w.message).split(".")[0][:200] for w in caught})
    out["one_suspect_deterministic"] = {}
    for label in SUSPECTS:
        with patched([label]):
            runs = twice()
        out["one_suspect_deterministic"][label] = _differing(runs)
    with patched(list(SUSPECTS)):
        out["all_suspects_deterministic"] = _differing(twice())
    # which gradients differ by default, by top-level module
    runs = twice()
    differ = [k for k in runs[0]["grads"]
              if not torch.equal(runs[0]["grads"][k], runs[1]["grads"][k])]
    out["default_differing_by_module"] = {
        m: sum(k.startswith(m + ".") for k in differ)
        for m in sorted({k.split(".")[0] for k in runs[0]["grads"]})}
    out["default_equal"] = sorted(set(runs[0]["grads"]) - set(differ))
    # rounds: trace the backward twice, name the first node that turns the
    # same gradients in into other bits out, make its suspect's backward
    # deterministic, and trace again, until no node or an unknown one
    fixed, out["rounds"] = [], []
    for _ in range(len(SUSPECTS) + 1):
        with patched(fixed):
            nodes = first_nondeterministic_nodes(cfg, device, batch)
            nodes["differing_gradients"] = _differing(twice())
        nodes["deterministic_backward"] = list(fixed)
        out["rounds"].append(nodes)
        label = next((k for k, names in NODE_SUSPECTS.items()
                      if nodes["first"] in names), None)
        if label is None or label in fixed:
            break
        fixed.append(label)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out["nodes_deterministic"] = first_nondeterministic_nodes(
            cfg, device, batch)
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def _fingerprint(ts) -> list:
    """Cheap exact-enough fingerprints of a backward node's gradients: any
    changed bit moves a float64 sum of the values or of their squares."""
    out = []
    for t in ts:
        if t is None or not t.is_floating_point():
            out.append(None)
            continue
        d = t.detach().double()
        out.append((float(d.sum()), float((d * d).sum())))
    return out


def node_trace(cfg, device, batch) -> list:
    """The backward of one float32 v2 kernel step, node by node in the
    order the engine runs them: (name, fingerprints of the gradients in,
    of the gradients out)."""
    from realtime_stereo_matcher_tpu_torch.models.fast_train import (
        fast_train_forward,
    )

    model, *_ = create_train_state(cfg, device=device)
    loss_fn = build_loss_function({"type": cfg.train.loss.type,
                                   "parameters": cfg.train.loss.parameters})
    img1, img2, flow, valid = batch
    preds, _ = fast_train_forward(model, img1, img2, dtype=torch.float32)
    loss = loss_fn(preds, flow, valid)
    trace, seen, todo = [], set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        node.register_hook(lambda gin, gout, n=node: trace.append(
            (n.name(), _fingerprint(gout), _fingerprint(gin))))
        todo.extend(nxt for nxt, _ in node.next_functions)
    loss.backward()
    torch.cuda.synchronize()
    return trace


def first_nondeterministic_nodes(cfg, device, batch) -> dict:
    """Two traces of the same step: the nodes whose gradients in are the
    same bits in both runs and whose gradients out are not, by name."""
    a, b = (node_trace(cfg, device, batch) for _ in range(2))
    assert [n for n, *_ in a] == [n for n, *_ in b]
    found, first = {}, None
    for (name, gin_a, gout_a), (_, gin_b, gout_b) in zip(a, b):
        if gin_a == gin_b and gout_a != gout_b:
            found[name] = found.get(name, 0) + 1
            first = first or name
    return dict(nodes=len(a), first=first, by_name=found,
                differing_out=sum(x[2] != y[2] for x, y in zip(a, b)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("probe", choices=("dispnetc", "nondeterminism"))
    parser.add_argument("--out", default=str(ROOT / "chiprun_out"
                                             / "fidelity"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("fidelity_probe: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    result = (probe_dispnetc if args.probe == "dispnetc"
              else probe_nondeterminism)(device)
    result["seconds"] = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    result.update(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                  torch=torch.__version__)
    line = json.dumps({args.probe: result})
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{args.probe}.json").write_text(line + "\n")
    print(line)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
