"""The frozen reference against the port's plain v2 / v3 models, and its
control's rounding."""

import json

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from stereobench import run, weights
from stereobench.reference import mobilestereonet as reference
from stereobench.reference import rounding
from stereobench.reference.rounding import round_fp8
from stereobench.run import ROOT

CONFIGS = json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]


def _model_config(name):
    return json.loads((ROOT / "stereobench" / "configs" / f"{name}.json")
                      .read_text())["model"]


@pytest.mark.parametrize("config", ["mobilestereonet-v2", "mobilestereonet-v3"])
def test_reference_equals_the_ports_plain_model(config):
    from realtime_stereo_matcher_tpu_torch.models import build_model
    torch.set_num_threads(2)
    cfg = _model_config(config)
    ref = reference.build(cfg)
    sd = weights.seeded_state_dict(ref, 5, "cpu")
    ref.load_state_dict(sd)
    net = build_model(cfg, device="cpu")
    net.load_state_dict(sd)
    gen = torch.Generator().manual_seed(0)
    left, right = (torch.randint(0, 256, (2, 40, 72, 3), generator=gen,
                                 dtype=torch.uint8) for _ in range(2))
    with torch.no_grad():
        want = net(left, right, banded_warp=True)
        got = ref(left, right)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 40, 72, 1)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("config, params", [("mobilestereonet-v2", 537_316),
                                            ("mobilestereonet-v3", 673_508)])
def test_seeded_weights_cover_every_tensor(config, params):
    ref = reference.build(_model_config(config), "meta")
    assert sum(p.numel() for p in ref.parameters()) == params
    a = weights.seeded_state_dict(ref, 2**31 + 11, "cpu")
    b = weights.seeded_state_dict(ref, 2**31 + 11, "cpu")
    c = weights.seeded_state_dict(ref, 2**31 + 12, "cpu")
    assert a.keys() == ref.state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    assert all(float(v.min()) > 0 for k, v in a.items() if k.endswith("running_var"))


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    fp8 = (round_fp8(x) - x).abs().max() / x.abs().max()
    bf16 = (x.to(torch.bfloat16).float() - x).abs().max() / x.abs().max()
    assert 4 * bf16 < fp8 < 0.1


def test_batchnorm_statistics_are_the_inputs():
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, padding=1),
                              torch.nn.BatchNorm2d(4), torch.nn.ReLU(),
                              torch.nn.Conv2d(4, 4, 1), torch.nn.BatchNorm2d(4)).eval()
    sd = weights.seeded_state_dict(net, 3, "cpu")
    x = torch.randn(2, 3, 8, 8, generator=torch.Generator().manual_seed(1)) * 5 + 2
    out = weights.calibrate_batchnorm(net, sd, (x,))
    with torch.no_grad():
        h = net[0](x)
        torch.testing.assert_close(out["1.running_mean"], h.mean((0, 2, 3)))
        torch.testing.assert_close(out["1.running_var"], h.var((0, 2, 3), unbiased=False))
        g = net[3](net[2](net[1](h)))  # the second BatchNorm sees the first's output
        torch.testing.assert_close(out["4.running_mean"], g.mean((0, 2, 3)))
    assert torch.equal(out["0.weight"], sd["0.weight"])


class _Convolutions(TorchDispatchMode):
    """Counts the convolutions that reach the dispatcher."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.count += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("config", [c["name"] for c in CONFIGS])
def test_the_control_rounds_every_convolution_of_each_reference(config):
    """Every convolution of the reference that the configuration names is a
    shared rounding class, and no other convolution runs in its forward: the
    float8 control rounds both operands of each one."""
    entry = next(c for c in CONFIGS if c["name"] == config)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    ref = run.load_reference(cfg, entry["file"]).build(cfg["model"], "meta")
    convs = [m for m in ref.modules()
             if isinstance(m, torch.nn.modules.conv._ConvNd)]
    assert convs and all(isinstance(m, rounding._Rounded) for m in convs)
    rounded = []
    rounding.set_operand_rounding(ref, lambda x: rounded.append(x.shape) or x)
    x = torch.empty((1, 64, 128, 3), device="meta")
    with torch.no_grad(), _Convolutions() as seen:
        ref(x, x)
    assert seen.count > 0 and len(rounded) == 2 * seen.count
