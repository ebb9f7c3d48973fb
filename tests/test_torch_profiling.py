"""cliffordtpu_torch/utils/profiling.py and cliffordtpu_torch/configs
against the JAX package's: nan_guard, the trace file, the anomaly switch,
and the config dataclasses field for field, their defaults the port
runners' argparse defaults."""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from cliffordtpu import configs as jax_configs
from cliffordtpu.utils import profiling as jax_profiling
from cliffordtpu_torch import configs
from cliffordtpu_torch.scripts import fashion_train, mnist_clifpws, mnist_vmf
from cliffordtpu_torch.utils import profiling


@pytest.mark.parametrize("value", [1.5, np.float32(2.0), torch.tensor(3.0),
                                   math.nan, math.inf, -math.inf])
def test_nan_guard_as_jax(value):
    finite = bool(np.isfinite(float(value)))
    for mod in (profiling, jax_profiling):
        if finite:
            assert mod.nan_guard(value) == float(value)
        else:
            with pytest.raises(mod.NaNLossError, match="non-finite loss"):
                mod.nan_guard(value, "epoch 3")
    assert issubclass(profiling.NaNLossError, RuntimeError)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_enable_debug_checks_catches_a_nan_gradient():
    try:
        profiling.enable_debug_checks()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        profiling.enable_debug_checks(nans=False)
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("name,parser", [
    ("MNISTConfig", mnist_clifpws.build_parser),
    ("VMFConfig", mnist_vmf.build_parser),
    ("CNNSweepConfig", fashion_train.build_parser)])
def test_configs_match_jax_and_the_runners(name, parser):
    ours, theirs = getattr(configs, name), getattr(jax_configs, name)

    def defaults(cls):
        return {f.name: (f.default if f.default is not dataclasses.MISSING
                         else f.default_factory())
                for f in dataclasses.fields(cls)}

    assert defaults(ours) == defaults(theirs)
    assert [f.name for f in dataclasses.fields(ours)] == [
        f.name for f in dataclasses.fields(theirs)]
    ns = parser().parse_args([])
    assert {k: v for k, v in vars(ns).items()
            if k in defaults(ours)} == defaults(ours)
    cfg = configs.from_namespace(ours, ns)
    assert cfg == ours()
    assert vars(configs.to_namespace(cfg)) == dataclasses.asdict(cfg)
    assert configs.DIST_LR_OVERRIDES == jax_configs.DIST_LR_OVERRIDES
    assert configs.CLIFFORD_KAPPA_FLOORS == jax_configs.CLIFFORD_KAPPA_FLOORS
