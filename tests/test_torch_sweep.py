"""Port parity: hyperparameter sweeps of ``torchbooster_tpu_torch/config.py``
(``parse_sweep``, ``HyperParameterConfig``, ``BaseConfig.load(...,
hyperparams=True)``) against the JAX package's, on the CPU:

- ``parse_sweep`` equals JAX's on every form of
  ``tests/test_config.py::test_parse_sweep_grammar``, on the other calls
  and lists of the grammar, and on leaves that are not sweeps (nothing is
  evaluated);
- ``examples/img_cls/lenet/lenet-sweep.yml`` loaded with
  ``hyperparams=True`` by the JAX recipe's ``Config`` and by a port twin
  of it yields the same configs in the same order, field by field; so do
  a two-axis YAML with a nested axis, a file that ``#include``s it, and a
  YAML without a sweep (one config).
"""
import dataclasses
import importlib.util
import sys
from dataclasses import dataclass
from pathlib import Path

import pytest

from torchbooster_tpu import config as jconfig
from torchbooster_tpu_torch import config as tconfig
from torchbooster_tpu_torch.config import BaseConfig, parse_sweep

ROOT = Path(__file__).resolve().parents[1]
LENET_SWEEP = ROOT / "examples" / "img_cls" / "lenet" / "lenet-sweep.yml"

SWEEPS = [
    # tests/test_config.py::test_parse_sweep_grammar
    "linspace(0.0, 1.0, 3)", "range(1, 4)", "[1, 2, 3]",
    "arange(1e-4, 2.5e-4, 1e-4)", "not a sweep", "__import__('os')",
    "arange(__import__,)",
    # the rest of the grammar
    "logspace(-4, -2, 3)", "geomspace(1e-4, 1e-2, 3)", "range(0, 10, 3)",
    "arange(5)", " linspace( 1 , 2 , 5 ) ", "[2e-3, 1e-3]", "['a', 'b']",
    "(1, 2)", "[1, 2", "linspace(a, b, 3)", "range(1.5, 4)",
    "linspace(0, 1, 'x')", "[[1, 2], [3]]", "[]", "arange(1, 2, 0)",
    "open('/etc/passwd')", "", "range()",
]
NOT_STRINGS = [3, 1.5, None, True, [1, 2], {"a": 1}]


@pytest.mark.parametrize("text", SWEEPS + NOT_STRINGS,
                         ids=[repr(t) for t in SWEEPS + NOT_STRINGS])
def test_parse_sweep_matches_jax(text):
    """Values and their Python types equal exactly (both sides call the
    same numpy); a non-sweep is None on both; what raises in JAX's (a
    zero ``arange`` step) raises the same error in the port's."""

    def outcome(fn):
        try:
            values = fn(text)
        except Exception as err:    # noqa: BLE001 - compared, not hidden
            return type(err)
        return values, [type(v) for v in values or []]

    assert outcome(parse_sweep) == outcome(jconfig.parse_sweep)


def test_parse_sweep_grammar_spec():
    """The JAX grammar test's assertions, against the port."""
    assert parse_sweep("linspace(0.0, 1.0, 3)") == [0.0, 0.5, 1.0]
    assert parse_sweep("range(1, 4)") == [1, 2, 3]
    assert parse_sweep("[1, 2, 3]") == [1, 2, 3]
    assert parse_sweep("arange(1e-4, 2.5e-4, 1e-4)") == pytest.approx(
        [1e-4, 2e-4])
    assert parse_sweep("not a sweep") is None
    assert parse_sweep("__import__('os')") is None
    assert parse_sweep("arange(__import__,)") is None


def _jax_lenet(monkeypatch):
    directory = LENET_SWEEP.parent
    monkeypatch.chdir(directory)
    spec = importlib.util.spec_from_file_location("jax_example_lenet",
                                                  directory / "lenet.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


@dataclass
class LenetConfig(BaseConfig):
    """The port twin of the JAX lenet recipe's ``Config``."""

    epochs: int
    seed: int

    env: tconfig.EnvConfig
    loader: tconfig.LoaderConfig
    optim: tconfig.OptimizerConfig
    scheduler: tconfig.SchedulerConfig
    dataset: tconfig.DatasetConfig


def _assert_same_config(got, want):
    """Every field of the port's config equals the JAX config's field of
    the same name, nested configs (the port's and the JAX package's
    classes of one name) field by field. Config classes are resolved by
    name, so this module binds none of the port's to a bare name."""
    assert type(got).__module__.startswith("torchbooster_tpu_torch") or \
        type(got) in (LenetConfig, SweepConfig)
    assert not type(want).__module__.startswith("torchbooster_tpu_torch")
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(g):
            assert type(g).__name__ == type(w).__name__
            _assert_same_config(g, w)
        else:
            assert g == w and type(g) is type(w), (f.name, g, w)


def test_lenet_sweep_yaml_matches_jax(monkeypatch):
    jlenet = _jax_lenet(monkeypatch)
    want = list(jlenet.Config.load(LENET_SWEEP, hyperparams=True))
    got = list(LenetConfig.load(LENET_SWEEP, hyperparams=True))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_same_config(g, w)
    assert [c.optim.lr for c in got] == [2e-3, 1e-3]
    assert all(c.scheduler.decay == ("cos", "cos") for c in got)


@dataclass
class SweepConfig(BaseConfig):
    lr: float = 0.0
    batch_size: int = 0
    name: str = ""
    optim: tconfig.OptimizerConfig = None


@dataclass
class JSweepConfig(jconfig.BaseConfig):
    lr: float = 0.0
    batch_size: int = 0
    name: str = ""
    optim: jconfig.OptimizerConfig = None


TWO_AXES = """\
lr: linspace(1e-4, 3e-4, 3)
batch_size: "[32, 64]"
name: fixed
optim:
  name: adamw
  betas: 0.9, 0.95
  weight_decay: logspace(-3, -1, 2)
"""


def test_two_axis_sweep_matches_jax(tmp_path):
    """Three axes (one nested) in document order, the last turning
    fastest: 3 x 2 x 2 configs in JAX's order; a file that ``#include``s
    the YAML sweeps the same; a YAML without a sweep gives one config."""
    path = tmp_path / "sweep.yml"
    path.write_text(TWO_AXES)
    want = list(JSweepConfig.load(path, hyperparams=True))
    got = list(SweepConfig.load(path, hyperparams=True))
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        _assert_same_config(g, w)
    assert [(c.lr, c.batch_size, c.optim.weight_decay) for c in got[:3]] == [
        pytest.approx((1e-4, 32, 1e-3)), pytest.approx((1e-4, 32, 1e-1)),
        pytest.approx((1e-4, 64, 1e-3))]
    included = tmp_path / "more.yml"
    included.write_text(f"#include {path.name}\n")
    assert [dataclasses.asdict(c) for c in SweepConfig.load(
        included, hyperparams=True)] == [dataclasses.asdict(c) for c in got]
    plain = tmp_path / "plain.yml"
    plain.write_text("lr: 0.5\nname: one\n")
    (one,) = list(SweepConfig.load(plain, hyperparams=True))
    (jone,) = list(JSweepConfig.load(plain, hyperparams=True))
    _assert_same_config(one, jone)
    assert SweepConfig.load(plain) == one
