"""Port parity: ``torchbooster_tpu_torch.callbacks`` against the spec of
``torchbooster_tpu/callbacks.py`` and ``tests/test_metrics_callbacks.py``,
on the CPU:

- ``BaseCallback`` counts; ``SaveCallback`` gating, the save/restore
  round trip with live objects (a ``TrainState`` and a scheduler loaded
  in place), the scheduler round trip, a missing checkpoint giving None,
  and ``state_dict``;
- ``path()`` equals JAX ``SaveCallback.path()`` over ``n_iter`` and step;
- the asynchronous write: a failed background write raises at
  ``wait()`` (and at the next ``save``), and an uncommitted write is
  invisible to ``latest_step``;
- ``sharded=True`` raises, naming the roadmap item it waits for;
- ``LogCallback`` drains the registry and returns ``steps_per_s``.
"""
import numpy as np
import pytest
import torch

from torchbooster_tpu.callbacks import SaveCallback as JSaveCallback
from torchbooster_tpu_torch import callbacks
from torchbooster_tpu_torch.callbacks import (
    BaseCallback,
    LogCallback,
    SaveCallback,
    state_dict,
)
from torchbooster_tpu_torch.config import OptimizerConfig
from torchbooster_tpu_torch.observability.registry import Registry
from torchbooster_tpu_torch.scheduler import BaseScheduler, CycleScheduler
from torchbooster_tpu_torch.utils import TrainState, instrument_step


def _state(seed=3, steps=0):
    """A two-leaf AdamW state after ``steps`` updates on a fixed loss."""
    params = {"w": torch.arange(4.0), "b": torch.zeros(2)}
    tx = OptimizerConfig(name="adamw", lr=1e-2, weight_decay=0.1).make()
    state = TrainState.create(params, tx, generator=seed)
    for _ in range(steps):
        (state.params["w"].square().sum() + state.params["b"].sum()
         ).backward()
        state.optimizer.step()
        state.optimizer.zero_grad()
        state.step += 1
    return state


def test_base_callback_counts():
    calls = []

    class Probe(BaseCallback):
        def update(self, **kw):
            if self.current % self.every == 0:
                calls.append(self.current)

    probe = Probe(every=3)
    for _ in range(10):
        probe()
    assert calls == [3, 6, 9]


def test_save_restore_roundtrip(tmp_path):
    """Params, AdamW moments, step and generator come back bit for bit,
    loaded IN PLACE into the template's live state; the scheduler comes
    back live with its progress; a raw value as saved."""
    state = _state(steps=2)
    torch.rand(3, generator=state.generator)
    sched = BaseScheduler(CycleScheduler(lr=1.0, n_iter=10))
    sched.step()

    cb = SaveCallback(every=2, n_iter=100, root=tmp_path, prefix="ckpt")
    assert cb.path(7).name == "ckpt_007"
    cb.save(4, state=state, scheduler=sched, epoch=2)
    assert cb.latest_step() == 4

    fresh = _state(seed=0)
    template = {"state": fresh,
                "scheduler": BaseScheduler(CycleScheduler(lr=1.0,
                                                          n_iter=10)),
                "epoch": 0}
    w_before = fresh.params["w"]
    restored = cb.restore(like=template)
    assert restored["state"] is fresh and fresh.params["w"] is w_before
    np.testing.assert_array_equal(fresh.params["w"].detach().numpy(),
                                  state.params["w"].detach().numpy())
    assert fresh.step == 2
    got, want = fresh.optimizer.state_dict(), state.optimizer.state_dict()
    for i in want["state"]:
        for key in want["state"][i]:
            assert torch.equal(got["state"][i][key], want["state"][i][key])
    assert torch.equal(fresh.generator.get_state(),
                       state.generator.get_state())
    assert restored["scheduler"] is template["scheduler"]
    assert restored["scheduler"].step_count == 1
    assert int(restored["epoch"]) == 2
    # without a template the checkpoint comes back as saved, on the host
    raw = cb.restore(4)
    assert raw["state"]["step"] == 2 and raw["epoch"] == 2
    assert raw["state"]["params"]["w"].device.type == "cpu"


def test_scheduler_checkpoint_roundtrip(tmp_path):
    """Scheduler progress survives save → restore: the restored object IS
    a live scheduler at the saved step, its lr re-derived."""
    schedule = CycleScheduler(lr=1.0, n_iter=20, warmup=5)
    sched = BaseScheduler(schedule)
    for _ in range(7):
        sched.step()
    lr_at_7 = sched.lr

    cb = SaveCallback(every=1, n_iter=20, root=tmp_path)
    cb.save(7, scheduler=sched)

    fresh = BaseScheduler(CycleScheduler(lr=1.0, n_iter=20, warmup=5))
    assert fresh.step_count == 0 and fresh.lr != lr_at_7
    restored = cb.restore(like={"scheduler": fresh})
    assert restored["scheduler"] is fresh
    assert fresh.step_count == 7
    assert fresh.lr == pytest.approx(lr_at_7)
    sched.step()
    fresh.step()
    assert fresh.lr == pytest.approx(sched.lr)


def test_restore_missing_returns_none(tmp_path):
    cb = SaveCallback(every=1, n_iter=10, root=tmp_path / "nope")
    assert cb.restore() is None and cb.latest_step() is None


def test_callback_every_gating(tmp_path):
    cb = SaveCallback(every=2, n_iter=10, root=tmp_path)
    params = {"w": torch.zeros(2)}
    assert cb(state=params) is None          # call 1: skip
    path = cb(state=params)                  # call 2: save (async)
    assert path is not None and path.name == "ckpt_02"
    cb.wait()
    assert path.exists()
    # a tensor tree restores onto its template's dtype
    got = cb.restore(like={"state": {"w": torch.ones(2, dtype=torch.float64)}})
    assert got["state"]["w"].dtype == torch.float64
    assert torch.equal(got["state"]["w"], torch.zeros(2, dtype=torch.float64))


def test_state_dict_extraction():
    sched = BaseScheduler(CycleScheduler(lr=1.0, n_iter=10))
    assert state_dict(sched) == {"step_count": 0}
    assert state_dict(5) == 5
    sd = state_dict(_state())
    assert sorted(sd) == ["comms", "ema", "generator", "optimizer", "params",
                          "step"]


@pytest.mark.parametrize("n_iter", [1, 9, 10, 12, 100, 10_000])
@pytest.mark.parametrize("step", [0, 4, 12, 1000])
def test_path_matches_jax(tmp_path, n_iter, step):
    """The zero-padded path scheme of the JAX callback."""
    got = SaveCallback(1, n_iter, root=tmp_path, prefix="ckpt").path(step)
    want = JSaveCallback(1, n_iter, root=tmp_path, prefix="ckpt").path(step)
    assert got == want


def test_failed_background_write_raises_at_wait(tmp_path, monkeypatch):
    """A write that fails in the background raises at the next ``wait``
    (and the next ``save`` routes through it), and commits nothing."""
    def broken(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(callbacks.torch, "save", broken)
    cb = SaveCallback(every=1, n_iter=10, root=tmp_path)
    cb.save(1, state={"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="did NOT commit") as err:
        cb.wait()
    assert isinstance(err.value.__cause__, OSError)
    cb.wait()                                 # raised once
    assert cb.latest_step() is None
    cb.save(2, state={"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="did NOT commit"):
        cb.save(3, state={"w": torch.zeros(2)})


def test_uncommitted_write_is_invisible_to_latest_step(tmp_path,
                                                      monkeypatch):
    """While the background write is in flight, only its hidden
    temporary directory exists: ``latest_step`` (which waits) then sees
    the committed step, never a half-written one."""
    import threading

    writing, release = threading.Event(), threading.Event()
    real_save = torch.save

    def slow(obj, path):
        real_save(obj, path)
        writing.set()
        release.wait(10)

    cb = SaveCallback(every=1, n_iter=10, root=tmp_path)
    cb.save(1, state={"w": torch.zeros(2)})
    assert cb.latest_step() == 1
    monkeypatch.setattr(callbacks.torch, "save", slow)
    cb.save(2, state={"w": torch.ones(2)})
    assert writing.wait(10)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names[0].startswith(".tmp-ckpt_02") and names[1:] == ["ckpt_01"]
    # a reader that does not wait, as another process would, sees step 1
    visible = [p.name for p in tmp_path.iterdir()
               if p.name.startswith("ckpt_")]
    assert visible == ["ckpt_01"]
    release.set()
    assert cb.latest_step() == 2
    assert not any(p.name.startswith(".tmp") for p in tmp_path.iterdir())


def test_sharded_checkpoints_raise(tmp_path):
    """``sharded=True`` is ported (tests/test_torch_zero.py holds it to
    the JAX package): a one-process ZeRO state round-trips, and restoring
    it onto another data-parallel world without the schedule raises."""
    from torchbooster_tpu_torch.comms import make_schedule
    from torchbooster_tpu_torch.config import OptimizerConfig
    from torchbooster_tpu_torch.distributed import Mesh, make_mesh

    tx = OptimizerConfig(name="adamw", lr=1e-2).make()
    params = {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4)}
    sched = make_schedule(make_mesh("dp", device="cpu"), stage=3,
                          wire="fp32", bucket_size=4)
    state = sched.create_state({k: v.clone() for k, v in params.items()}, tx)
    state.optimizer.state[state.params]["exp_avg"] = torch.ones(16)
    state.optimizer.state[state.params]["exp_avg_sq"] = torch.ones(16)
    state.optimizer.state[state.params]["step"] = torch.tensor(1.0)
    cb = SaveCallback(every=1, n_iter=10, root=tmp_path, sharded=True,
                      comms=sched)
    cb.save(1, state=state)
    template = sched.create_state({k: v.clone() for k, v in params.items()},
                                  tx)
    restored = cb.restore(like={"state": template})["state"]
    assert torch.equal(restored.params, state.params)
    assert torch.equal(sched.gather_params(restored)["w"], params["w"])
    two = Mesh(axis_names=("dp",), sizes=(2,), device=torch.device("cpu"))
    other = make_schedule(two, stage=3, wire="fp32", bucket_size=4)
    other.plan(params)
    template.params = torch.zeros(other.plan().shard_size,
                                  requires_grad=True)
    with pytest.raises(ValueError, match="data-parallel world"):
        SaveCallback(every=1, n_iter=10, root=tmp_path,
                     sharded=True).restore(like={"state": template})


def test_log_callback_returns_steps_per_s():
    reg = Registry(enabled=True)
    step = instrument_step(lambda state, batch: (state, {}), registry=reg)
    log_cb = LogCallback(every=2, registry=reg)
    assert log_cb(loss=1.0) is None
    for _ in range(3):
        step(None, None)
    out = log_cb(loss=np.float32(0.5))
    assert out["step"] == 2 and out["loss"] == 0.5
    assert out["steps_per_s"] > 0
    assert out["steps_total{step=train_step}"] == 3.0
    log_cb()
    assert log_cb()["steps_per_s"] == 0.0     # no step since the drain
