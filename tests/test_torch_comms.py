"""The port's explicit gradient communication (``comms/quantized.py``,
``GradComms``, ``CommsConfig``, ``make_step(comms=...)``) against the JAX
package: the port at world 2 on gloo process groups (the rank pool of
``tests/test_torch_distributed.py``), the JAX package on
``make_mesh("dp", 2)`` over the virtual CPU devices, both from one numpy
seed at fp32. The ranks import this file to find their cases, so the JAX
package is imported inside the functions that run it."""
from __future__ import annotations

import logging

import numpy as np
import pytest
import torch

from tests.test_torch_distributed import RankPool
from torchbooster_tpu_torch import distributed as dist
from torchbooster_tpu_torch import utils
from torchbooster_tpu_torch.comms import (
    CommsSchedule,
    GradComms,
    as_schedule,
    dequantize,
    make_grad_comms,
    make_schedule,
    quantize,
    quantize_with_noise,
    reduce_flat,
)
from torchbooster_tpu_torch.config import CommsConfig, OptimizerConfig

BUCKET = 16
BUCKET_MB = 0.0004       # splits the three-leaf problem into 2 buckets
LR = 1e-2


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


# =========================================================================
# the problem, on both sides
# =========================================================================

def host_problem(seed: int = 0) -> tuple[dict, dict]:
    """Parameters and a global batch of 32 rows, from one numpy seed."""
    rs = np.random.RandomState(seed)
    params = {"w": rs.randn(16, 8).astype(np.float32),
              "b": np.zeros(8, np.float32),
              "w2": rs.randn(8, 8).astype(np.float32)}
    batch = {"x": rs.randn(32, 16).astype(np.float32),
             "y": rs.randn(32, 8).astype(np.float32)}
    return params, batch


def port_loss(p, b, generator):
    pred = (b["x"] @ p["w"] + p["b"]) @ p["w2"]
    return ((pred - b["y"]) ** 2).mean(), {}


def jax_loss(p, b, rng):
    import jax.numpy as jnp

    pred = (b["x"] @ p["w"] + p["b"]) @ p["w2"]
    return jnp.mean((pred - b["y"]) ** 2), {}


def port_schedule(mesh, kind: dict):
    """A schedule from a case's description: ``None`` (no comms),
    ``{"legacy": (mode, zero1)}`` or ``{"stage", "wire", "overlap"}``."""
    if kind is None:
        return None
    if "legacy" in kind:
        mode, zero1 = kind["legacy"]
        return make_grad_comms(mesh, mode=mode, zero1=zero1,
                               bucket_size=BUCKET)
    return make_schedule(mesh, stage=kind["stage"], wire=kind["wire"],
                         overlap=kind.get("overlap", False),
                         bucket_mb=BUCKET_MB, bucket_size=BUCKET)


def jax_schedule(mesh, kind: dict):
    from torchbooster_tpu.comms import make_grad_comms as jmake_grad_comms
    from torchbooster_tpu.comms import make_schedule as jmake_schedule

    if kind is None:
        return None
    if "legacy" in kind:
        mode, zero1 = kind["legacy"]
        return jmake_grad_comms(mesh, mode=mode, zero1=zero1,
                                bucket_size=BUCKET)
    return jmake_schedule(mesh, stage=kind["stage"], wire=kind["wire"],
                          overlap=kind.get("overlap", False),
                          bucket_mb=BUCKET_MB, bucket_size=BUCKET)


ADAMW = dict(name="adamw", lr=LR, weight_decay=1e-4)   # optax.adamw(LR)


def case_train(kind: dict | None, steps: int = 3, clip: float | None = None,
               spec: str = "dp", seed: int = 0, opt: dict = ADAMW,
               accumulate: int = 1) -> dict:
    """A rank's run of ``steps`` steps under ``kind`` with the optimizer
    ``opt`` (``OptimizerConfig`` fields): its losses, the full parameters
    and its comms state."""
    mesh = dist.make_mesh(spec, device="cpu")
    params, host = host_problem(seed)
    params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tx = OptimizerConfig(**opt).make()
    comms = port_schedule(mesh, kind)
    if comms is None:
        state = utils.TrainState.create(dist.to_env(params, mesh), tx,
                                        accumulate=accumulate > 1)
        step = utils.make_step(port_loss, tx, clip=clip, mesh=mesh,
                               accumulate_every=accumulate)
    else:
        state = comms.create_state(params, tx, accumulate=accumulate > 1)
        step = utils.make_step(port_loss, tx, clip=clip, comms=comms,
                               accumulate_every=accumulate)
    batch = dist.shard_batch(host, mesh)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    full = comms.gather_params(state) if kind and kind.get("stage", 0) >= 3 \
        else state.params
    return {"losses": losses,
            "params": {k: v.detach().numpy().copy() for k, v in full.items()},
            "comms": {k: v.numpy().copy()
                      for k, v in (state.comms or {}).items()},
            "opt_numel": sorted(v.numel() for entry in
                                state.optimizer.state.values()
                                for v in entry.values()
                                if isinstance(v, torch.Tensor)
                                and v.ndim >= 1)}


def jax_train(kind: dict | None, steps: int = 3, clip: float | None = None,
              n: int = 2, spec: str = "dp", seed: int = 0,
              opt: dict | None = None, accumulate: int = 1) -> tuple:
    """The JAX package's run: ``optax.adamw(LR)``, or the transformation
    its ``OptimizerConfig(**opt)`` builds."""
    import jax
    import jax.numpy as jnp
    import optax

    from torchbooster_tpu import distributed as jdist
    from torchbooster_tpu.config import OptimizerConfig as JOptimizerConfig
    from torchbooster_tpu.utils import TrainState as JState
    from torchbooster_tpu.utils import make_step as jmake_step

    mesh = jdist.make_mesh(spec, n)
    params, host = host_problem(seed)
    params = jax.tree.map(jnp.asarray, params)
    batch = jdist.shard_batch(host, mesh)
    tx = optax.adamw(LR) if opt is None else JOptimizerConfig(**opt).make()
    comms = jax_schedule(mesh, kind)
    if comms is None:
        state = JState.create(params, tx, accumulate=accumulate > 1)
        step = jmake_step(jax_loss, tx, clip=clip,
                          accumulate_every=accumulate)
    else:
        state = comms.create_state(params, tx, accumulate=accumulate > 1)
        step = jmake_step(jax_loss, tx, clip=clip, comms=comms,
                          accumulate_every=accumulate)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    full = comms.gather_params(state) if kind and kind.get("stage", 0) >= 3 \
        else state.params
    return losses, {k: np.asarray(v) for k, v in full.items()}, state


# =========================================================================
# quantization: JAX's codes and scales given JAX's noise
# =========================================================================

@pytest.mark.parametrize("seed,scale,n_buckets", [(0, 3.0, 8), (1, 1e-3, 4),
                                                  (2, 50.0, 16)])
def test_int8_codes_and_scales_bit_equal_jax(seed, scale, n_buckets):
    import jax

    from torchbooster_tpu.comms.quantized import quantize as jquantize

    rng = jax.random.PRNGKey(seed)
    x = jax.random.normal(jax.random.PRNGKey(100 + seed),
                          (n_buckets * BUCKET,)) * scale
    x = x.at[:BUCKET].set(0.0)               # one all-zero bucket
    q, s = jquantize(x, BUCKET, rng)
    # the draw jquantize made, handed to the port's deterministic body
    noise = np.asarray(jax.random.uniform(rng, (n_buckets, BUCKET)))
    got_q, got_s = quantize_with_noise(torch.tensor(np.asarray(x)),
                                       BUCKET, torch.tensor(noise))
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(s))


def test_quantize_error_bound_and_zero_bucket():
    x = torch.randn(8 * BUCKET, generator=torch.Generator().manual_seed(0))
    q, scales = quantize(x * 3.0, BUCKET, torch.Generator().manual_seed(1))
    err = (dequantize(q, scales, BUCKET) - x * 3.0).abs()
    assert (err <= scales.repeat_interleave(BUCKET) + 1e-7).all()
    q, s = quantize(torch.zeros(2 * BUCKET), BUCKET,
                    torch.Generator().manual_seed(0))
    assert not q.any() and not s.any()


def test_quantize_stochastic_rounding_unbiased():
    x = torch.full((BUCKET,), 0.3217)
    x[0] = 1.0                               # pins the scale
    gen = torch.Generator().manual_seed(0)
    deqs = torch.stack([dequantize(*quantize(x, BUCKET, gen), BUCKET)
                        for _ in range(200)])
    assert abs(float(deqs.mean(0)[5]) - 0.3217) < 1e-3


# =========================================================================
# the int8 all-reduce: error bound vs fp32, error feedback drains
# =========================================================================

def case_reduce(g: np.ndarray, mode: str, steps: int) -> dict:
    """``steps`` int8/fp32 mean-reduces of this rank's row of ``g`` with
    error feedback carried, fresh noise each time."""
    mesh = dist.make_mesh("dp", device="cpu")
    group = mesh.group(("dp",))
    n, rank = mesh.size, mesh.rank
    local = torch.from_numpy(g[rank].copy())
    ef1 = torch.zeros_like(local)
    ef2 = torch.zeros(local.numel() // n)
    outs = []
    for k in range(steps):
        gens = (torch.Generator().manual_seed(1000 * k + rank),
                torch.Generator().manual_seed(1000 * k + n + rank))
        out, ef1, ef2 = reduce_flat(local, group, n, mode, BUCKET, gens,
                                    ef1, ef2)
        outs.append(out.numpy().copy())
    return {"outs": outs, "ef1": ef1.numpy()}


def test_int8_allreduce_error_bound_vs_fp32(pool):
    g = np.random.RandomState(0).randn(2, 8 * BUCKET).astype(np.float32) * 2
    true_mean = g.mean(0)
    got = pool.run(case_reduce, g, "int8", 1)
    err = np.abs(got[0]["outs"][0] - true_mean).max()
    assert err <= 2.5 * np.abs(g).max() / 127.0, err
    np.testing.assert_array_equal(got[0]["outs"][0], got[1]["outs"][0])
    exact = pool.run(case_reduce, g, "fp32", 1)
    np.testing.assert_allclose(exact[0]["outs"][0], true_mean, rtol=2e-6,
                               atol=2e-7)


def test_error_feedback_residual_drains(pool):
    g = np.random.RandomState(3).randn(2, 4 * BUCKET).astype(np.float32)
    true_mean = g.mean(0)
    K = 24
    got = pool.run(case_reduce, g, "int8", K)[0]
    single = np.abs(got["outs"][0] - true_mean).max()
    avg = np.abs(np.mean(got["outs"], 0) - true_mean).max()
    assert avg < single / 4, (avg, single)
    assert np.abs(got["ef1"]).max() <= np.abs(g).max() / 64


# =========================================================================
# make_step: implicit and stage 0 against JAX, compressed wires track fp32
# =========================================================================

@pytest.mark.parametrize("kind,accumulate", [
    (None, 1), ({"legacy": ("fp32", False)}, 1),
    ({"stage": 0, "wire": "fp32"}, 1), (None, 2),
    ({"stage": 0, "wire": "fp32"}, 2)])
def test_implicit_and_stage0_match_jax(pool, kind, accumulate):
    """Adamw steps at world 2 against the JAX package on two devices
    (four micro-steps over two updates with accumulation). Losses 1e-6
    relative; parameters 1e-6 absolute — the bar JAX sets its own
    explicit fp32 arm against the implicit one."""
    steps = 3 if accumulate == 1 else 4
    want_l, want_p, _ = jax_train(kind, steps, accumulate=accumulate)
    for res in pool.run(case_train, kind, steps, None, "dp", 0, ADAMW,
                        accumulate):
        np.testing.assert_allclose(res["losses"], want_l, rtol=1e-6)
        for key in want_p:
            np.testing.assert_allclose(res["params"][key], want_p[key],
                                       atol=1e-6, rtol=0)


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_compressed_wires_track_fp32(pool, wire):
    ref = pool.run(case_train, None, 5)[0]["losses"]
    got = pool.run(case_train, {"stage": 0, "wire": wire}, 5)
    np.testing.assert_allclose(got[0]["losses"], ref, rtol=5e-3)
    assert got[0]["losses"] == got[1]["losses"]
    if wire == "int8":
        ef = got[0]["comms"]
        assert ef["ef1"].shape == (1, 224) and ef["ef2"].shape == (112,)
        assert ef["ef1"].any() and np.abs(ef["ef1"]).max() < 1.0


@pytest.mark.parametrize("kind", [{"legacy": ("fp32", True)},
                                  {"stage": 2, "wire": "fp32",
                                   "overlap": True}])
def test_global_norm_clip_matches_jax(pool, kind):
    """clip 0.01 is active from the first step: the sharded paths clip by
    the norm summed over the shards, the implicit JAX path by the full
    gradient's."""
    want_l, want_p, _ = jax_train(None, clip=0.01)
    for res in pool.run(case_train, kind, 3, 0.01):
        np.testing.assert_allclose(res["losses"], want_l, rtol=1e-5)
        for key in want_p:
            np.testing.assert_allclose(res["params"][key], want_p[key],
                                       atol=1e-6, rtol=0)


# =========================================================================
# CommsConfig and construction: JAX's surface and JAX's errors
# =========================================================================

def _mesh():
    return dist.make_mesh("dp", device="cpu")


def _jmesh():
    from torchbooster_tpu import distributed as jdist

    return jdist.make_mesh("dp", 4)


def test_comms_config_yaml_roundtrip(tmp_path):
    path = tmp_path / "comms.yml"
    path.write_text("stage: 2\nwire: int8\noverlap: yes\n"
                    "bucket_mb: 2.5\nbucket_size: 128\n")
    conf = CommsConfig.load(path)
    sched = conf.make(mesh=_mesh())
    assert isinstance(sched, CommsSchedule) and isinstance(sched, GradComms)
    assert (sched.stage, sched.wire, sched.overlap, sched.bucket_mb,
            sched.bucket_size) == (2, "int8", True, 2.5, 128)
    assert sched.zero1 and sched.mode == "int8"
    assert sched.axes == ("dp",) and sched.n_shards == 1
    path.write_text("mode: int8\nzero1: yes\nbucket_size: 256\n")
    legacy = CommsConfig.load(path).make(mesh=_mesh())
    assert (legacy.mode, legacy.zero1, legacy.bucket_size, legacy.stage) \
        == ("int8", True, 256, 1)
    inert = CommsConfig().make(mesh=_mesh())
    assert inert.mode == "implicit" and not inert.active
    # the env's mesh when none is given
    from torchbooster_tpu_torch.config import EnvConfig

    assert CommsConfig(stage=1, wire="fp32").make(
        env=EnvConfig(), device="cpu").mesh.shape == {"dp": 1}


def test_comms_config_legacy_shim_logs_deprecation(caplog):
    with caplog.at_level(logging.WARNING):
        sched = CommsConfig(mode="implicit", zero1=True).make(mesh=_mesh())
    assert (sched.stage, sched.mode, sched.zero1) == (1, "implicit", True)
    assert any("deprecated" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert not CommsConfig().make(mesh=_mesh()).active
    assert not any("deprecated" in r.message for r in caplog.records)
    legacy = make_grad_comms(_mesh(), mode="int8", zero1=True)
    sched = as_schedule(legacy)
    assert (sched.stage, sched.wire, sched.overlap) == (1, "int8", False)
    assert as_schedule(sched) is sched


def _error(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("conf", [
    dict(mode="int8", stage=2), dict(zero1=True, bucket_mb=8.0),
    dict(bucket_mb=8.0), dict(stage=4), dict(stage=2, wire="int4"),
    dict(stage=1, overlap=True), dict(stage=2, wire="implicit"),
    dict(stage=2, bucket_mb=-1.0), dict(mode="int4"),
    dict(mode="int8", bucket_size=0)])
def test_comms_config_errors_match_jax(conf):
    from torchbooster_tpu.config import CommsConfig as JCommsConfig

    want = _error(lambda: JCommsConfig(**conf).make(mesh=_jmesh()))
    assert _error(lambda: CommsConfig(**conf).make(mesh=_mesh())) == want


def test_make_grad_comms_validation():
    mesh = dist.Mesh(axis_names=("dp", "tp"), sizes=(1, 2),
                     device=torch.device("cpu"))
    with pytest.raises(ValueError, match="model-parallel"):
        make_grad_comms(mesh, mode="int8")
    with pytest.raises(ValueError, match="model-parallel"):
        make_schedule(mesh, stage=2)
    assert make_grad_comms(mesh).mode == "implicit"
    with pytest.raises(ValueError, match="no data axis"):
        make_grad_comms(dist.Mesh(axis_names=("x",), sizes=(1,),
                                  device=torch.device("cpu")), mode="fp32")


def test_make_step_rejections():
    mesh = _mesh()
    tx = OptimizerConfig(name="sgd", lr=1e-2).make()
    noop = lambda p, b, g: (torch.zeros(()), {})  # noqa: E731
    with pytest.raises(ValueError, match="needs mesh"):
        utils.make_step(noop, tx, rules=[(r".*", ())])
    with pytest.raises(ValueError, match="replicated"):
        utils.make_step(noop, tx, mesh=mesh, rules=[(r".*", ())],
                        comms=make_grad_comms(mesh, mode="int8"))
    with pytest.raises(ValueError, match="accumulate"):
        utils.make_step(noop, tx, accumulate_every=4,
                        comms=make_grad_comms(mesh, zero1=True))
    params, host = host_problem()
    params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    for kind in ({"legacy": ("fp32", True)},
                 {"stage": 2, "wire": "fp32", "overlap": True},
                 {"stage": 3, "wire": "fp32"}):
        sched = port_schedule(mesh, kind)
        if kind.get("stage", 1) >= 2:
            with pytest.raises(ValueError, match="accumulat"):
                sched.create_state(params, tx, accumulate=True)
            sched.plan(params)
        state = utils.TrainState.create({k: v.clone() for k, v in
                                         params.items()}, tx)
        step = utils.make_step(port_loss, tx, comms=sched)
        with pytest.raises(ValueError, match="create_state"):
            step(state, dist.shard_batch(host, mesh))


# =========================================================================
# the GPT recipe under launch, from a YAML with a comms: block
# =========================================================================

RECIPE_YAML = """\
n_iter: 3
seed: 7
clip: 1.0
accumulate_every: 1
log_every: 1
save_every: 2
checkpoint_root: {root}
sample_tokens: 4
eval_batches: 1
model: {{vocab: 64, n_layers: 2, d_model: 32, n_heads: 2, seq_len: 16,
         remat: true}}
env: {{distributed: true, precision: fp32, mesh: "{mesh}", n_devices: 2}}
loader: {{batch_size: 4, num_workers: 0, drop_last: true}}
optim: {{name: adamw, lr: 1e-3, weight_decay: 0.1, betas: "0.9, 0.95"}}
scheduler: {{name: cycle, n_iter: 3, warmup: 1, decay: "lin, cos"}}
dataset: {{name: synthetic_lm, n_examples: 64}}
{comms}"""


def run_recipe_at_world_2(tmp_path, mesh: str, comms: str) -> None:
    """The GPT recipe's ``launch_main`` at world 2 on gloo from a YAML:
    finite losses, the same logged loss on both ranks (the mean over
    them), a sample on the primary only under ``comms`` (the gathered
    tree) and without it the same sample on both ranks (each samples on
    the rule-sharded state, ``generate(mesh=)``), and a checkpoint."""
    from torchbooster_tpu_torch.recipes import gpt as recipe

    path = tmp_path / "gpt.yml"
    path.write_text(RECIPE_YAML.format(root=tmp_path / "ckpt", mesh=mesh,
                                       comms=comms))
    conf = recipe.Config.load(path)
    assert (conf.comms is not None) == bool(comms)
    ranks = recipe.launch_main(conf, device="cpu")
    assert len(ranks) == 2
    for res in ranks:
        losses = [r["loss"] for r in res["log"]]
        assert len(losses) == 3 and all(np.isfinite(losses))
        assert np.isfinite(res["val_loss"])
    # the loss is the mean over the ranks: every rank logs the same
    assert [r["loss"] for r in ranks[0]["log"]] == \
        [r["loss"] for r in ranks[1]["log"]]
    if comms:
        assert "sample" in ranks[0] and "sample" not in ranks[1]
    else:
        assert ranks[0]["sample"] == ranks[1]["sample"]
    assert (tmp_path / "ckpt" / "ckpt_2" / "manifest.json").exists()


def test_gpt_recipe_with_comms_under_launch(tmp_path):
    run_recipe_at_world_2(
        tmp_path, "dp",
        "comms: {stage: 2, wire: int8, overlap: true, bucket_mb: 0.01}")
