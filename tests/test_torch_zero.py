"""The port's ZeRO ladder (``comms/zero.py``, ``comms/schedule.py``) and
its sharded checkpoint (``SaveCallback(sharded=True)``) against the JAX
package: stages 1-3 at world 2 on gloo process groups against
``make_mesh("dp", 2)``, one case at world 4 on a ``dp:2,fsdp:2`` mesh,
overlap on and off bit-identical, the collectives each schedule plans,
and checkpoints crossing between the JAX package and the port and
between data-parallel world sizes. The ranks import this file to find
their cases, so the JAX package is imported inside the functions that
run it."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from tests.test_torch_comms import (
    BUCKET,
    LR,
    case_train,
    host_problem,
    jax_loss,
    jax_schedule,
    jax_train,
    port_loss,
    port_schedule,
)
from tests.test_torch_distributed import RankPool
from torchbooster_tpu_torch import distributed as dist
from torchbooster_tpu_torch import utils
from torchbooster_tpu_torch.callbacks import SaveCallback
from torchbooster_tpu_torch.comms import make_grad_comms
from torchbooster_tpu_torch.config import OptimizerConfig

STAGE1 = {"stage": 1, "wire": "fp32"}
STAGE2 = {"stage": 2, "wire": "fp32", "overlap": True}
STAGE3 = {"stage": 3, "wire": "fp32"}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


def _close(got: dict, want: dict, atol: float) -> None:
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=atol, rtol=0)


# =========================================================================
# the bucket plan: JAX's buckets and JAX's shard-major layout
# =========================================================================

@pytest.mark.parametrize("n,bucket_mb", [(1, 4.0), (2, 0.01), (4, 0.004)])
def test_bucket_plan_matches_jax(n, bucket_mb):
    import jax
    import jax.numpy as jnp

    from tests.test_torch_distributed import TINY
    from torchbooster_tpu.comms.schedule import BucketPlan as JBucketPlan
    from torchbooster_tpu_torch.comms import BucketPlan
    from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig

    params = GPT.init(0, GPTConfig(**TINY), device="cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    plan = BucketPlan.build(params, n, BUCKET, bucket_mb)
    jplan = JBucketPlan.build(jparams, n, BUCKET, bucket_mb)
    assert (plan.raw, plan.padded, plan.spans) == \
        (jplan.raw, jplan.padded, jplan.spans)
    assert plan.n_buckets > 1 or n == 1
    flat = plan.pack(params).numpy()
    np.testing.assert_array_equal(flat, np.asarray(jplan.pack(jparams)))
    for r in range(n):
        np.testing.assert_array_equal(
            plan.pack_shard(params, r).numpy(),
            flat[r * plan.shard_size:(r + 1) * plan.shard_size])
    raw = plan.strip_pads_host(flat)
    np.testing.assert_array_equal(raw, jplan.strip_pads_host(flat))
    np.testing.assert_array_equal(plan.with_pads_host(raw), flat)
    back = plan.unpack(torch.from_numpy(flat))
    for key in ("wte", "wpe"):
        assert torch.equal(back[key]["table"], params[key]["table"])
    assert torch.equal(back["blocks"]["attn_qkv"]["kernel"],
                       params["blocks"]["attn_qkv"]["kernel"])


# =========================================================================
# stages 1-3 against JAX; zero1 bitwise against the replicated update
# =========================================================================

@pytest.mark.parametrize("kind", [STAGE1, {"legacy": ("implicit", True)},
                                  {"stage": 2, "wire": "fp32"}, STAGE2,
                                  STAGE3])
def test_stages_match_jax(pool, kind):
    """Three adamw steps at world 2 against the same schedule of the JAX
    package on two devices: losses 1e-6 relative, parameters 1e-6
    absolute (JAX's own bar for its explicit arms), and the optimizer
    state built at shard size on each rank."""
    want_l, want_p, _ = jax_train(kind)
    got = pool.run(case_train, kind)
    for res in got:
        np.testing.assert_allclose(res["losses"], want_l, rtol=1e-6)
        _close(res["params"], want_p, 1e-6)
        # adam's two moments over this rank's shard only: 224 / 2
        assert res["opt_numel"] == [112, 112]


@pytest.mark.parametrize("opt", [
    dict(name="adamw", lr=LR, weight_decay=0.1, decay_matrices_only=True),
    dict(name="lamb", lr=LR, weight_decay=0.1),
    dict(name="adafactor", lr=LR)])
def test_zero1_keeps_jax_flat_leaf_semantics(pool, opt):
    """Per-leaf optimizers over the flat shard do what they do in the JAX
    package (``zero.py``'s docstring), and the port pins that, not a
    "fixed" version: the decay mask sees a 1-D vector and decays
    nothing, lamb's trust ratio is the shard's, adafactor does not
    factor. Losses 1e-6 relative, parameters 1e-6 absolute."""
    want_l, want_p, _ = jax_train(STAGE1, opt=opt)
    for res in pool.run(case_train, STAGE1, 3, None, "dp", 0, opt):
        np.testing.assert_allclose(res["losses"], want_l, rtol=1e-6)
        _close(res["params"], want_p, 1e-6)


def test_zero1_bit_parity_with_replicated_update(pool):
    """The implicit gradient with a ZeRO-1 update is the replicated
    update of the same elements, bit for bit (adamw is elementwise)."""
    ref = pool.run(case_train, None)
    got = pool.run(case_train, {"legacy": ("implicit", True)})
    for a, b in zip(ref, got):
        assert a["losses"] == b["losses"]
        for key in a["params"]:
            np.testing.assert_array_equal(b["params"][key], a["params"][key])


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_stage2_overlap_on_off_bit_identical(pool, wire):
    off = pool.run(case_train, {"stage": 2, "wire": wire, "overlap": False},
                   5)
    on = pool.run(case_train, {"stage": 2, "wire": wire, "overlap": True}, 5)
    for a, b in zip(off, on):
        assert a["losses"] == b["losses"]
        for key in a["params"]:
            np.testing.assert_array_equal(b["params"][key], a["params"][key])
        for key in a["comms"]:
            np.testing.assert_array_equal(b["comms"][key], a["comms"][key])


@pytest.mark.parametrize("stage", [2, 3])
def test_int8_tracks_fp32(pool, stage):
    fp32 = pool.run(case_train, {"stage": stage, "wire": "fp32",
                                 "overlap": True}, 5)[0]
    int8 = pool.run(case_train, {"stage": stage, "wire": "int8",
                                 "overlap": True}, 5)
    np.testing.assert_allclose(int8[0]["losses"], fp32["losses"], rtol=5e-3)
    ef = int8[0]["comms"]["ef1"]
    assert ef.shape == (1, 224) and ef.any() and np.abs(ef).max() < 1.0
    assert not np.array_equal(ef, int8[1]["comms"]["ef1"])   # per rank


def test_world4_dp_fsdp_stage2_matches_jax():
    """Four ranks on a dp:2,fsdp:2 mesh: both axes are data axes, so the
    gradient reduce-scatters over all four."""
    kind = STAGE2
    want_l, want_p, _ = jax_train(kind, n=4, spec="dp:2,fsdp:2")
    pool4 = RankPool(4)
    try:
        got = pool4.run(case_train, kind, 3, None, "dp:2,fsdp:2")
    finally:
        pool4.close()
    for res in got:
        np.testing.assert_allclose(res["losses"], want_l, rtol=1e-6)
        _close(res["params"], want_p, 1e-6)
        assert res["opt_numel"] == [256 // 4] * 2


# =========================================================================
# stage 3 holds no gathered bucket from the forward to the backward
# =========================================================================

def case_stage3_held(model: str, regather: bool, steps: int = 2) -> dict:
    """Stage 3 at fp32 for ``steps`` steps on the linear problem or a
    two-layer GPT under remat. Every full bucket the schedule gathers is
    watched (``distributed.all_gather`` wrapped); when backward starts
    (a hook on the loss) the bytes of the watched buckets still alive
    are counted. ``regather=False`` turns the saved-tensor hooks into
    pass-throughs, the schedule before the re-gather: it must give the
    same parameters, bit for bit."""
    import gc

    from torch.multiprocessing.reductions import StorageWeakRef

    from tests.test_torch_distributed import TINY
    from torchbooster_tpu_torch.comms import schedule
    from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig

    mesh = dist.make_mesh("dp", device="cpu")
    tx = OptimizerConfig(name="adamw", lr=LR, weight_decay=1e-4).make()
    comms = port_schedule(mesh, STAGE3)
    if model == "linear":
        params, host = host_problem()
        params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        inner = port_loss
    else:
        cfg = GPTConfig(**TINY)
        params = GPT.init(0, cfg, device="cpu")
        rs = np.random.RandomState(1)
        ids = rs.randint(0, cfg.vocab, (4, cfg.seq_len + 1))
        host = {"ids": ids[:, :-1], "labels": ids[:, 1:]}

        def inner(p, b, generator):
            logits = GPT.apply(p, b["ids"], cfg, compute_dtype=torch.float32,
                               remat=True)
            return torch.nn.functional.cross_entropy(
                logits.reshape(-1, cfg.vocab), b["labels"].reshape(-1)), {}

    state = comms.create_state(params, tx)
    padded = set(comms.plan().padded)
    watched: list = []
    held: list = []
    gather = dist.all_gather

    def watching(out, inp, group, async_op=False):
        if out.numel() in padded:
            watched.append((StorageWeakRef(out.untyped_storage()),
                            out.numel()))
        return gather(out, inp, group, async_op)

    def at_backward(grad):
        gc.collect()
        held.append(sum(4 * n for ref, n in watched
                        if not ref.expired()))
        watched.clear()
        return grad

    def loss_fn(p, b, generator):
        loss, aux = inner(p, b, generator)
        loss.register_hook(at_backward)
        return loss, aux

    step = utils.make_step(loss_fn, tx, comms=comms)
    batch = dist.shard_batch(host, mesh)
    pack = schedule._Regather.pack
    dist.all_gather = watching
    if not regather:
        schedule._Regather.pack = lambda self, t: t
    try:
        losses = []
        for _ in range(steps):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    finally:
        dist.all_gather = gather
        schedule._Regather.pack = pack
    full = comms.gather_params(state)
    flat = {"/".join(path): v.detach().numpy().copy() for path, v in
            __import__("torchbooster_tpu_torch.parallel.sharding",
                       fromlist=["tree_flatten"]).tree_flatten(full)}
    return {"held": held, "losses": losses, "params": flat,
            "bucket_bytes": 4 * sum(padded)}


@pytest.mark.parametrize("model", ["linear", "gpt_remat"])
def test_stage3_holds_no_gathered_bucket_for_backward(pool, model):
    """After the stage-3 forward no full bucket is alive: every saved
    view of one is a token, gathered again in backward. The same run
    with the hooks passing tensors through (the schedule before the
    re-gather) holds buckets at that point, and the two runs' losses
    and parameters are equal bit for bit."""
    got = pool.run(case_stage3_held, model, True)
    old = pool.run(case_stage3_held, model, False)
    for new_rank, old_rank in zip(got, old):
        assert new_rank["held"] == [0, 0]
        assert all(h > 0 for h in old_rank["held"])
        assert new_rank["losses"] == old_rank["losses"]
        for key, value in old_rank["params"].items():
            np.testing.assert_array_equal(new_rank["params"][key], value)


# =========================================================================
# the collectives each schedule plans
# =========================================================================

def case_collectives(kind: dict | None, clip: float | None) -> dict:
    """The ``torch.distributed`` collectives of one step (after one
    warm step), by kind, and what the schedule plans."""
    counts = dict.fromkeys(("all_reduce", "reduce_scatter", "all_to_all",
                            "all_gather"), 0)
    names = {"all_reduce": "all_reduce",
             "reduce_scatter_tensor": "reduce_scatter",
             "reduce_scatter_single": "reduce_scatter",
             "all_to_all_single": "all_to_all",
             "all_gather_into_tensor": "all_gather",
             "all_gather_single": "all_gather"}
    mesh = dist.make_mesh("dp", device="cpu")
    params, host = host_problem()
    params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tx = OptimizerConfig(name="adamw", lr=LR).make()
    comms = port_schedule(mesh, kind)
    state = comms.create_state(params, tx)
    step = utils.make_step(port_loss, tx, clip=clip, comms=comms)
    batch = dist.shard_batch(host, mesh)
    state, _ = step(state, batch)
    saved = {name: getattr(tdist, name) for name in names
             if hasattr(tdist, name)}

    def counting(name):
        def call(*args, **kwargs):
            counts[names[name]] += 1
            return saved[name](*args, **kwargs)
        return call

    try:
        for name in saved:
            setattr(tdist, name, counting(name))
        step(state, batch)
    finally:
        for name, fn in saved.items():
            setattr(tdist, name, fn)
    from torchbooster_tpu_torch.comms.schedule import as_schedule

    return {"counts": counts,
            "planned": as_schedule(comms).collectives_per_step(
                clip is not None)}


@pytest.mark.parametrize("kind,clip", [
    ({"legacy": ("implicit", False)}, None), ({"stage": 0, "wire": "fp32"},
                                              1.0),
    ({"stage": 0, "wire": "bf16"}, None), ({"stage": 0, "wire": "int8"}, None),
    ({"stage": 1, "wire": "int8"}, 1.0), ({"legacy": ("implicit", True)},
                                          None),
    ({"stage": 2, "wire": "int8", "overlap": True}, 1.0),
    ({"stage": 2, "wire": "bf16"}, None), (STAGE3, None),
    ({"stage": 3, "wire": "int8"}, 1.0)])
def test_collectives_per_step_match_the_plan(pool, kind, clip):
    got = pool.run(case_collectives, kind, clip)[0]
    assert got["counts"] == got["planned"]


# =========================================================================
# sharded checkpoints: resume, world change, JAX <-> port
# =========================================================================

def case_resume(kind: dict, root: str) -> dict:
    """Six steps, saved at step 3; a fresh state restored from the save
    runs steps 4-6: both runs' losses and parameters."""
    mesh = dist.make_mesh("dp", device="cpu")
    params, host = host_problem()
    tx = OptimizerConfig(name="adamw", lr=LR, weight_decay=1e-4).make()
    comms = port_schedule(mesh, kind)

    def fresh():
        return comms.create_state({k: torch.from_numpy(v.copy())
                                   for k, v in params.items()}, tx)

    step = utils.make_step(port_loss, tx, comms=comms)
    batch = dist.shard_batch(host, mesh)
    state, losses = fresh(), []
    cb = SaveCallback(1, 100, root=root, sharded=True, comms=comms)
    for i in range(6):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i == 2:
            cb.save(3, state=state)
    cb.wait()
    assert cb.latest_step() == 3
    restored = cb.restore(like={"state": fresh()})["state"]
    assert restored.step == 3
    resumed = []
    for _ in range(3):
        restored, m = step(restored, batch)
        resumed.append(float(m["loss"]))

    def full(st):
        p = comms.gather_params(st)
        return {k: v.detach().numpy().copy() for k, v in p.items()}

    return {"losses": losses[3:], "resumed": resumed, "params": full(state),
            "params_resumed": full(restored),
            "comms": {k: v.numpy() for k, v in (state.comms or {}).items()},
            "comms_resumed": {k: v.numpy()
                              for k, v in (restored.comms or {}).items()}}


@pytest.mark.parametrize("kind", [{"stage": 2, "wire": "int8",
                                   "overlap": True}, STAGE3,
                                  {"stage": 0, "wire": "int8"}])
def test_sharded_checkpoint_resume_is_bit_exact(pool, tmp_path, kind):
    for res in pool.run(case_resume, kind, str(tmp_path)):
        assert res["resumed"] == res["losses"]
        for key in res["params"]:
            np.testing.assert_array_equal(res["params_resumed"][key],
                                          res["params"][key])
        for key in res["comms"]:
            np.testing.assert_array_equal(res["comms_resumed"][key],
                                          res["comms"][key])
    manifest = json.loads((tmp_path / "ckpt_003" / "manifest.json")
                          .read_text())
    if kind.get("stage") >= 1:
        assert manifest["comms"]["n_shards"] == 2
        entry = manifest["leaves"]["['state'].opt_state[0].mu"]
        assert entry["sharded"] and entry["n_chunks"] == 2
    assert not any(p.name.startswith(".tmp") for p in tmp_path.iterdir())


def case_save(kind: dict, root: str, steps: int) -> None:
    mesh = dist.make_mesh("dp", device="cpu")
    params, host = host_problem()
    tx = OptimizerConfig(name="adamw", lr=LR, weight_decay=1e-4).make()
    comms = port_schedule(mesh, kind)
    state = comms.create_state({k: torch.from_numpy(v.copy())
                                for k, v in params.items()}, tx)
    step = utils.make_step(port_loss, tx, comms=comms)
    batch = dist.shard_batch(host, mesh)
    for _ in range(steps):
        state, _ = step(state, batch)
    cb = SaveCallback(1, 100, root=root, sharded=True, comms=comms)
    cb.save(steps, state=state)
    cb.wait()


def case_restore(kind: dict, root: str, step: int) -> dict:
    """This rank's restore of the checkpoint at ``step``: the full
    parameters, the optimizer's raw flat moments, the residuals, and one
    more step's loss."""
    mesh = dist.make_mesh("dp", device="cpu")
    params, host = host_problem()
    tx = OptimizerConfig(name="adamw", lr=LR, weight_decay=1e-4).make()
    comms = port_schedule(mesh, kind)
    template = comms.create_state({k: torch.from_numpy(v.copy())
                                   for k, v in params.items()}, tx)
    cb = SaveCallback(1, 100, root=root, sharded=True, comms=comms)
    state = cb.restore(step, like={"state": template})["state"]
    plan = comms.plan()
    moments = {}
    for name in ("exp_avg", "exp_avg_sq"):
        local = next(iter(state.optimizer.state.values()))[name]
        full = torch.empty(local.numel() * mesh.size)
        dist.all_gather(full, local, mesh.group(("dp",)))
        moments[name] = plan.strip_pads_host(full.numpy())
    out = {"params": {k: v.detach().numpy().copy()
                      for k, v in comms.gather_params(state).items()},
           "moments": moments, "step": state.step,
           "count": float(next(iter(state.optimizer.state.values()))["step"]),
           "comms": {k: v.numpy().copy() for k, v in
                     (state.comms or {}).items()}}
    step_fn = utils.make_step(port_loss, tx, comms=comms)
    _, m = step_fn(state, dist.shard_batch(host, mesh))
    out["next_loss"] = float(m["loss"])
    return out


def _jax_state(kind: dict, n: int, steps: int):
    import jax
    import jax.numpy as jnp
    import optax

    from torchbooster_tpu import distributed as jdist
    from torchbooster_tpu.utils import make_step as jmake_step

    mesh = jdist.make_mesh("dp", n)
    params, host = host_problem()
    params = jax.tree.map(jnp.asarray, params)
    tx = optax.adamw(LR)
    sched = jax_schedule(mesh, kind)
    state = sched.create_state(params, tx)
    sched.plan(params)                      # the manifest's comms block
    step = jmake_step(jax_loss, tx, comms=sched)
    batch = jdist.shard_batch(host, mesh)
    for _ in range(steps):
        state, _ = step(state, batch)
    return sched, state, tx, params


def _jax_moments(sched, state) -> dict:
    plan = sched.plan()
    leaf = state.opt_state[0]
    return {"exp_avg": plan.strip_pads_host(np.asarray(leaf.mu)),
            "exp_avg_sq": plan.strip_pads_host(np.asarray(leaf.nu))}


@pytest.mark.parametrize("kind", [STAGE1, {"stage": 2, "wire": "int8",
                                           "overlap": True}, STAGE3])
def test_jax_checkpoint_restores_into_the_port_at_another_world(
        pool, tmp_path, kind):
    """JAX writes at dp=4; the port restores at world 2: the parameters
    and the pad-stripped optimizer moments arrive exactly, int8
    residuals reset (per-replica state), and training goes on."""
    from torchbooster_tpu.callbacks import SaveCallback as JSaveCallback

    sched, state, _, _ = _jax_state(kind, 4, 2)
    writer = JSaveCallback(1, 100, root=tmp_path, sharded=True, comms=sched)
    writer.save(2, state=state)
    writer.wait()
    want_p = {k: np.asarray(v)
              for k, v in sched.gather_params(state).items()}
    want_m = _jax_moments(sched, state)
    for res in pool.run(case_restore, kind, str(tmp_path), 2):
        for key in want_p:
            np.testing.assert_array_equal(res["params"][key], want_p[key])
        for key in want_m:
            np.testing.assert_array_equal(res["moments"][key], want_m[key])
        assert res["step"] == 2 and res["count"] == 2.0
        for value in res["comms"].values():
            assert not value.any()
        assert np.isfinite(res["next_loss"])


def test_port_checkpoint_restores_in_jax(pool, tmp_path, caplog):
    """The port writes stage 2 int8 at world 2; the JAX package restores
    it at dp=4 through its own reshard."""
    from torchbooster_tpu import distributed as jdist
    from torchbooster_tpu.callbacks import SaveCallback as JSaveCallback
    from torchbooster_tpu.utils import make_step as jmake_step

    kind = {"stage": 2, "wire": "int8", "overlap": True}
    pool.run(case_save, kind, str(tmp_path), 2)
    mine = pool.run(case_restore, kind, str(tmp_path), 2)[0]
    sched, template, tx, params = _jax_state(kind, 4, 0)
    cb = JSaveCallback(1, 100, root=tmp_path, sharded=True, comms=sched)
    restored = cb.restore(like={"state": template})["state"]
    for key in mine["params"]:
        np.testing.assert_array_equal(np.asarray(restored.params[key]),
                                      mine["params"][key])
    got_m = _jax_moments(sched, restored)
    for key in got_m:
        np.testing.assert_array_equal(got_m[key], mine["moments"][key])
    assert int(restored.step) == 2 and int(restored.opt_state[0].count) == 2
    assert not np.asarray(restored.comms["ef1"]).any()
    step = jmake_step(jax_loss, tx, comms=sched)
    _, m = step(restored, jdist.shard_batch(host_problem()[1], sched.mesh))
    assert np.isfinite(float(m["loss"]))


def test_sharded_restore_without_schedule_fails_loudly(pool, tmp_path):
    kind = {"stage": 2, "wire": "fp32"}
    pool.run(case_save, kind, str(tmp_path), 1)
    mesh = dist.make_mesh("dp", device="cpu")
    params, _ = host_problem()
    tx = OptimizerConfig(name="adamw", lr=LR).make()
    comms = port_schedule(mesh, kind)
    template = comms.create_state({k: torch.from_numpy(v.copy())
                                   for k, v in params.items()}, tx)
    naked = SaveCallback(1, 100, root=tmp_path, sharded=True)
    with pytest.raises(ValueError, match="data-parallel world"):
        naked.restore(like={"state": template})
    # with the schedule the world-2 checkpoint restores on one process
    ok = SaveCallback(1, 100, root=tmp_path, sharded=True, comms=comms)
    assert ok.restore(like={"state": template})["state"].step == 1


# =========================================================================
# the 50-step trajectory (slow, as JAX's own)
# =========================================================================

def case_gpt_int8_vs_fp32(steps: int) -> dict:
    from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig
    from torchbooster_tpu_torch.ops.losses import cross_entropy

    cfg = GPTConfig(vocab=256, n_layers=2, d_model=64, n_heads=2,
                    seq_len=32)
    mesh = dist.make_mesh("dp", device="cpu")
    tx = OptimizerConfig(name="adamw", lr=3e-3).make()

    def loss_fn(p, b, g):
        logits = GPT.apply(p, b["ids"][:, :-1], cfg,
                           compute_dtype=torch.float32, remat=False)
        return cross_entropy(logits, b["ids"][:, 1:]), {}

    rs = np.random.RandomState(7)
    batches = []
    for _ in range(steps):
        ids = rs.randint(0, cfg.vocab, (8, cfg.seq_len)).astype(np.int64)
        ids[:, 1::2] = (ids[:, ::2] + 1) % cfg.vocab   # learnable
        batches.append(dist.shard_batch({"ids": ids}, mesh))
    out = {}
    for wire in ("fp32", "int8"):
        sched = make_grad_comms(mesh, mode=wire, bucket_size=128)
        state = sched.create_state(GPT.init(0, cfg, device="cpu"), tx)
        step = utils.make_step(loss_fn, tx, comms=sched)
        for batch in batches:
            state, m = step(state, batch)
        out[wire] = float(m["loss"])
    return out


@pytest.mark.slow
def test_gpt_int8_loss_within_1pct_of_fp32_after_50_steps(pool):
    got = pool.run(case_gpt_int8_vs_fp32, 50)[0]
    assert got["int8"] == pytest.approx(got["fp32"], rel=0.01), got
