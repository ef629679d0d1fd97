"""The port's distributed runtime (``torchbooster_tpu_torch.distributed``,
``parallel.sharding``, ``EnvConfig.make``) against the JAX package.

Multi-rank cases run on gloo process groups on the CPU: :class:`RankPool`
spawns the ranks once per test file (``torch.multiprocessing``, spawn)
and feeds them cases, module-level functions of the test file that each
rank runs. The JAX side runs on the 8 virtual CPU devices of
``tests/conftest.py``; rank ``r`` of the port stands for device ``r``.
The ranks import this file to find their cases, so the JAX package is
imported inside the functions that run it, in the test process only."""
from __future__ import annotations

import importlib
import logging
import os
import shutil
import tempfile
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from torchbooster_tpu_torch import distributed as dist
from torchbooster_tpu_torch.config import EnvConfig
from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig
from torchbooster_tpu_torch.parallel import make_param_specs
from torchbooster_tpu_torch.parallel.sharding import P

TINY = dict(vocab=64, n_layers=2, d_model=32, n_heads=2, seq_len=16)


# =========================================================================
# The rank pool
# =========================================================================

def _serve(rank: int, world: int, store: str, conn) -> None:
    """Spawn target: one gloo rank that runs the cases it is sent —
    ``(module, function, args)`` — and sends back each result."""
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    tdist.init_process_group("gloo", init_method=f"file://{store}",
                             world_size=world, rank=rank)
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            module, name, args = msg
            try:
                fn = getattr(importlib.import_module(module), name)
                conn.send(("ok", fn(*args)))
            except Exception:
                conn.send(("err", traceback.format_exc()))
    finally:
        tdist.destroy_process_group()


class RankPool:
    """``world`` gloo ranks kept alive for a test file. :meth:`run` sends
    a case to every rank and returns the per-rank results; a failing,
    hung or dying case takes the pool down, and the next case starts it
    again. The ranks meet in a file of a fresh temporary directory, not
    on a TCP port, so no other process can take their rendezvous between
    the pick and the bind."""

    def __init__(self, world: int):
        self.world = world
        self._procs: list = []
        self._conns: list = []
        self._dir: str | None = None

    def start(self) -> None:
        """Spawn the ranks now, if they are not running: they import
        while the test process works."""
        import torch.multiprocessing as mp

        if self._procs:
            return

        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="rank_pool_")
        store = os.path.join(self._dir, "store")
        for rank in range(self.world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_serve,
                               args=(rank, self.world, store, child),
                               daemon=True)
            proc.start()
            self._procs.append(proc)
            self._conns.append(parent)

    def run(self, fn, *args, timeout: float = 120.0) -> list:
        self.start()
        try:
            return self._run(fn, args, timeout)
        except (EOFError, ConnectionError) as err:
            # a rank's pipe closed: the rank died
            self.close(kill=True)
            raise AssertionError(f"{fn.__name__}: a rank died "
                                 f"({err!r})") from err

    def _run(self, fn, args: tuple, timeout: float) -> list:
        for conn in self._conns:
            conn.send((fn.__module__, fn.__name__, args))
        out, errors = [], []
        for conn in self._conns:
            if not conn.poll(timeout):
                self.close(kill=True)
                raise TimeoutError(f"{fn.__name__}: a rank did not answer "
                                   f"in {timeout} s")
            status, value = conn.recv()
            (errors if status == "err" else out).append(value)
        if errors:
            self.close(kill=True)
            raise AssertionError("\n".join(errors))
        return out

    def close(self, kill: bool = False) -> None:
        # every rank is told first: each leaves the group together
        for conn in self._conns if not kill else ():
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for proc in self._procs:
            proc.join(timeout=0 if kill else 20)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
        self._procs, self._conns = [], []
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


# =========================================================================
# rank helpers without a group
# =========================================================================

def test_rank_helpers_without_a_group():
    from torchbooster_tpu import distributed as jdist

    assert not tdist.is_initialized()
    assert dist.get_rank() == 0 and dist.get_local_rank() == 0
    assert dist.get_world_size() == 1 and dist.is_primary()
    assert dist.get_device_count() >= 1
    dist.synchronize()                       # a no-op for one process
    out = dist.gather({"a": np.arange(3), "b": [torch.ones(2)]})
    assert out["a"].shape == (1, 3) and out["b"][0].shape == (1, 2)
    # JAX's single-process answers
    assert (dist.get_rank(), dist.get_world_size()) == \
        (jdist.get_rank(), jdist.get_world_size())
    assert dist.gather({"a": np.arange(3)})["a"].shape == \
        jdist.gather({"a": np.arange(3)})["a"].shape
    mesh = dist.make_mesh("dp", device="cpu")
    assert mesh.shape == {"dp": 1} and not mesh.distributed
    assert dist.local_devices(mesh) == [torch.device("cpu")]


# =========================================================================
# parse_mesh_spec: the same answers and the same errors as JAX's
# =========================================================================

@pytest.mark.parametrize("spec,n", [
    ("dp", 8), ("dp:2,tp:4", 8), ("dp,tp:2", 8), ("dp,fsdp:2", 4),
    (" dp , fsdp:2 ", 2), ("dp,tp", 8), ("dp:3,tp:4", 8), ("", 8),
    ("dp:2,dp:4", 8), ("dp:2,tp:2,dp", 8), ("dp:0", 8), ("dp:2,tp:-4", 8),
    ("dp:two", 8), ("dp:3,tp", 8)])
def test_parse_mesh_spec_matches_jax(spec, n):
    from torchbooster_tpu import distributed as jdist

    try:
        want = jdist.parse_mesh_spec(spec, n)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            dist.parse_mesh_spec(spec, n)
        assert str(got.value) == str(err)
    else:
        assert dist.parse_mesh_spec(spec, n) == want


# =========================================================================
# make_param_specs on GPT's rules, over dp and dp,fsdp:2
# =========================================================================

def _norm_spec(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in tuple(spec))


def _specs_flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_specs_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): _norm_spec(tree)}


def case_param_specs(spec: str) -> dict:
    mesh = dist.make_mesh(spec, device="cpu")
    params = GPT.init(0, GPTConfig(**TINY), device="cpu")
    return _specs_flat(make_param_specs(params, GPT.SHARDING_RULES,
                                        mesh=mesh))


def _jax_specs(spec: str, n: int) -> dict:
    import jax

    from torchbooster_tpu import distributed as jdist
    from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
    from torchbooster_tpu.parallel import make_param_specs as jmake_param_specs

    mesh = jdist.make_mesh(spec, n)
    params = JGPT.init(jax.random.PRNGKey(0), JGPTConfig(**TINY))
    specs = jmake_param_specs(params, JGPT.SHARDING_RULES, mesh=mesh)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(k.key) for k in path): _norm_spec(s)
            for path, s in flat}


@pytest.mark.parametrize("spec", ["dp", "dp,fsdp:2"])
def test_make_param_specs_matches_jax(pool, spec):
    got = pool.run(case_param_specs, spec)
    want = _jax_specs(spec, 2)
    assert got[0] == got[1] == want
    if "fsdp" in spec:
        assert want["blocks/attn_qkv/kernel"] == (None, "fsdp", None)


# =========================================================================
# shard_batch: rank r holds the rows JAX's batch_sharding puts on device r
# =========================================================================

def _jax_rows(spec: str, n: int, host: np.ndarray) -> list:
    from torchbooster_tpu import distributed as jdist

    placed = jdist.shard_batch({"x": host}, jdist.make_mesh(spec, n))["x"]
    rows = {s.device.id: np.asarray(s.data) for s in placed.addressable_shards}
    return [rows[i] for i in range(n)]


@pytest.mark.parametrize("spec,n", [("dp", 2), ("dp,fsdp:2", 4),
                                    ("dp:2,fsdp:2", 4), ("fsdp", 4)])
def test_shard_batch_rows_match_jax(spec, n):
    host = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    want = _jax_rows(spec, n, host)
    names, sizes = dist.parse_mesh_spec(spec, n)
    for rank in range(n):
        mesh = dist.Mesh(axis_names=names, sizes=sizes,
                         device=torch.device("cpu"), rank=rank)
        got = dist.shard_batch({"x": host}, mesh)["x"]
        np.testing.assert_array_equal(got.numpy(), want[rank])


def case_shard_batch(host: np.ndarray) -> np.ndarray:
    mesh = dist.get_mesh(EnvConfig(distributed=True, mesh="dp"), "cpu")
    assert mesh.distributed and mesh.shape == {"dp": 2}
    return EnvConfig(distributed=True).shard_batch({"x": host}, "cpu")[
        "x"].numpy()


def test_shard_batch_over_a_gloo_group(pool):
    host = np.arange(6 * 2, dtype=np.int64).reshape(6, 2)
    got = pool.run(case_shard_batch, host)
    want = _jax_rows("dp", 2, host)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# =========================================================================
# launch
# =========================================================================

def _launched(scale: int) -> dict:
    """A launched function: this rank's view of the world."""
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t, tdist.group.WORLD)
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "local": dist.get_local_rank(), "backend": tdist.get_backend(),
            "sum": scale * float(t)}


def _mesh_on_card() -> str:
    try:
        dist.make_mesh("dp", device="cuda")
    except RuntimeError as e:
        return str(e)
    return ""


def test_launch_inline_and_at_world_2():
    assert dist.launch(lambda a, b: a + b, args=(2, 3)) == 5
    assert not tdist.is_initialized()
    with pytest.raises(ValueError, match="explicit coordinator"):
        dist.launch(lambda: None, n_machine=2, dist_url="auto")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dist.launch(lambda: None, n_devices=2)
        # gloo over card tensors asks for a card all the same
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dist.launch(lambda: None, n_devices=2, backend="gloo")
        # inside a gloo group on the CPU, a mesh asked on the card raises
        # rather than landing on the CPU
        err = dist.launch(_mesh_on_card, n_devices=1, distributed=True,
                          device="cpu")
        assert "device='cpu'" in err
    # one device under distributed: a world-1 group in this process
    one = dist.launch(_launched, n_devices=1, args=(1,), distributed=True,
                      device="cpu")
    assert one == {"rank": 0, "world": 1, "local": 0, "backend": "gloo",
                   "sum": 1.0}
    assert not tdist.is_initialized()
    two = dist.launch(_launched, n_devices=2, args=(10,), device="cpu")
    assert two == [{"rank": r, "world": 2, "local": r, "backend": "gloo",
                    "sum": 30.0} for r in range(2)]


# =========================================================================
# EnvConfig.make: DDP's broadcast, and placement by the rule table
# =========================================================================

def case_env_make(rules: bool, seed_by_rank: bool) -> dict:
    env = EnvConfig(distributed=True, mesh="dp,fsdp:2")
    cfg = GPTConfig(**TINY)
    # every rank draws other weights: make() must give rank 0's
    seed = dist.get_rank() if seed_by_rank else 0
    params = GPT.init(seed, cfg, device="cpu")
    records: list = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger().addHandler(handler)
    try:
        placed = env.make(params, model=GPT if rules else None,
                          device="cpu")
    finally:
        logging.getLogger().removeHandler(handler)
    a, b = env.make(torch.ones(2) * (dist.get_rank() + 1),
                    np.zeros(2, np.float32), device="cpu")
    return {"qkv": placed["blocks"]["attn_qkv"]["kernel"].numpy(),
            "wte": placed["wte"]["table"].numpy(),
            "spec": getattr(placed["blocks"]["attn_qkv"]["kernel"], "spec",
                            None),
            "a": a.numpy(), "b": b.numpy(),
            "warnings": [r.getMessage() for r in records
                         if r.levelno >= logging.WARNING]}


def test_env_make_places_by_rules(pool):
    import jax

    from torchbooster_tpu import distributed as jdist
    from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig

    cfg = JGPTConfig(**TINY)
    full = GPT.init(0, GPTConfig(**TINY), device="cpu")
    qkv = full["blocks"]["attn_qkv"]["kernel"].numpy()
    wte = full["wte"]["table"].numpy()
    # JAX's layout of the same kernel over dp,fsdp:2
    mesh = jdist.make_mesh("dp,fsdp:2", 2)
    jparams = jax.tree.map(np.asarray, JGPT.init(jax.random.PRNGKey(0), cfg))
    jparams["blocks"]["attn_qkv"]["kernel"] = qkv
    placed = jdist.to_env(jparams, mesh, rules=JGPT.SHARDING_RULES)
    blocks = {s.device.id: np.asarray(s.data) for s in
              placed["blocks"]["attn_qkv"]["kernel"].addressable_shards}
    got = pool.run(case_env_make, True, True)
    for rank, res in enumerate(got):
        np.testing.assert_array_equal(res["qkv"], blocks[rank])
        np.testing.assert_array_equal(res["wte"], wte)     # replicated
        assert res["spec"] == (None, "fsdp", None)
        np.testing.assert_array_equal(res["a"], [1.0, 1.0])
        np.testing.assert_array_equal(res["b"], [0.0, 0.0])
        assert res["warnings"] == []
    # without rules an fsdp mesh replicates, as JAX's does, and says so
    got = pool.run(case_env_make, False, True)
    for res in got:
        np.testing.assert_array_equal(res["qkv"], qkv)
        assert res["spec"] is None
        assert any("fsdp" in w and "replicate" in w for w in res["warnings"])


def test_prefetch_to_device_places_on_the_rank_device():
    from torchbooster_tpu_torch.data import prefetch_to_device

    mesh = dist.get_mesh(EnvConfig(distributed=True), "cpu")
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(3)]
    got = list(prefetch_to_device(batches, device="cuda", mesh=mesh))
    assert [b["x"].device for b in got] == [mesh.device] * 3
    assert [float(b["x"][0, 0]) for b in got] == [0.0, 1.0, 2.0]


def test_env_make_on_one_device():
    env = EnvConfig(distributed=True, mesh="dp")
    placed = env.make({"w": torch.ones(2, 2), "meta": "keep-me"},
                      device="cpu")
    assert torch.equal(placed["w"], torch.ones(2, 2))
    assert placed["meta"] == "keep-me"
    a, b = env.make(torch.ones(2), np.zeros(2), device="cpu")
    assert torch.equal(a, torch.ones(2)) and torch.equal(b, torch.zeros(2,
                                                         dtype=b.dtype))
    assert env.device("cpu") == torch.device("cpu")
    # distributed: false degrades any topology to one device
    assert dist.get_mesh(EnvConfig(mesh="dp:4,fsdp:2"), "cpu").shape == \
        {"dp": 1}


# =========================================================================
# make_step with rules: fsdp-sharded GPT against JAX's implicit path
# =========================================================================

def _tiny_batch() -> dict:
    rs = np.random.RandomState(3)
    return {"ids": rs.randint(0, TINY["vocab"], (4, TINY["seq_len"])),
            "labels": rs.randint(0, TINY["vocab"], (4, TINY["seq_len"]))}


def case_rules_step(host: dict, steps: int) -> dict:
    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.config import OptimizerConfig
    from torchbooster_tpu_torch.ops.losses import cross_entropy

    env = EnvConfig(distributed=True, mesh="dp,fsdp:2")
    mesh = dist.get_mesh(env, "cpu")
    cfg = GPTConfig(**TINY)
    tx = OptimizerConfig(name="adamw", lr=1e-2, weight_decay=1e-4).make()
    state = utils.TrainState.create(GPT.init(0, cfg, device="cpu"), tx)
    state = env.make(state, model=GPT, device="cpu")

    def loss_fn(p, b, g):
        logits = GPT.apply(p, b["ids"], cfg, compute_dtype=torch.float32,
                           remat=False)
        return cross_entropy(logits, b["labels"]), {}

    step = utils.make_step(loss_fn, tx, clip=0.5, mesh=mesh,
                           rules=GPT.SHARDING_RULES)
    batch = env.shard_batch(host, "cpu")
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return {"losses": losses,
            "qkv": state.params["blocks"]["attn_qkv"]["kernel"].detach()
            .numpy(),
            "wte": state.params["wte"]["table"].detach().numpy()}


def test_make_step_rules_matches_jax(pool):
    import jax
    import jax.numpy as jnp
    import optax

    from torchbooster_tpu import distributed as jdist
    from torchbooster_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
    from torchbooster_tpu.ops.losses import cross_entropy as jce
    from torchbooster_tpu.utils import TrainState as JState, make_step

    host = _tiny_batch()
    cfg = JGPTConfig(**TINY)
    mesh = jdist.make_mesh("dp,fsdp:2", 2)
    full = GPT.init(0, GPTConfig(**TINY), device="cpu")
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), full)
    params = jdist.to_env(params, mesh, rules=JGPT.SHARDING_RULES)

    def loss_fn(p, b, rng):
        logits = JGPT.apply(p, b["ids"], cfg, compute_dtype=jnp.float32,
                            remat=False)
        return jce(logits.reshape(-1, cfg.vocab), b["labels"].reshape(-1)), {}

    tx = optax.adamw(1e-2)
    state = JState.create(params, tx)
    step = make_step(loss_fn, tx, clip=0.5, mesh=mesh,
                     rules=JGPT.SHARDING_RULES)
    batch = jdist.shard_batch({k: v.astype(np.int32) for k, v in host.items()},
                              mesh)
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    got = pool.run(case_rules_step, host, 3)
    qkv = np.asarray(state.params["blocks"]["attn_qkv"]["kernel"])
    # fp32 throughout, the sums in another order on each side: losses
    # 1e-5 relative; parameters 2e-5 absolute, 0.2% of one lr-sized
    # update, because AdamW divides each update by √v and so turns the
    # fp32 noise of a near-zero gradient entry into an update difference
    # (tests/test_torch_train.py states the same for one device)
    for rank, res in enumerate(got):
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
        half = qkv.shape[1] // 2
        np.testing.assert_allclose(
            res["qkv"], qkv[:, rank * half:(rank + 1) * half], atol=2e-5,
            rtol=0)
        np.testing.assert_allclose(res["wte"],
                                   np.asarray(state.params["wte"]["table"]),
                                   atol=2e-5, rtol=0)


# =========================================================================
# model axes: every axis runs; at world 1 a size above 1 is JAX's error
# =========================================================================

def test_model_axes_raise():
    """Every JAX axis builds a mesh now (tp and pp included): at world 1
    an axis of size above 1 raises JAX's device-count error, and a rule
    that names tp or pp shards where the axis has a size above 1."""
    for spec in ("dp,tp:2", "pp:2", "dp:1,sp:2,tp:2", "ep:2,pp:2",
                 "dp:1,sp:2", "dp,ep:4"):
        with pytest.raises(ValueError, match="devices"):
            dist.make_mesh(spec, device="cpu")
        with pytest.raises(ValueError, match="devices"):
            EnvConfig(distributed=True, mesh=spec).device("cpu")
    one = dist.make_mesh("dp,sp:1,ep:1", device="cpu")
    assert one.shape == {"dp": 1, "sp": 1, "ep": 1}
    assert one.token_axes() == ("dp", "sp") and one.axis("ep") is None
    # a rule that names tp on a mesh where tp has a size above 1 shards
    mesh = dist.Mesh(axis_names=("dp", "tp"), sizes=(1, 2),
                     device=torch.device("cpu"))
    assert make_param_specs({"w": torch.zeros(4, 4)},
                            [(r"w", P(None, "tp"))], mesh=mesh) == \
        {"w": (None, "tp")}
    pp = dist.Mesh(axis_names=("pp", "tp"), sizes=(2, 2),
                   device=torch.device("cpu"))
    assert make_param_specs({"w": torch.zeros(4, 6)},
                            [(r"w", P("pp", "tp"))], mesh=pp) == \
        {"w": ("pp", "tp")}
    # an ep rule shards where ep has a size above 1
    ep = dist.Mesh(axis_names=("dp", "ep"), sizes=(1, 2),
                   device=torch.device("cpu"))
    assert make_param_specs({"w": torch.zeros(4, 4)}, [(r"w", P("ep"))],
                            mesh=ep) == {"w": ("ep", None)}
    # absent or size-1 model axes are dropped, as JAX's _filter_spec does
    one = dist.make_mesh("dp,tp:1", device="cpu")
    assert make_param_specs({"w": torch.zeros(4, 4)},
                            [(r"w", P(None, "tp"))], mesh=one) == \
        {"w": (None, "tp")}


def test_gpt_recipe_with_fsdp_rules_under_launch(tmp_path):
    from tests.test_torch_comms import run_recipe_at_world_2

    run_recipe_at_world_2(tmp_path, "dp,fsdp:2", "")


def case_rules_checkpoint(root: str) -> dict:
    """Two steps of the fsdp-sharded GPT, a sharded save, a fresh state
    laid out by the rules restored from it: this rank's blocks of the
    parameters and of adam's moments before and after."""
    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.callbacks import SaveCallback
    from torchbooster_tpu_torch.config import OptimizerConfig
    from torchbooster_tpu_torch.ops.losses import cross_entropy

    env = EnvConfig(distributed=True, mesh="dp,fsdp:2")
    mesh = dist.get_mesh(env, "cpu")
    cfg = GPTConfig(**TINY)
    tx = OptimizerConfig(name="adamw", lr=1e-2, weight_decay=1e-4).make()

    def fresh():
        state = utils.TrainState.create(GPT.init(0, cfg, device="cpu"), tx)
        return env.make(state, model=GPT, device="cpu")

    def loss_fn(p, b, g):
        logits = GPT.apply(p, b["ids"], cfg, compute_dtype=torch.float32,
                           remat=False)
        return cross_entropy(logits, b["labels"]), {}

    step = utils.make_step(loss_fn, tx, mesh=mesh, rules=GPT.SHARDING_RULES)
    batch = env.shard_batch(_tiny_batch(), "cpu")
    state = fresh()
    for _ in range(2):
        state, _ = step(state, batch)
    cb = SaveCallback(1, 10, root=root, sharded=True)
    cb.save(2, state=state)
    cb.wait()
    restored = cb.restore(like={"state": fresh()})["state"]

    def blocks(st):
        qkv = st.params["blocks"]["attn_qkv"]["kernel"]
        return {"qkv": qkv.detach().numpy().copy(),
                "mu": st.optimizer.state[qkv]["exp_avg"].numpy().copy(),
                "wte": st.params["wte"]["table"].detach().numpy().copy()}

    return {"saved": blocks(state), "restored": blocks(restored),
            "step": restored.step}


def test_sharded_checkpoint_of_a_rule_sharded_state(pool, tmp_path):
    import json

    got = pool.run(case_rules_checkpoint, str(tmp_path))
    for res in got:
        assert res["restored"]["qkv"].shape == (2, 16, 96)   # 32 / fsdp 2
        for key in res["saved"]:
            np.testing.assert_array_equal(res["restored"][key],
                                          res["saved"][key])
        assert res["step"] == 2
    manifest = json.loads((tmp_path / "ckpt_02" / "manifest.json")
                          .read_text())
    entry = manifest["leaves"]["['state'].params['blocks']['attn_qkv']"
                               "['kernel']"]
    assert entry == {"sharded": True, "n_chunks": 2,
                     "starts": [[0, 0, 0], [0, 16, 0]], "shape": [2, 32, 96]}
    data = np.load(tmp_path / "ckpt_02" / "arrays.npz")
    full = np.concatenate([data["['state'].params['blocks']['attn_qkv']"
                                "['kernel']##0"],
                           data["['state'].params['blocks']['attn_qkv']"
                                "['kernel']##1"]], axis=1)
    np.testing.assert_array_equal(full[:, :16], got[0]["saved"]["qkv"])
    np.testing.assert_array_equal(full[:, 16:], got[1]["saved"]["qkv"])
