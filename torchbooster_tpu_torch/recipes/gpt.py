"""GPT language modeling — the port of the JAX recipe
``examples/lm/gpt/gpt.py``, driven by the same YAML:

    python -m torchbooster_tpu_torch.recipes.gpt [config.yml]

which runs :func:`main` under ``distributed.launch``: one process per
card of ``env.n_devices`` (``n_gpu``), each in the NCCL group, or with
``env.distributed: true`` on one card a world-1 group.

(``examples/lm/gpt/gpt.yml`` by default, ``gpt-long.yml`` for the
long-context run; a YAML is read, never written, and reading it needs
PyYAML). The flow is the JAX recipe's: synthetic, registered token or
byte-level ``text_file`` data, ``GPT.apply`` at the ``env.precision``
compute dtype over fp32 masters with per-block remat and the model's
dropout (a generator on the card, the train state's, drives its masks;
eval and sampling run without), the full or chunked
(``model.chunked_head``) LM-head loss, ``utils.make_step`` with the
optimizer and cycle schedule of the YAML, global-norm clipping and
accumulation, metrics read at ``log_every``, a checkpoint every
``save_every`` steps under ``checkpoint_root`` and a resume from the
newest one at setup (``callbacks.SaveCallback``; the loader starts again
from its first batch, as in the JAX recipe), held-out loss over
``eval_batches`` and a KV-cache sample of ``sample_tokens``, printed as
text at vocab 256. On the card, attention forward and backward run the
flash kernels.

Across ranks (``env.distributed: true``, ``env.mesh: dp`` or
``dp,fsdp:N``): the loader gives each rank its strided shard of the
global batch, the state is laid out by ``GPT.SHARDING_RULES`` (the block
kernels shard over ``fsdp``, the experts of MoE blocks over ``ep``) and
``make_step`` averages the gradient over the data axes; an optional
``comms:`` block (``CommsConfig``: ZeRO stage, wire format, overlap)
replaces that with the explicit schedule and its sharded checkpoint. On
a mesh with ``sp`` or ``ep`` every rank reads the global batch and keeps
its block (``distributed.shard_batch``: its rows over the data axes, its
sequence chunk over ``sp``), attention runs ring or Ulysses
(``model.sp_strategy``) and the gradient is the global token mean. MoE
blocks (``model.n_experts``, ``top_k``, ``capacity_factor``) add
``aux_weight`` times their load-balance loss and report it as ``aux``.
Only the primary rank prints and samples. The ``tp`` and ``pp`` axes
wait for ``ROADMAP.md`` A-5c and raise ``NotImplementedError``."""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterator

import numpy as np
import torch

from torchbooster_tpu_torch import distributed as dist
from torchbooster_tpu_torch import utils
from torchbooster_tpu_torch.callbacks import SaveCallback
from torchbooster_tpu_torch.config import (
    BaseConfig,
    CommsConfig,
    DatasetConfig,
    EnvConfig,
    LoaderConfig,
    OptimizerConfig,
    SchedulerConfig,
)
from torchbooster_tpu_torch.data.tokenizer import ByteTokenizer
from torchbooster_tpu_torch.dataset import Split
from torchbooster_tpu_torch.metrics import MetricsAccumulator
from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig, generate
from torchbooster_tpu_torch.ops.losses import (
    cross_entropy,
    lm_head_cross_entropy,
)

DEFAULT_YAML = Path(__file__).resolve().parents[2] / "examples" / "lm" \
    / "gpt" / "gpt.yml"


@dataclass
class ModelConfig(BaseConfig):
    """GPT dims, YAML-driven (the JAX recipe's fields; ``top_k``,
    ``capacity_factor`` and ``aux_weight`` act on MoE blocks,
    ``sp_strategy`` on meshes with an ``sp`` axis)."""

    vocab: int = 1_024
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 8
    n_kv_heads: int = 0
    seq_len: int = 256
    remat: bool = True
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_weight: float = 1e-2
    sp_strategy: str = "auto"
    pos: str = "learned"
    mlp: str = "gelu"
    dropout: float = 0.0
    chunked_head: bool = False

    def make(self) -> GPTConfig:
        return GPTConfig(vocab=self.vocab, n_layers=self.n_layers,
                         d_model=self.d_model, n_heads=self.n_heads,
                         n_kv_heads=self.n_kv_heads, seq_len=self.seq_len,
                         n_experts=self.n_experts, top_k=self.top_k,
                         capacity_factor=self.capacity_factor,
                         sp_strategy=self.sp_strategy, pos=self.pos,
                         mlp=self.mlp, dropout=self.dropout)


@dataclass
class Config(BaseConfig):
    n_iter: int
    seed: int
    clip: float
    accumulate_every: int
    log_every: int
    save_every: int                 # 0 disables checkpointing
    checkpoint_root: str

    model: ModelConfig
    env: EnvConfig
    loader: LoaderConfig
    optim: OptimizerConfig
    scheduler: SchedulerConfig
    dataset: DatasetConfig

    sample_tokens: int = 0          # > 0: KV-cache sample after training
    sample_top_p: float = 0.0       # > 0: nucleus filter for sampling
    sample_temperature: float = 0.8
    eval_batches: int = 0           # > 0: validation-split loss after training
    comms: CommsConfig = None       # the comms: block (ZeRO ladder), or none


@dataclass
class Trainer:
    """What :func:`setup` builds and :func:`main` drives: training
    resumes at ``start_iter``, the restored checkpoint's step (0 when
    none was restored)."""

    conf: Config
    cfg: GPTConfig
    device: torch.device
    state: utils.TrainState
    step: Callable
    loss_fn: Callable
    batches: Iterator[tuple[int, Any]]
    save_cb: SaveCallback | None = None
    start_iter: int = 0
    mesh: Any = None
    comms: Any = None

    def batch(self, tokens: Any) -> dict:
        """Host tokens (B, S + 1) → ``ids``/``labels`` on the device,
        shifted on the host and copied from pinned memory. On a mesh
        with ``sp`` or ``ep`` the loader yields the global batch and each
        side keeps this rank's block (``distributed.shard_batch``)."""
        tokens = np.asarray(tokens)
        if _global_batches(self.mesh):
            # this rank's rows, and its chunk of the ids with the labels
            # one position on
            rows = dist.batch_rows(tokens.shape[0], self.mesh)
            cols = dist.seq_chunk(tokens.shape[1] - 1, self.mesh)
            tokens = tokens[rows, cols.start:cols.stop + 1]
        tokens = torch.from_numpy(np.ascontiguousarray(tokens)).long()
        if self.device.type == "cuda":
            tokens = tokens.pin_memory()
        tokens = tokens.to(self.device, non_blocking=True)
        return {"ids": tokens[:, :-1], "labels": tokens[:, 1:]}


def _global_batches(mesh: Any) -> bool:
    """True on a mesh whose ranks share rows (``ep``) or split sequences
    (``sp``): the loader then yields the global batch to every rank."""
    return mesh is not None and mesh.distributed and (
        mesh.shape.get("sp", 1) > 1 or mesh.shape.get("ep", 1) > 1)


def make_loss(conf: Config, cfg: GPTConfig, mesh: Any = None) -> Callable:
    """``loss_fn(params, batch, generator) -> (loss, {"ppl"[, "aux"]})``;
    the generator drives the model's dropout (``None`` turns it off).
    ``mesh``: the batch is this rank's block of the global one
    (``GPT.apply(mesh=...)``). MoE blocks add ``aux_weight`` times their
    load-balance loss, reported as ``aux`` (JAX ``gpt.py:127-144``)."""

    def loss_fn(params: dict, batch: dict, generator: Any):
        out, aux = GPT.apply(params, batch["ids"], cfg,
                             compute_dtype=conf.env.compute_dtype(),
                             remat=conf.model.remat, return_aux=True,
                             return_hidden=conf.model.chunked_head,
                             generator=generator, mesh=mesh)
        if conf.model.chunked_head:
            # the (T, vocab) logits never materialize
            loss = lm_head_cross_entropy(out, GPT.head_table(params),
                                         batch["labels"])
        else:
            loss = cross_entropy(out, batch["labels"])
        metrics = {"ppl": torch.exp(loss.detach())}
        if cfg.n_experts:
            metrics["aux"] = aux.detach()
            loss = loss + conf.model.aux_weight * aux
        return loss, metrics

    return loss_fn


def setup(conf: Config, device: str | torch.device = "cuda") -> Trainer:
    """Data, model, optimizer and the train step, on ``device`` (this
    rank's card under a group); with ``save_every > 0``, the newest
    checkpoint under ``checkpoint_root`` restored into the fresh state
    (``resumed from step N``)."""
    utils.seed(conf.seed)
    dev = conf.env.device(device)
    mesh = dist.get_mesh(conf.env, device=device)
    cfg = conf.model.make()
    dataset = conf.dataset.make(Split.TRAIN, seq_len=cfg.seq_len + 1,
                                vocab=cfg.vocab)
    loader = conf.loader.make(dataset, shuffle=True,
                              distributed=conf.env.distributed
                              and not _global_batches(mesh),
                              seed=conf.seed)
    loss_fn = make_loss(conf, cfg, mesh if mesh.distributed else None)
    tx = conf.optim.make(conf.scheduler.make(conf.optim))
    params = GPT.init(conf.seed, cfg, device=dev)
    comms = conf.comms.make(mesh=mesh) if conf.comms is not None else None
    if comms is not None:
        # the schedule builds the state: replicated parameters, the
        # optimizer over this rank's flat shard from stage 1 on
        state = comms.create_state(params, tx, generator=conf.seed,
                                   accumulate=conf.accumulate_every > 1)
        step = utils.make_step(loss_fn, tx, clip=conf.clip,
                               accumulate_every=conf.accumulate_every,
                               comms=comms)
    else:
        # the step's generator lies on the card with the parameters; the
        # YAML mesh lays the state out by the model's rule table
        state = utils.TrainState.create(
            params, tx, generator=conf.seed,
            accumulate=conf.accumulate_every > 1)
        state = conf.env.make(state, model=GPT, device=device)
        step = utils.make_step(loss_fn, tx, clip=conf.clip,
                               accumulate_every=conf.accumulate_every,
                               mesh=mesh, rules=GPT.SHARDING_RULES)
    save_cb = None
    if conf.save_every:
        save_cb = SaveCallback(conf.save_every, conf.n_iter,
                               root=conf.checkpoint_root,
                               sharded=comms is not None or mesh.distributed,
                               comms=comms)
        if save_cb.restore(like={"state": state}) is not None \
                and dist.is_primary():
            print(f"resumed from step {state.step}", flush=True)
    return Trainer(conf=conf, cfg=cfg, device=dev, state=state,
                   step=utils.instrument_step(step), loss_fn=loss_fn,
                   batches=utils.iter_loader(loader), save_cb=save_cb,
                   start_iter=state.step, mesh=mesh, comms=comms)


def main(conf: Config, device: str | torch.device = "cuda") -> dict:
    """:func:`setup`, then :func:`run` (on every rank under
    ``distributed.launch``)."""
    return run(setup(conf, device))


def run(t: Trainer) -> dict:
    """Train the trainer :func:`setup` built up to ``conf.n_iter`` steps
    (from a resumed checkpoint's step), then evaluate and sample as the
    config asks. Returns the last log record plus ``log`` (every record;
    ``elapsed_s`` is the wall time since the first step, read after the
    record's metrics came back from the device), and
    ``val_loss``/``val_ppl`` and ``sample`` when asked for."""
    conf = t.conf
    metrics = MetricsAccumulator()
    results: dict = {}
    log: list[dict] = []
    t0 = time.perf_counter()
    for it in range(t.start_iter, conf.n_iter):
        epoch, tokens = next(t.batches)
        t.state, step_metrics = t.step(t.state, t.batch(tokens))
        metrics.update(step_metrics)
        if t.save_cb is not None and (it + 1) % conf.save_every == 0:
            t.save_cb.save(it + 1, state=t.state)
        if (it + 1) % conf.log_every == 0:
            results = {"iter": it + 1, "epoch": epoch, **metrics.compute()}
            results["elapsed_s"] = time.perf_counter() - t0
            metrics.reset()
            log.append(results)
            if dist.is_primary():
                print({k: round(v, 4) if isinstance(v, float) else v
                       for k, v in results.items()}, flush=True)
    if t.save_cb is not None:
        t.save_cb.wait()
    results = {**results, "log": log}
    params = t.comms.gather_params(t.state) if t.comms is not None \
        else t.state.params
    loss_params = params
    if t.comms is None and t.mesh is not None and t.mesh.distributed:
        # the loss keeps this rank's experts; sampling takes them all
        loss_params = _full_params(params, t.mesh, local=True)
        params = _full_params(params, t.mesh)
    if conf.eval_batches > 0:
        eval_step = utils.make_eval_step(t.loss_fn)
        eval_loader = conf.loader.make(
            conf.dataset.make(Split.VALIDATION, seq_len=t.cfg.seq_len + 1,
                              vocab=t.cfg.vocab),
            shuffle=False, distributed=conf.env.distributed
            and not _global_batches(t.mesh), seed=conf.seed)
        eval_metrics = MetricsAccumulator()
        for i, tokens in enumerate(eval_loader):
            if i >= conf.eval_batches:
                break
            # no generator: the eval forward stays deterministic
            eval_metrics.update(eval_step(loss_params, t.batch(tokens),
                                          None))
        evals = eval_metrics.compute()
        if evals and t.mesh is not None and t.mesh.distributed:
            # each rank evaluated its shard: the mean over the ranks
            evals = {k: float(np.mean(v))
                     for k, v in dist.gather(evals).items()}
        if evals:
            results["val_loss"], results["val_ppl"] = evals["loss"], \
                evals["ppl"]
            if dist.is_primary():
                print({"val_loss": round(evals["loss"], 4),
                       "val_ppl": round(evals["ppl"], 4)}, flush=True)
        elif dist.is_primary():
            print("eval skipped: the validation split yielded no full "
                  "batches (drop_last)", flush=True)
    if conf.sample_tokens > 0 and dist.is_primary():
        # prompt with the first tokens of a training example
        _, tokens = next(t.batches)
        prompt = torch.as_tensor(np.asarray(tokens)[:1, :8]).long().to(
            t.device)
        sampled = generate(
            params, prompt, t.cfg, n_new=conf.sample_tokens,
            generator=torch.Generator(t.device).manual_seed(conf.seed),
            temperature=conf.sample_temperature, top_k=50,
            top_p=conf.sample_top_p or None)
        results["sample"] = sampled[0].tolist()
        print("sample:", results["sample"], flush=True)
        if t.cfg.vocab == 256:
            # a byte-level corpus (text_file): the ids are UTF-8 bytes
            print("sample text:", repr(
                ByteTokenizer().decode(results["sample"])), flush=True)
    return results


def _full_params(params: dict, mesh: Any, local: bool = False) -> dict:
    """The full parameter tree of a rule-sharded state (each sharded leaf
    all-gathered), for sampling; with ``local`` the tree the loss takes
    (``ep``-sharded experts stay this rank's, ``parallel.sharding.
    loss_spec``), for evaluation."""
    from torchbooster_tpu_torch.parallel.sharding import (
        gather_leaf,
        loss_spec,
    )

    def full(p: torch.Tensor) -> torch.Tensor:
        spec = getattr(p, "spec", ())
        return gather_leaf(p, loss_spec(spec) if local else spec, mesh)

    with torch.no_grad():
        return utils._tree_map(full, params)


def launch_main(conf: Config, device: str = "cuda") -> Any:
    """:func:`main` under ``distributed.launch`` with the YAML's ``env``
    (the JAX recipe's ``__main__``): NCCL on the card, gloo with
    ``device="cpu"``."""
    return dist.launch(main, conf.env.devices(), conf.env.n_machine,
                       conf.env.machine_rank, conf.env.dist_url,
                       args=(conf, device), distributed=conf.env.distributed,
                       device=device)


if __name__ == "__main__":
    launch_main(Config.load(sys.argv[1] if len(sys.argv) > 1
                            else DEFAULT_YAML))
