"""Peak device memory of the port's train step at gpt-long's widths on
one card, for the ``torchbooster_tpu_torch`` package of a given tree.

``examples/lm/gpt/gpt-long.yml``'s model and optimizer (12 layers,
d_model 768, 16 heads over 8 kv heads, seq 8192, rope, dropout 0.1,
remat, chunked head, bf16 over fp32 masters, AdamW with decay on
matrices only, clip 1.0) at batch 8, random byte tokens from a seed.
For each route the tree's ``make_step`` offers (``eager`` inside
``_graphs.eager_steps()``; ``graph``, the captured step, where the step
has one), one fresh state takes a first step (the optimizer's lazy
state, and the capture on the graph route), then ``--steps`` more, each
read back. Printed, one JSON line a route: the memory allocated before
the measured steps, their peak above it, the peak, the reserved memory,
and the median step ms, beside the card's ``nvidia-smi`` name and power
limit.

    python scripts/torch_train_memory.py --tree PATH [--label NAME]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True,
                    help="the checkout whose torchbooster_tpu_torch runs")
    ap.add_argument("--label", default=None)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_memory: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, args.tree)
    from torchbooster_tpu_torch import _graphs, utils
    from torchbooster_tpu_torch.config import (
        DatasetConfig,
        EnvConfig,
        LoaderConfig,
        OptimizerConfig,
        SchedulerConfig,
    )
    from torchbooster_tpu_torch.models.gpt import GPT
    from torchbooster_tpu_torch.recipes import gpt as recipe

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    conf = recipe.Config(
        n_iter=16, seed=42, clip=1.0, accumulate_every=1, log_every=1,
        save_every=0, checkpoint_root="",
        model=recipe.ModelConfig(vocab=256, n_layers=12, d_model=768,
                                 n_heads=16, n_kv_heads=8, seq_len=8192,
                                 pos="rope", dropout=0.1, remat=True,
                                 sp_strategy="auto", chunked_head=True),
        env=EnvConfig(distributed=False, precision="bf16", mesh="dp"),
        loader=LoaderConfig(batch_size=8),
        dataset=DatasetConfig(name="text_file"),
        optim=OptimizerConfig(name="adamw", lr=3e-4, weight_decay=0.1,
                              decay_matrices_only=True),
        scheduler=SchedulerConfig(name="cycle", n_iter=16, warmup=2,
                                  decay=("cos", "cos")))
    cfg = conf.model.make()
    loss_fn = recipe.make_loss(conf, cfg)
    tx = conf.optim.make(conf.scheduler.make(conf.optim))
    rs = np.random.RandomState(0)
    batches = []
    for _ in range(args.steps + 1):
        t = torch.as_tensor(rs.randint(0, 256, (8, cfg.seq_len + 1)),
                            device="cuda")
        batches.append({"ids": t[:, :-1], "labels": t[:, 1:]})
    routes = ["eager"]
    if hasattr(utils.make_step(loss_fn, tx, clip=conf.clip), "graphs"):
        routes.append("graph")
    for route in routes:
        state = utils.TrainState.create(GPT.init(conf.seed, cfg,
                                                 device="cuda"), tx,
                                        generator=conf.seed)
        step = utils.make_step(loss_fn, tx, clip=conf.clip)
        mode = _graphs.eager_steps if route == "eager" \
            else contextlib.nullcontext
        with mode():
            state, m = step(state, batches[0])
            m["loss"].item()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for batch in batches[1:]:
                t0 = time.perf_counter()
                state, m = step(state, batch)
                m["loss"].item()
                ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        print(json.dumps({
            "tree": args.label or args.tree, "route": route,
            "allocated_before_bytes": base, "peak_above_bytes": peak - base,
            "peak_bytes": peak, "reserved_bytes": torch.cuda.memory_reserved(),
            "step_ms_median": float(np.median(ms)), "loss": m["loss"].item(),
            "card": smi}), flush=True)
        del state, step, m
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
