"""On-card smoke test of the PyTorch/CUDA port (``torchbooster_tpu_torch``).

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases device,build,flash

Phases, in order; any failure exits non-zero and prints no result:

1. device  — require a CUDA card; print ``nvidia-smi`` name and power limit.
2. build   — compile the port's eleven CUDA sources (nvcc, sm_90a), one
   nvcc per source, all started together, and time it; print the
   registers and spills ``-Xptxas -v`` reports for the B4, B1 and B2/B3
   ``"sm90"`` kernels, the one-pass conv + GroupNorm kernel's B7 and B8
   instances and B5's and B6's one-pass kernels.
3. kernel  — hold the paged flash-decode kernel (B4) against its plain
   PyTorch version at GPT-2-small width (H=12, Dh=64, 64-token pages, 129
   pages, 8 slots): MHA and GQA (4 kv heads), bf16/fp32/int8 pools, S=1
   decode, S=5 linear verify, a tree-verify mask, and a prefix page shared
   by two lanes; each case on the route ``plan_paged`` plans (every bf16-q
   case on ``"sm90"``), those also forced to ``"simt"``, and two
   ``"sm90"`` calls bit for bit; then time both routes (profiler device
   time, and CUDA events per call) beside the plain version, the bound and
   ``scaled_dot_product_attention`` over the same context, each timed call
   reading another of 12 layer pools as the decode step does, at bf16 MHA
   decode and at the prefix cache's layout (8 lanes, every slot behind one
   4-page shared prefix).
4. flash   — hold the flash kernels B1 (forward: o, lse), B2 (dq) and B3
   (dk, dv) against their plain versions: GPT-2-small training geometry
   (B 8, H 12, S 1024, D 64) causal at bf16 and fp32, GQA with 4 kv heads,
   S_q 256 < S_kv 1024, ragged S 1000, D 32 (the recipe default's heads),
   D 128 at S 1024, non-causal bf16 and fp32 cases, and gpt-long's head
   dim 48 (16 heads over 8: GQA at S 2048 bf16 and S 1024 fp32, and S_q
   256 < S_kv 1024); B1 on the route ``plan_flash_fwd`` plans and B2 and
   B3 on the route ``plan_flash_bwd`` plans (every bf16 case but D 32 and
   D 48 on ``"sm90"``, those on ``"mma_sync"``), two bf16 calls of each
   bit for bit; then time each kernel at the training geometry (profiler
   device time, or CUDA events around back-to-back calls where the
   profiler loses events) beside its plain version, its bound and SDPA
   (forward, and its backward), B1, B2 and B3 on ``"sm90"`` and on
   ``"mma_sync"`` on the same inputs; the same at gpt-long's geometry (B
   8, H 16 over 8, S 8192, D 48, on ``"mma_sync"``, SDPA over K/V
   expanded to 16 heads); and sweep S for the ``"auto"`` crossover
   against ``mha_reference``.
5. serve_fp32 — GPT-2 small, random seeded weights with a decisive head
   (tied embeddings x4), ``ServingConfig(page_size=64, n_pages=129,
   max_slots=8).make(...).run(...)`` on 8 requests (prompts 64-512
   tokens, 32 new tokens each); every request must equal the port's
   dense ``generate``, and the kernel must have launched on this path,
   every launch on ``"simt"`` (``"sm90"`` at bf16).
6. serve_bf16 — the same at bf16; prints decode tok/s, p50 TTFT and peak
   device memory beside the card's name and power limit, then replays the
   trace under the profiler for the device busy share and the top kernels.
6a. serve_spec_bf16 / serve_spec_fp32 — the same model and pool with
   ``speculative: true, draft_len: 4`` (S = 5 verify rows a slot) built
   through ``ServingConfig.make``: 8 requests with repetitive prompts of
   64-512 tokens (tiled patterns), 64 new tokens each. Every request
   equals the dense ``generate``; some draft is accepted; one verify shape
   and no decode step; B4 launches exactly 12 a verify step, all on
   ``"sm90"`` at bf16 and ``"simt"`` at fp32. Prints the accept rate,
   tokens per verify step, decode tok/s and p50 TTFT beside the plain
   decode engine's on the same prompts.
6b. serve_tree — the same at bf16 with ``spec_tree: true,
   spec_tree_width: 2`` on ambiguous repetitive prompts (the final n-gram
   seen twice with two continuations, the older one the model's own
   pick): 8/8 token-exact, at least one side-branch acceptance counted by
   the engine, one verify shape, every launch on ``"sm90"``.
6c. serve_fork — ``parallel_sampling: true`` at bf16: two requests (256
   and 100 prompt tokens), n = best_of = 4, 32 new tokens. Greedy: every
   branch equals the dense ``generate``, prompt pages shared (read
   through 4 lanes) and tail pages copied, every B4 launch on ``"sm90"``;
   seeded (temperature 0.8, top-k 50): each branch equals the engine's
   own run admitted alone with ``(seed, branch)``.
6d. serve_structured — ``structured: {enabled: true}`` at bf16: the five
   ``SCHEMA_LIBRARY`` schemas (prompts of 64-256 tokens, ``max_new_tokens``
   the schema's budget, EOS 50256) and three unconstrained riders (64-512
   tokens, 32 new). Every constrained completion conforms and stops on
   EOS, every rider equals the dense ``generate``, one decode shape,
   every B4 launch on ``"sm90"``. Then ``speculative: true, draft_len: 4``
   on the same trace: the constrained streams equal the plain structured
   run's, one verify shape, 12 B4 launches a verify step. Then one
   constrained request with n = best_of = 4 (temperature 0.8, top-k 50)
   on a parallel-sampling engine: every branch conforms. Prints each
   schema's token-DFA compile ms at vocab 50257, the masked share of the
   vocabulary, decode tok/s with structured on and off (the same prompts
   and budgets unconstrained, in turns), and B4's device µs a call at
   S = 1 and S = 5 from profiled replays of the trace.
6e. serve_wq — ``weights: {dtype: int8}`` and ``{dtype: int4,
   group_size: 64}`` beside the full-precision engine, at fp32 and bf16,
   on the serving trace of phase 5, and int8 weights with ``cache_dtype:
   int8`` at bf16: every arm equals the dense ``generate`` over its own
   (quantized) tree, with ``cache_dtype="int8"`` for the int8 pool; int8
   equals the full-precision engine 8/8 at fp32; one decode shape an
   arm; B4 on ``"simt"`` at fp32 and ``"sm90"`` at bf16, the int8 pool
   included. Prints each arm's matches against the full-precision stream,
   ``weight_stream_bytes`` for bf16, int8 and int4, decode tok/s and peak
   memory.
6f. serve_lora — ``adapters: {rank: 8, max_live: 4}`` with six adapters
   (``random_adapter(1..6, cfg, 8, std=0.25)``) on the trace of phase 5,
   two requests base and six through an adapter each, at fp32 and bf16:
   seating waits on lanes and evicts; base riders equal the LoRA-off
   engine's streams, every adapter changes its stream, and at fp32 each
   adapter request equals the dense ``generate`` over its merged weights
   (``W_qkv + A_q B_q``, ``W_proj + A_p B_p``); one decode shape, one
   lane-writer shape, no pin left, tables consistent, B4 on its planned
   route. Prints the per-adapter metrics and decode tok/s with LoRA on
   and off (the same prompts, all base).
6g. serve_spill — ``prefix_cache: true, host_spill: {enabled: true,
   budget_mb: 256}`` over a 33-page pool, bf16 over an int8 pool (B4
   ``"sm90"``) and fp32 over a wide pool (``"simt"``): five probes (an
   8-page prefix + 16 tokens, 32 new), each driven through the engine
   cold, as an HBM prefix hit and — after rounds of distinct 2-4-page
   prompts have demoted its 8 pages — as a host hit whose pages promote
   through 4-lane staging in two groups. Every stream equals the dense
   ``generate`` at the pool's cache dtype; one decode and one promotion
   shape; promoted bytes equal ``promotion_traffic``; tables consistent.
   Prints TTFT cold / HBM / host (seat to first token), promotion GB/s
   (bytes over the synchronized ``issue_promotions``), spills, host hits,
   peak memory and ``spill_breakeven`` at the measured rate.
6h. serve_disagg — ``cache_dtype: int8``, the spill tier and ``disagg:
   {enabled: true, min_prefill_pages: 4}`` at bf16: a ``DisaggPair``
   (prefill engine and its worker thread on the same card) pumped over 8
   requests at 0 (prompts 640, 800 and 960 through the prefill engine,
   64-192 straight to decode, 32 new), beside the unified batcher on the
   same trace. Streams equal the unified run's; streamed payload bytes
   equal ``disagg_traffic``, pages ``(len - 1) // 64`` each, none
   stranded; the decode engine one decode, prefill and promotion shape,
   the prefill engine no decode; every B4 launch ``"sm90"`` over the int8
   pool. Prints p50 TTFT of the short and the long requests, decode
   tok/s, framed bytes and memory, on and off.
7. train   — the GPT recipe's ``main`` (``recipes/gpt.py``) on a config
   built in code from ``examples/lm/gpt/gpt.yml``'s values with the model
   at GPT-2-small width: batch 8 x 1024, 20 steps, bf16 over fp32 masters,
   remat, AdamW + cycle schedule (2-step warmup), clip 1.0, then a
   32-token sample. Every loss finite and the last below the first; the
   flash launch counts exact (B1 2 x 12 per step with remat, plus 12 for
   the sample's prefill; B2 and B3 12 per step; all three on ``"sm90"``);
   one fp32 forward +
   backward with the flash kernels against ``mha_reference`` (loss and
   gradient norm, rtol 1e-4). Prints step ms, tokens/s, the model-FLOP
   share of 989 TFLOP/s, peak memory, and a profiled device busy share
   with the top kernels. Remat here and in every phase below follows
   the JAX policy: the blocks' dense products are saved, everything
   else (B1 among it) is recomputed in backward.
7a. gpt2_import — a GPT-2 small checkpoint laid out as HF's
   ``GPT2LMHeadModel.state_dict()`` (``transformer.`` keys, Conv1D
   ``(in, out)`` weights, ``lm_head.weight`` tied; numpy from a seed,
   wte x4) imported by ``load_torch_gpt2`` onto the card: the config is
   GPT-2 small's and every tensor equals its source bit for bit. Then
   8 steps of ``utils.make_step`` from the imported params with each of
   lamb, lion and adafactor (``gpt2_train_config``'s batch 8 x 1024,
   bf16, remat, chunked head, clip 1.0, ``synthetic_lm``; the lr of
   ``GPT2_LR``): finite losses, the last below the first; B1 24, B2 12
   and B3 12 launches a step, all ``"sm90"``; one more update on the
   card against the same optimizer on the CPU from the same params,
   gradients and state; adafactor's state under 1% of the fp32 params.
   Prints step ms, tokens/s, peak memory and optimizer-state bytes. The
   adafactor-tuned model is then served as phases 5 and 6 serve: 8/8
   token-exact against the dense ``generate`` at bf16 (B4 ``"sm90"``)
   and at fp32 (``"simt"``).
7b. train_long — the GPT recipe's ``setup`` and ``main`` at
   ``examples/lm/gpt/gpt-long.yml``'s widths, built in code with the
   overrides ``LONG_OVERRIDES`` lists (one card, mesh ``dp``; 12 steps, a
   2-step warmup, a checkpoint every 4 steps into a temp dir, one
   validation batch): batch 8 x 8192 byte tokens of the repo's own
   ``*.py`` and ``*.md`` text (``text_file``), 12 layers, d_model 768, 16
   heads over 8 kv heads (D 48), rope, dropout 0.1, remat, chunked head,
   AdamW with decay on matrices only, a cos/cos cycle, then a 128-token
   top-p 0.95 sample. Checks: B1 24, B2 12 and B3 12 launches a step (and
   12 B1 each for the eval batch and the sample's prefill), all on
   ``"mma_sync"``, and no ``mha_reference`` call; finite losses whose last
   3 average below the first; ``ckpt_04``, ``ckpt_08``, ``ckpt_12``; a
   fresh ``setup`` resumes at step 12 with params, AdamW moments, step and
   generator bit for bit, and one more step from both trainers agrees bit
   for bit; one generator state gives one loss, and the eval loss (no
   generator) is the dropout-0 loss bit for bit; 136 byte tokens printed
   as text. Prints the median step ms of steps 3-12, tokens/s, the
   model-FLOP share of 989 TFLOP/s (dense and causal attention FLOPs
   stated), peak memory, the checkpoint's bytes with the save's blocking
   and background-write ms, the validation loss, and a profiled busy
   share with B1-B3's share of device time.
8. conv    — hold the GroupNorm kernels B5 (forward) and B6 (backward) and
   the fused conv + GroupNorm kernels B7 (1x1, any stride) and B8 (3x3,
   stride 1) against their plain versions, in bf16 and fp32, with and
   without ReLU: every ResNet-18 CIFAR geometry at batch 512 (the stem,
   each stage, the stride-2 projections), ResNet-50 224² bottleneck
   geometries (56²x64->256 1x1, 56²x64 3x3, a 7²x2048 GroupNorm), a
   non-square 7x9 map, and widths off the 16-byte vectors (12 channels
   in, 40 out), B8's one-pass routes at small batch (a cluster at B 3,
   a partial pack at B 5) and B5's packed route at B 3 (the last CTA
   holding one sample); B5-B8 each on the route its plan
   (``plan_gn_fwd``, ``plan_gn_bwd``, ``plan_conv1x1``, ``plan_conv3x3``)
   names, asserted by the per-route counters, every B5 and B6
   ``"one_pass"`` and B7 ``"cluster"``/``"pack"`` case also forced onto the
   older route (``"two_pass"``, ``"mma_sync"``) within the same tolerance,
   and two bf16 calls on the same inputs agreeing bit for bit (B8, B7 on
   both one-pass routes, B6 at a cluster of 4 and of 1, B5 at a cluster of
   2, of 1 and two samples a CTA); then time each kernel
   at every ResNet-18 shape of the training path (profiler device time;
   the port's launches also by replays of a CUDA graph of 20 calls, which
   stands in for a column whose profiler window loses events, the plain
   version and the library call falling back on their own to CUDA events
   around back-to-back calls, and the line says which; and CUDA events
   per call) beside its bound, its plain version, the older
   route's kernel on the same inputs (B5-B8) and a library yardstick
   (``F.group_norm`` on the channels-last view and its backward; for
   B7/B8 the sequence cuDNN conv + ``F.group_norm`` + ReLU), with the
   route, B5's, B6's and B7's CTAs per SM, and B8's TFLOP/s over the
   product counted once; B5's and B6's one-pass kernels are also timed at
   the other plans their rules passed over.
9. resnet_train — the ResNet recipe's ``main`` (``recipes/resnet.py``) on a
   config built in code from ``examples/img_cls/resnet/resnet.yml``'s
   values (ResNet-18, CIFAR stem, batch 512, bf16 over fp32 masters,
   AdamW, cycle schedule, clip 1.0, label smoothing 0.1, host
   augmentation) for 2 epochs of the ``cifar10`` twin (32 steps, and an
   eval pass of 2 batches after each epoch). Every loss finite and the
   last below the first; the launch counts of B5-B8 exact (per train step
   B5 4, B6 4, B7 3, B8 13; per eval forward B5 4, B7 3, B8 13), and by
   route: B5 and B6 all ``"one_pass"``, B7 1 ``"cluster"`` and 2 ``"pack"`` per
   forward, B8 7 ``"cluster"`` and 6 ``"pack"``; one fp32
   forward + backward with the kernels against ``fused=False`` and the
   plain GroupNorm (loss and gradient norm, rtol 1e-4). Prints step ms,
   img/s, the model-FLOP share of 989 TFLOP/s, peak memory, the host data
   time per step and a profiled device busy share with the top kernels.

The last stdout line is ``{"ok": true, "device": {...}}``; the line
before it lists each kernel's route, error, times and launches. Longer
output (ptxas report, per-case errors) goes to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

PHASES = ("device", "build", "kernel", "flash", "serve_fp32", "serve_bf16",
          "serve_spec_bf16", "serve_spec_fp32", "serve_tree", "serve_fork",
          "serve_structured", "serve_wq", "serve_lora", "serve_spill",
          "serve_disagg", "train",
          "gpt2_import", "train_long", "conv", "resnet_train")
SERVE_PHASES = ("serve_fp32", "serve_bf16", "serve_spec_bf16",
                "serve_spec_fp32", "serve_tree", "serve_fork",
                "serve_structured", "serve_wq", "serve_lora",
                "serve_spill", "serve_disagg")
SOURCES = ("paged_attention", "paged_decode_sm90", "flash_attention",
           "flash_fwd_sm90", "flash_bwd_sm90", "group_norm",
           "group_norm_fwd_sm90", "group_norm_bwd_sm90", "fused_block",
           "conv1x1_gn_sm90", "conv3x3_gn_sm90")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM published HBM3 rate
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core rate
FP32_FLOPS = 67e12               # H100 SXM fp32 rate outside tensor cores
DEV = "cuda"
# what a number timed by device_ms is; ``sum_ms`` beside it is the sum of
# the kernels' own times, the measure of the smoke's earlier revisions
DEVICE_TIME = "profiler device time, union of kernel intervals"
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"

# GPT-2-small serving geometry of phases 3-5
H, DH, PS, N_PAGES, SLOTS, N_LAYERS = 12, 64, 64, 129, 8, 12
PROMPT_LENS = (64, 100, 150, 200, 256, 300, 400, 512)
N_NEW = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_kernels(text: str, pattern: str) -> dict:
    """Registers and spill bytes per kernel from ``nvcc -Xptxas -v``
    output, for the mangled entry names that ``pattern`` (a regex with the
    kernel's name and then its template arguments as groups) matches."""
    import re

    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\S+?)'?(?: for|$)", line)
        if m:
            k = re.search(pattern, m.group(1))
            got = [g for g in k.groups() if g is not None] if k else []
            name = (got[0] + (f"<{','.join(got[1:])}>" if got[1:] else "")
                    if got else None)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def kernel_name(signature: str) -> str:
    """``paged_merge_sm90`` from the profiler's ``void (anonymous
    namespace)::paged_merge_sm90<64>(...)``."""
    import re

    m = re.search(r"(\w+)[<(]", signature)
    return m.group(1) if m else signature


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Median milliseconds per call over ``iters`` timed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def stream_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Milliseconds per call from CUDA events around ``iters`` calls
    issued back to back: where the host enqueues faster than the card
    runs them, this is the card's own time per call, without the host
    gap that :func:`cuda_ms` counts before each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Milliseconds per call from CUDA events around ``replays`` replays of
    one CUDA graph that holds ``calls`` calls of ``fn`` (captured after
    three warm calls on a side stream): the card's own time, without the
    host's cost per call that :func:`stream_ms` counts when the host is
    slower than the card, but with the short gaps between the graph's
    kernels that :func:`device_ms` leaves out. For the port's own launch
    functions, which stream capture takes as they are."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    del graph
    torch.cuda.empty_cache()
    return a.elapsed_time(b) / (calls * replays)


GRAPH_TIME = "CUDA graph of 20 calls, replayed between CUDA events"


def device_ms(fn, iters: int = 50, by_kernel: dict | None = None) -> float:
    """Milliseconds of device time per call, from the profiler: the union
    of the device intervals (kernels and copies) over ``iters`` calls, so
    a kernel launched early under its predecessor by programmatic
    dependent launch (B4's merge) counts once. ``by_kernel``, when given,
    gets each kernel's own device milliseconds per call; their sum is the
    measure of the smoke's earlier revisions, and equals the union where
    no two kernels overlap. The host-side launch cost, which
    :func:`cuda_ms` includes, is left out. Every call launches at least
    one kernel, so a window that recorded fewer device intervals than
    calls lost events (seen once on the card: a 100 µs kernel read as 3.6
    µs, and later whole windows of one-kernel calls, two in a row in a
    full run); it is profiled again, and 0.0 is returned when four windows
    in a row lose events."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = device_spans(prof)
        if len(spans) < iters:
            continue
        if by_kernel is not None:
            for start, stop, name in spans:
                by_kernel[name] = by_kernel.get(name, 0.0) \
                    + (stop - start) / iters / 1e3
        return union_us(spans) / iters / 1e3
    return 0.0


def device_spans(prof) -> list:
    """``(start µs, end µs, name)`` of every device activity the profiler
    recorded, in start order."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.time_range.end > e.time_range.start)


def union_us(spans) -> float:
    """Microseconds covered by at least one of the sorted ``spans``."""
    busy, end = 0.0, -math.inf
    for start, stop, _ in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy


# ---------------------------------------------------------------- kernel
def make_case(rs, *, kv_heads, pool, q_dtype, s_q, tree, shared, lens=None,
              prefix_pages: int = 0):
    """A pool, a compacted work list and queries at serving geometry.
    ``shared``: slots 0 and 1 share their first two (full) pages, listed
    once in the work list with both slots on its lanes. ``prefix_pages``:
    every slot shares its first that many pages (the prefix cache's
    layout, one lane per slot)."""
    from torchbooster_tpu_torch.models.gpt import _quantize_kv

    dev = DEV
    lens = np.asarray(lens if lens is not None
                      else rs.randint(64, 600, SLOTS), np.int64)
    if shared:
        lens[:2] = np.maximum(lens[:2], 2 * PS + 1)
    n_lanes = SLOTS if shared or prefix_pages else 1
    free = list(rs.permutation(np.arange(1, N_PAGES)))
    table = {}
    for s in range(SLOTS):
        need = -(-int(lens[s] + s_q) // PS)
        table[s] = [int(free.pop()) for _ in range(need)]
    if shared:
        table[1][:2] = table[0][:2]
    for s in range(1, SLOTS if prefix_pages else 1):
        table[s][:prefix_pages] = table[0][:prefix_pages]
    holders: dict[int, list[tuple[int, int]]] = {}
    for s in range(SLOTS):
        for idx, p in enumerate(table[s]):
            holders.setdefault(p, []).append((s, idx))
    live = sorted(holders)
    n_w = N_PAGES - 1
    wp = np.zeros(n_w, np.int32)
    wr = np.full((n_w, n_lanes), -1, np.int32)
    wpos = np.zeros(n_w, np.int32)
    for i, p in enumerate(live):
        wp[i] = p
        wpos[i] = holders[p][0][1]
        for lane, (s, _) in enumerate(holders[p]):
            wr[i, lane] = s
    shape = (N_PAGES, PS, kv_heads, DH)
    k = torch.randn(shape, device=dev)
    v = torch.randn(shape, device=dev)
    if pool == "int8":
        pk, pv = _quantize_kv(k), _quantize_kv(v)
    else:
        dt = torch.bfloat16 if pool == "bf16" else torch.float32
        pk, pv = k.to(dt), v.to(dt)
    q = torch.randn(SLOTS, s_q, H, DH, device=dev).to(q_dtype)
    tvis = None
    if tree:
        # a random candidate tree per slot: node j hangs off a parent < j
        tvis = np.zeros((SLOTS, s_q, s_q), np.int32)
        for s in range(SLOTS):
            parent = [0] + [int(rs.randint(0, j)) for j in range(1, s_q)]
            for j in range(s_q):
                node = j
                while True:
                    tvis[s, j, node] = 1
                    if node == 0:
                        break
                    node = parent[node]
        tvis = torch.as_tensor(tvis, device=dev)
    as_dev = lambda a: torch.as_tensor(a, device=dev)
    return dict(q=q, pool_k=pk, pool_v=pv, work_pages=as_dev(wp),
                work_refs=as_dev(wr), work_pos=as_dev(wpos),
                lengths=as_dev(lens.astype(np.int32)), tree_vis=tvis,
                n_live=len(live), lens=lens)


def kernel_inputs(case):
    return ((case["q"], case["pool_k"], case["pool_v"], case["work_pages"],
             case["work_refs"], case["work_pos"], case["lengths"]),
            dict(page_size=PS, tree_vis=case["tree_vis"]))


def kv_dtype_of(pool: str) -> torch.dtype:
    return {"bf16": torch.bfloat16, "fp32": torch.float32,
            "int8": torch.int8}[pool]


def time_paged(rs, lens, prefix_pages: int = 0, plain: bool = True) -> dict:
    """B4 at bf16 MHA decode over the serving geometry, every number from
    this one call: the planned ``"sm90"`` route, ``"simt"`` forced on the
    same inputs, the plain version (``plain``), SDPA over the same context
    gathered dense (a yardstick the port never calls) and the bound. Each
    timed call reads another of N_LAYERS layer pools (over 300 MB, past
    the 50 MB L2), as the decode step does."""
    from torchbooster_tpu_torch.ops import paged_attention as pa

    case = make_case(rs, kv_heads=12, pool="bf16", q_dtype=torch.bfloat16,
                     s_q=1, tree=False, shared=False, lens=lens,
                     prefix_pages=prefix_pages)
    args, kw = kernel_inputs(case)
    q, pk, pv, rest = args[0], args[1], args[2], args[3:]
    route = pa.plan_paged(q.dtype, pk.dtype, DH, PS, 1, 1)
    if route != "sm90":
        raise AssertionError(f"bf16 MHA decode planned {route!r}, not sm90")
    layers = [(pk.clone(), pv.clone()) for _ in range(N_LAYERS)]
    turn = itertools.count()

    def runner(fn, **extra):
        def run():
            lk, lv = layers[next(turn) % N_LAYERS]
            return fn(q, lk, lv, *rest, **kw, **extra)
        return run

    # SDPA over the same context gathered dense per slot (a shared page is
    # copied into every slot that holds it), padded to the longest slot and
    # masked; the gather is outside the timing
    wp = case["work_pages"].long()
    wr = case["work_refs"].cpu().numpy()
    wpos = case["work_pos"].cpu().numpy()
    max_len = int(lens.max()) + 1
    dense = []
    for lk, lv in layers:
        kd = torch.zeros(SLOTS, H, max_len, DH, device="cuda",
                         dtype=torch.bfloat16)
        vd = torch.zeros_like(kd)
        for i in range(case["n_live"]):
            base = int(wpos[i]) * PS
            n = min(PS, max_len - base)
            for s in (int(x) for x in wr[i] if x >= 0):
                if n > 0:
                    kd[s, :, base:base + n] = lk[wp[i], :n].transpose(0, 1)
                    vd[s, :, base:base + n] = lv[wp[i], :n].transpose(0, 1)
        dense.append((kd, vd))
    mask = (torch.arange(max_len, device="cuda")[None, :]
            <= torch.as_tensor(lens, device="cuda")[:, None])
    qd = q.transpose(1, 2)                               # (slots, H, 1, Dh)
    attn_mask = mask[:, None, None, :]

    def run_library():
        kd, vd = dense[next(turn) % N_LAYERS]
        return torch.nn.functional.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=attn_mask)

    runs = {"sm90": runner(pa.paged_attention),
            "simt": runner(pa.paged_attention, route="simt"),
            "library": run_library}
    if plain:
        runs["plain"] = runner(pa.paged_attention_reference)
    # device time (profiler) is the kernels' own time (both passes); call
    # time (CUDA events around each call) adds the host launch path
    iters = {"plain": 50}
    call = {k: cuda_ms(f, iters=iters.get(k, 200)) for k, f in runs.items()}
    per_kernel = {k: {} for k in runs}
    dev = {k: device_ms(f, iters=iters.get(k, 200), by_kernel=per_kernel[k])
           for k, f in runs.items()}
    src = dev if all(dev.values()) else call
    # the bound counts what these inputs need: each live page's tokens that
    # some holder sees, read once (a shared page once for all its lanes),
    # q read and the output written once, plus the work list and lengths
    page_tokens = 0
    for i in range(case["n_live"]):
        base = int(wpos[i]) * PS
        page_tokens += max(min(PS, max(0, int(lens[s]) + 1 - base))
                           for s in wr[i] if s >= 0)
    kv_bytes = 2 * page_tokens * H * DH * 2                # K and V, bf16
    io_bytes = (2 * SLOTS * H * DH * 2 + wp.numel() * 4 * 2 + wr.size * 4
                + SLOTS * 4)
    flops = 4 * H * DH * int((lens + 1).sum())
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    sums = {k: sum(per_kernel[k].values()) if src is dev else None
            for k in ("sm90", "simt")}
    return {"ms": src["sm90"], "previous_ms": src["simt"],
            "sum_ms": sums["sm90"], "previous_sum_ms": sums["simt"],
            "plain_ms": src.get("plain"), "library_ms": src["library"],
            "timed_route": route,
            "timed_by": DEVICE_TIME if src is dev
            else "CUDA events per call", "call_ms": call, "device_ms": dev,
            "kernel_ms": {k: per_kernel[k] for k in ("sm90", "simt")},
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "live_pages": case["n_live"], "lanes": int(wr.shape[1]),
            "page_tokens": page_tokens, "bytes": kv_bytes + io_bytes,
            "flops": flops}


def phase_kernel(report: dict) -> dict:
    from torchbooster_tpu_torch.ops import paged_attention as pa

    rs = np.random.RandomState(0)
    cases = [
        ("mha_bf16_decode", dict(kv_heads=12, pool="bf16", q_dtype=torch.bfloat16, s_q=1, tree=False, shared=False)),
        ("gqa_bf16_decode", dict(kv_heads=4, pool="bf16", q_dtype=torch.bfloat16, s_q=1, tree=False, shared=False)),
        ("mha_fp32_decode", dict(kv_heads=12, pool="fp32", q_dtype=torch.float32, s_q=1, tree=False, shared=False)),
        ("mha_int8_decode", dict(kv_heads=12, pool="int8", q_dtype=torch.bfloat16, s_q=1, tree=False, shared=False)),
        ("gqa_int8_fp32q_decode", dict(kv_heads=4, pool="int8", q_dtype=torch.float32, s_q=1, tree=False, shared=False)),
        ("gqa_bf16_verify5", dict(kv_heads=4, pool="bf16", q_dtype=torch.bfloat16, s_q=5, tree=False, shared=False)),
        ("mha_int8_tree5", dict(kv_heads=12, pool="int8", q_dtype=torch.bfloat16, s_q=5, tree=True, shared=False)),
        ("gqa_bf16_shared_prefix", dict(kv_heads=4, pool="bf16", q_dtype=torch.bfloat16, s_q=1, tree=False, shared=True)),
        ("mha_fp32_shared_tree5", dict(kv_heads=12, pool="fp32", q_dtype=torch.float32, s_q=5, tree=True, shared=True)),
        # 8 lanes x rep 3 x S 5 = 120 query rows on each shared-prefix item:
        # more than a ring slot's 64, so "sm90" stages them in two rounds
        ("gqa_bf16_verify5_prefix", dict(kv_heads=4, pool="bf16", q_dtype=torch.bfloat16, s_q=5, tree=False, shared=False, prefix_pages=2)),
        ("gqa_int8_tree5_prefix", dict(kv_heads=4, pool="int8", q_dtype=torch.bfloat16, s_q=5, tree=True, shared=False, prefix_pages=2)),
    ]
    worst = 0.0
    per_case = {}
    repeat = {}
    for name, spec in cases:
        case = make_case(rs, **spec)
        args, kw = kernel_inputs(case)
        route = pa.plan_paged(spec["q_dtype"], kv_dtype_of(spec["pool"]), DH,
                              PS, spec["s_q"], H // spec["kv_heads"])
        if (route == "sm90") != (spec["q_dtype"] == torch.bfloat16):
            raise AssertionError(f"kernel case {name}: planned {route!r}")
        want = pa.paged_attention_reference(*args, **kw)
        if spec["q_dtype"] == torch.bfloat16:
            atol = rtol = 2e-2
        else:
            atol, rtol = 1e-4, 1e-4
        # the planned route, then "simt" forced on the same inputs
        errs, outs = {}, {}
        for r in dict.fromkeys((route, "simt")):
            before = pa.launches_by_route[r]
            got = pa.paged_attention(*args, **kw,
                                     route=None if r == route else r)
            torch.cuda.synchronize()
            if pa.launches_by_route[r] != before + 1:
                raise AssertionError(f"kernel case {name}: the {r!r} route "
                                     f"did not launch")
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), atol=atol,
                                rtol=rtol)
            if not ok or not math.isfinite(err):
                raise AssertionError(f"kernel case {name} ({r}) disagrees "
                                     f"with paged_attention_reference: "
                                     f"{err}")
            errs[r], outs[r] = err, got
        if route == "sm90":
            again = pa.paged_attention(*args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(outs["sm90"], again):
                raise AssertionError(f"kernel case {name}: two sm90 calls on "
                                     f"the same inputs differ")
            repeat[name] = True
        per_case[name] = {"route": route, "max_abs_err": errs, "atol": atol,
                          "rtol": rtol, "live_pages": case["n_live"]}
        log(f"kernel {name}: route {route}, max_abs_err " + ", ".join(
            f"{r} {e:.3e}" for r, e in errs.items())
            + f" (atol {atol}, rtol {rtol}) live_pages={case['n_live']}")
        worst = max(worst, errs[route])
    report["kernel_cases"] = per_case
    log("paged repeat, bit for bit: " + ", ".join(
        f"{n} (sm90) ok" for n in repeat))

    # timing at the main path's shapes: bf16 MHA decode, one lane, the
    # serving prompts mid-decode; then the prefix-cache layout: 8 lanes,
    # all 8 slots behind one 256-token (4-page) shared prompt prefix
    timing = time_paged(rs, np.asarray(PROMPT_LENS) + N_NEW // 2)
    prefix = time_paged(rs, np.asarray(PROMPT_LENS) + N_NEW // 2 + 4 * PS,
                        prefix_pages=4, plain=False)
    for label, t in (("bf16 MHA decode", timing),
                     ("bf16 MHA decode, 8 lanes, 4-page shared prefix",
                      prefix)):
        plain = (f"; plain {t['plain_ms'] * 1e3:.2f} us"
                 if t["plain_ms"] is not None else "")
        log(f"kernel timing ({label}, {t['live_pages']} live pages, "
            f"{t['timed_by']}): sm90 {t['ms'] * 1e3:.2f} us; simt "
            f"{t['previous_ms'] * 1e3:.2f} us{plain}; sdpa over dense "
            f"gather {t['library_ms'] * 1e3:.2f} us; bound "
            f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}); per-call "
            f"(events) " + ", ".join(f"{k} {v * 1e3:.1f} us"
                                     for k, v in t["call_ms"].items())
            + "; each kernel's own device time " + "; ".join(
                f"{r}: " + ", ".join(f"{kernel_name(n)} {v * 1e3:.2f} us"
                                     for n, v in ks.items())
                + f" (sum {sum(ks.values()) * 1e3:.2f} us)"
                for r, ks in t["kernel_ms"].items()))
    report["kernel_timing"] = timing
    report["kernel_timing_prefix"] = prefix
    return {"max_abs_err": worst, **timing}


# ----------------------------------------------------------------- flash
# B1-B3 cases: (name, B, H, H_kv, S_q, S_kv, D, dtype, causal). The first
# is the training path's geometry (GPT-2 small, batch 8 x 1024) and the
# one timed; "d32" is the recipe default's (d_model 256 / 8 heads).
FLASH_CASES = [
    ("mha_bf16_causal", 8, 12, 12, 1024, 1024, 64, torch.bfloat16, True),
    ("mha_fp32_causal", 8, 12, 12, 1024, 1024, 64, torch.float32, True),
    ("gqa4_bf16_causal", 8, 12, 4, 1024, 1024, 64, torch.bfloat16, True),
    ("kvcache_bf16_sq256_skv1024", 8, 12, 12, 256, 1024, 64,
     torch.bfloat16, True),
    ("ragged1000_bf16_causal", 8, 12, 12, 1000, 1000, 64, torch.bfloat16,
     True),
    ("d32_bf16_causal", 32, 8, 8, 256, 256, 32, torch.bfloat16, True),
    ("d128_bf16_causal", 4, 8, 8, 1024, 1024, 128, torch.bfloat16, True),
    ("mha_bf16_noncausal_s512", 4, 12, 12, 512, 512, 64, torch.bfloat16,
     False),
    ("mha_fp32_noncausal_s512", 4, 12, 12, 512, 512, 64, torch.float32,
     False),
    # gpt-long's heads (d_model 768 / 16 = D 48, 16 over 8 kv heads)
    ("gqa2_d48_bf16_causal", 2, 16, 8, 2048, 2048, 48, torch.bfloat16, True),
    ("gqa2_d48_fp32_causal", 1, 16, 8, 1024, 1024, 48, torch.float32, True),
    ("d48_bf16_kvcache_sq256_skv1024", 8, 16, 8, 256, 1024, 48,
     torch.bfloat16, True),
]
# head dims whose bf16 cases run the "mma_sync" kernels (no "sm90" build)
MMA_SYNC_DIMS = (32, 48)
# gpt-long's attention (examples/lm/gpt/gpt-long.yml): B, H, H_kv, S, D
LONG_GEOMETRY = (8, 16, 8, 8192, 48)
# atol = rtol, per dtype. bf16: the kernels round P and dS to bf16 before
# their second product (tensor-core operands) where the plain version
# keeps fp32, so outputs differ by a few bf16 ulp of their own size;
# fp32: only the summation order differs
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def flash_inputs(gen, b, h, h_kv, s_q, s_kv, d, dtype):
    """(q, k, v, dO) in the kernels' folded (BH, S, D) layout."""
    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=DEV).to(dtype)
    return (rand(b * h, s_q, d), rand(b * h_kv, s_kv, d),
            rand(b * h_kv, s_kv, d), rand(b * h, s_q, d))


def expected_route(dtype, d) -> str:
    """The route the flash plans must give a case: ``"f32"`` at fp32,
    ``"mma_sync"`` at the bf16 head dims without an ``"sm90"`` build,
    ``"sm90"`` at every other bf16 case of ``FLASH_CASES``."""
    if dtype == torch.float32:
        return "f32"
    return "mma_sync" if d in MMA_SYNC_DIMS else "sm90"


def visible_pairs(s_q, s_kv, causal):
    """(query, key) pairs the causal mask leaves visible, per head."""
    if not causal:
        return s_q * s_kv
    off = s_kv - s_q
    return sum(min(s_kv, max(0, i + off + 1)) for i in range(s_q))


def phase_flash(report: dict) -> dict:
    """Each of B1, B2 and B3 against its plain version in every case,
    then timed at the training geometry. Returns the three kernels'
    ``kernels``-line fields."""
    from torchbooster_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=DEV).manual_seed(0)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    per_case = {}
    repeat = {}
    for name, b, h, h_kv, s_q, s_kv, d, dtype, causal in FLASH_CASES:
        q, k, v, do = flash_inputs(gen, b, h, h_kv, s_q, s_kv, d, dtype)
        scale = 1.0 / math.sqrt(d)
        # B1 on its planned route: every bf16 case on "sm90" but D 32 and
        # D 48, which take "mma_sync"
        fwd_route = fa.plan_flash_fwd(dtype, d, s_q, s_kv, h // h_kv)
        if fwd_route != expected_route(dtype, d):
            raise AssertionError(f"flash case {name}: B1 planned "
                                 f"{fwd_route!r}, not "
                                 f"{expected_route(dtype, d)!r}")
        before = fa.launches_fwd_by_route[fwd_route]
        o, lse = fa.launch_fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        if fa.launches_fwd_by_route[fwd_route] != before + 1:
            raise AssertionError(f"flash case {name}: B1 did not take the "
                                 f"{fwd_route!r} route")
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, scale)
        # the backward pair on the same inputs: the plain forward's o/lse,
        # on the planned route (as B1's)
        route = fa.plan_flash_bwd(dtype, d, s_q, s_kv, h // h_kv)
        if route != expected_route(dtype, d):
            raise AssertionError(f"flash case {name}: planned {route!r}, "
                                 f"not {expected_route(dtype, d)!r}")
        before = (fa.launches_dq_by_route[route],
                  fa.launches_dkv_by_route[route])
        dq, delta = fa.launch_dq(q, k, v, o_ref, lse_ref, do, causal, scale)
        dk, dv = fa.launch_dkv(q, k, v, lse_ref, do, delta, causal, scale)
        torch.cuda.synchronize()
        if (fa.launches_dq_by_route[route], fa.launches_dkv_by_route[route]
                ) != (before[0] + 1, before[1] + 1):
            raise AssertionError(f"flash case {name}: B2/B3 did not take "
                                 f"the {route!r} route")
        if dtype == torch.bfloat16:
            # a second call on the same inputs must repeat bit for bit
            o2, lse2 = fa.launch_fwd(q, k, v, causal, scale)
            dq2, delta2 = fa.launch_dq(q, k, v, o_ref, lse_ref, do, causal,
                                       scale)
            dk2, dv2 = fa.launch_dkv(q, k, v, lse_ref, do, delta2, causal,
                                     scale)
            torch.cuda.synchronize()
            repeat[name] = {"fwd_route": fwd_route, "route": route,
                            "fwd_bit_identical": torch.equal(o, o2)
                            and torch.equal(lse, lse2),
                            "bit_identical": all(
                torch.equal(x, y) for x, y in ((dq, dq2), (delta, delta2),
                                               (dk, dk2), (dv, dv2)))}
            if not repeat[name]["fwd_bit_identical"]:
                raise AssertionError(f"flash case {name} ({fwd_route}): two "
                                     f"forward calls on the same inputs "
                                     f"differ")
            if not repeat[name]["bit_identical"]:
                raise AssertionError(f"flash case {name} ({route}): two "
                                     f"backward calls on the same inputs "
                                     f"differ")
        args = (q, k, v, o_ref, lse_ref, do, causal, scale)
        dq_ref = fa.dq_reference(*args)
        dk_ref, dv_ref = fa.dkv_reference(*args)
        tol = FLASH_TOL[dtype]
        errs, used = hold_flash(f"flash case {name}", tol, (
            ("o", o, o_ref), ("lse", lse, lse_ref), ("dq", dq, dq_ref),
            ("dk", dk, dk_ref), ("dv", dv, dv_ref)))
        worst["fwd"] = max(worst["fwd"], errs["o"], errs["lse"])
        worst["dq"] = max(worst["dq"], errs["dq"])
        worst["dkv"] = max(worst["dkv"], errs["dk"], errs["dv"])
        per_case[name] = {"max_abs_err": errs, "allowance_used": used,
                          "atol": tol, "rtol": tol, "fwd_route": fwd_route,
                          "bwd_route": route}
        log(f"flash {name}: " + ", ".join(
            f"{k} {errs[k]:.2e} ({100 * used[k]:.0f}%)" for k in errs)
            + f" (max abs err, and % of the allowance atol + rtol|ref| "
            f"used; atol = rtol = {tol}); forward route {fwd_route}, "
            f"backward route {route}")
    report["flash_cases"] = per_case
    report["flash_bwd_repeat"] = repeat
    log("flash forward repeat, bit for bit: " + ", ".join(
        f"{n} ({r['fwd_route']}) ok" for n, r in repeat.items()))
    log("flash backward repeat, bit for bit: " + ", ".join(
        f"{n} ({r['route']}) ok" for n, r in repeat.items()))

    # timing at the training path's shapes (bf16 MHA causal, B 8, H 12,
    # S 1024, D 64), each kernel beside its plain half, SDPA and the
    # "mma_sync" route on the same inputs
    _, b, h, h_kv, s_q, _, d, _, _ = FLASH_CASES[0]
    timing = time_flash(gen, b, h, h_kv, s_q, d, worst, previous=True)
    log(f"flash timing B2 + B3: sm90 {(timing['dq']['ms'] + timing['dkv']['ms']) * 1e3:.1f}"
        f" us, mma_sync {(timing['dq']['previous_ms'] + timing['dkv']['previous_ms']) * 1e3:.1f}"
        f" us, sdpa backward {timing['dq']['library_ms'] * 1e3:.1f} us")
    report["flash_timing"] = timing
    # and at gpt-long's (B 8, H 16 over 8 kv heads, S 8192, D 48), where
    # "mma_sync" is the planned route; its max abs errors are those of the
    # timed inputs alone
    b, h, h_kv, s_len, d = LONG_GEOMETRY
    long = time_flash(gen, b, h, h_kv, s_len, d, None, previous=False,
                      plain_iters=3)
    log(f"flash timing gpt-long B1 + B2 + B3: mma_sync "
        f"{sum(long[k]['ms'] for k in ('fwd', 'dq', 'dkv')):.3f} ms; sdpa "
        f"forward + backward {long['sdpa_fwd_bwd_ms']:.3f} ms")
    report["flash_timing_long"] = long
    report["auto_crossover"] = crossover()
    return {**timing, "long": long}


def hold_flash(label: str, tol: float, pairs) -> tuple[dict, dict]:
    """Each ``(key, got, want)`` of ``pairs`` held to atol = rtol = ``tol``
    (raises on a miss). Returns the max abs errors and, per key, the
    largest share of its allowance atol + rtol|want| that any element
    uses: <= 1 is what torch.allclose accepts."""
    errs, used = {}, {}
    for key, got, want in pairs:
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        errs[key] = diff.max().item()
        used[key] = (diff / (tol + tol * want.abs())).max().item()
        if not (used[key] <= 1.0 and math.isfinite(errs[key])):
            raise AssertionError(f"{label}: {key} disagrees with the plain "
                                 f"version: max abs err {errs[key]} (atol "
                                 f"= rtol = {tol})")
    return errs, used


def time_flash(gen, b, h, h_kv, s_len, d, worst, previous: bool,
               plain_iters: int = 10) -> dict:
    """B1, B2 and B3 at bf16, causal, ``(B, H, H_kv, S, D)``, each on its
    planned route beside its plain version, its bound and SDPA (the
    forward; its backward, whose dQ, dK and dV stand beside B2 + B3;
    grouped K/V are expanded to the query heads before SDPA's timed
    calls), and with ``previous`` the ``"mma_sync"`` route on the same
    inputs. Each kernel's output on the timed inputs is held to its plain
    version's (bf16 atol = rtol of ``FLASH_TOL``); a kernel's
    ``max_abs_err`` is that error, or the larger of it and ``worst``'s
    (the checked cases' at this head dim) where ``worst`` is given."""
    from torchbooster_tpu_torch.ops import flash_attention as fa

    dtype = torch.bfloat16
    q, k, v, do = flash_inputs(gen, b, h, h_kv, s_len, s_len, d, dtype)
    scale = 1.0 / math.sqrt(d)
    route = fa.plan_flash_fwd(dtype, d, s_len, s_len, h // h_kv)
    o, lse = fa.launch_fwd(q, k, v, True, scale)
    _, delta = fa.launch_dq(q, k, v, o, lse, do, True, scale)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4, do4 = (t.reshape(b, -1, s_len, d) for t in (q, k, v, do))
    k4, v4 = (t.repeat_interleave(h // h_kv, dim=1) for t in (k4, v4))
    q4g, k4g, v4g = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    out4 = sdpa(q4g, k4g, v4g, is_causal=True)
    bwd_args = (q, k, v, o, lse, do, True, scale)
    runs = {
        "fwd": (lambda: fa.launch_fwd(q, k, v, True, scale),
                lambda: fa.flash_attention_reference(q, k, v, True, scale),
                lambda: sdpa(q4, k4, v4, is_causal=True)),
        "dq": (lambda: fa.launch_dq(q, k, v, o, lse, do, True, scale),
               lambda: fa.dq_reference(*bwd_args),
               lambda: torch.autograd.grad(out4, (q4g, k4g, v4g), do4,
                                           retain_graph=True)),
        "dkv": (lambda: fa.launch_dkv(q, k, v, lse, do, delta, True, scale),
                lambda: fa.dkv_reference(*bwd_args), None),
    }
    pairs = b * h * visible_pairs(s_len, s_len, True)
    el = torch.finfo(dtype).bits // 8
    n_q, n_kv = b * h * s_len * d, b * h_kv * s_len * d
    rows = b * h * s_len
    # products per kernel (2 flops per multiply-add over D for each visible
    # pair): B1 QK^T, PV; B2 QK^T, dO V^T, dS K; B3 QK^T, dO V^T, P^T dO,
    # dS^T Q. Bytes: each input read once, each output written once.
    work = {"fwd": (2 * 2, (n_q + 2 * n_kv + n_q) * el + rows * 4),
            "dq": (3 * 2, (3 * n_q + 2 * n_kv + n_q) * el + rows * 8),
            "dkv": (4 * 2, (2 * n_q + 4 * n_kv) * el + rows * 8)}
    # B1, B2 and B3 on their earlier route, on the same inputs (outside
    # the main path's launch counts)
    older = {
        "fwd": lambda: fa.launch_fwd(q, k, v, True, scale,
                                     route="mma_sync"),
        "dq": lambda: fa.launch_dq(q, k, v, o, lse, do, True, scale,
                                   route="mma_sync"),
        "dkv": lambda: fa.launch_dkv(q, k, v, lse, do, delta, True, scale,
                                     route="mma_sync")} if previous else {}
    # one output of each kernel and of its plain version on these inputs
    tol = FLASH_TOL[dtype]
    label = f"flash timed inputs B{b} H{h} H_kv{h_kv} S{s_len} D{d}"
    o_ref, lse_ref = runs["fwd"][1]()
    dq_ref = runs["dq"][1]()
    delta_ref = (o.float() * do.float()).sum(dim=-1)
    dk, dv = runs["dkv"][0]()
    dk_ref, dv_ref = runs["dkv"][1]()
    dq = runs["dq"][0]()[0]
    errs, used = hold_flash(label, tol, (
        ("o", o, o_ref), ("lse", lse, lse_ref), ("dq", dq, dq_ref),
        ("delta", delta, delta_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref)))
    log(f"{label}: " + ", ".join(f"{n} {errs[n]:.2e} ({100 * used[n]:.0f}%)"
                                 for n in errs)
        + f" (max abs err vs the plain version, % of atol + rtol|ref| "
        f"used; atol = rtol = {tol}); route {route}")
    measured = {"fwd": max(errs["o"], errs["lse"]),
                "dq": max(errs["dq"], errs["delta"]),
                "dkv": max(errs["dk"], errs["dv"])}
    del o_ref, lse_ref, dq_ref, delta_ref, dk, dv, dk_ref, dv_ref, dq
    timing = {"checked": {"max_abs_err": errs, "allowance_used": used,
                          "atol": tol, "rtol": tol}}
    for key, (kern, plain, lib) in runs.items():
        call = {"kernel": cuda_ms(kern, iters=50),
                "plain": cuda_ms(plain, iters=plain_iters)}
        own = {}
        dev = {"kernel": device_ms(kern, iters=50, by_kernel=own),
               "plain": device_ms(plain, iters=plain_iters)}
        if lib is not None:
            call["library"] = cuda_ms(lib, iters=50)
            dev["library"] = device_ms(lib, iters=50)
        if key in older:
            call["previous"] = cuda_ms(older[key], iters=50)
            dev["previous"] = device_ms(older[key], iters=50)
        stream = {}
        if all(dev.values()):
            src, timed_by = dev, DEVICE_TIME
        else:
            # the profiler lost events: time the calls back to back
            fns = {"kernel": kern, "plain": plain, "library": lib,
                   "previous": older.get(key)}
            stream = {n: stream_ms(fn, iters=plain_iters if n == "plain"
                                   else 50)
                      for n, fn in fns.items() if fn is not None}
            src, timed_by = stream, "CUDA events over back-to-back calls"
        prods, nbytes = work[key]
        flops = prods * d * pairs
        t_ops = flops / BF16_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        timing[key] = {
            "ms": src["kernel"], "plain_ms": src["plain"],
            "sum_ms": sum(own.values()) if src is dev else None,
            "library_ms": src.get("library"), "timed_by": timed_by,
            "call_ms": call, "device_ms": dev, "stream_ms": stream,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes,
            "tflops": flops / src["kernel"] / 1e9, "timed_route": route,
            "max_abs_err": max(measured[key], worst[key]) if worst
            else measured[key], "timed_inputs_max_abs_err": measured[key]}
        lib_txt = (f"; sdpa {src['library'] * 1e3:.1f} us"
                   if lib is not None else "")
        route_txt = f" (route {route})"
        if key in older:
            timing[key].update(
                previous_route="mma_sync", previous_ms=src["previous"],
                previous_tflops=flops / src["previous"] / 1e9)
            route_txt += (f"; mma_sync {src['previous'] * 1e3:.1f} us, "
                          f"{timing[key]['previous_tflops']:.1f} TFLOP/s")
        log(f"flash timing {key} (bf16 causal B{b} H{h} H_kv{h_kv} "
            f"S{s_len} D{d}, {timed_by}): kernel {src['kernel'] * 1e3:.1f} "
            f"us{route_txt}; plain {src['plain'] * 1e3:.1f} us{lib_txt}; "
            f"bound {timing[key]['bound_ms'] * 1e3:.1f} us "
            f"({timing[key]['bound_by']}, {flops / 1e12:.3f} TFLOP); "
            f"achieved {timing[key]['tflops']:.1f} TFLOP/s")
    # the SDPA yardstick's backward computes dQ, dK and dV in one call: it
    # stands beside B2 and B3 together
    timing["dkv"]["library_ms"] = timing["dq"]["library_ms"]
    timing["sdpa_fwd_bwd_ms"] = timing["fwd"]["library_ms"] \
        + timing["dq"]["library_ms"]
    del q, k, v, do, q4g, k4g, v4g, out4
    torch.cuda.empty_cache()
    return timing


def crossover() -> list:
    """Forward + backward through ``attention`` (bf16, causal, B 8, H 12,
    D 64) with the flash kernels and with ``mha_reference``, across S:
    the measurement the ``"auto"`` rule rests on."""
    from torchbooster_tpu_torch.ops.attention import attention

    gen = torch.Generator(device=DEV).manual_seed(1)
    rows = []
    for s_len in (256, 512, 1024, 2048, 4096):
        q, k, v, do = (torch.randn(8, s_len, 12, 64, generator=gen,
                                   device=DEV, dtype=torch.bfloat16)
                       for _ in range(4))
        for t in (q, k, v):
            t.requires_grad_()
        row = {"S": s_len}
        for impl in ("flash", "reference"):
            row[f"{impl}_ms"] = cuda_ms(
                lambda: attention(q, k, v, impl=impl).backward(do),
                iters=10, warmup=2)
        rows.append(row)
        log(f"auto crossover S={s_len}: flash fwd+bwd {row['flash_ms']:.3f}"
            f" ms, mha_reference {row['reference_ms']:.3f} ms (CUDA "
            f"events per call)")
        del q, k, v, do
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------- serving
def gpt2_small():
    from torchbooster_tpu_torch.models.gpt import GPT, GPTConfig

    cfg = GPTConfig()
    params = GPT.init(0, cfg, device="cuda")
    params["wte"]["table"] *= 4.0       # decisive head
    return params, cfg


def requests(cfg):
    from torchbooster_tpu_torch.serving import Request

    rs = np.random.RandomState(1)
    return [Request(prompt=rs.randint(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=N_NEW, request_id=f"r{i}")
            for i, n in enumerate(PROMPT_LENS)]


def reset_paged_counts() -> None:
    from torchbooster_tpu_torch.ops import paged_attention as pa

    pa.launches = 0
    pa.launches_by_route.update(dict.fromkeys(pa.launches_by_route, 0))


def serve(params, cfg, dtype: torch.dtype):
    from torchbooster_tpu_torch.config import ServingConfig
    from torchbooster_tpu_torch.ops import paged_attention as pa

    batcher = ServingConfig(page_size=PS, n_pages=N_PAGES,
                            max_slots=SLOTS).make(
        params, cfg, compute_dtype=dtype, on_recompile="raise")
    if batcher.engine.decode_backend != "kernel":
        raise AssertionError("the CUDA engine is not on the kernel backend")
    reqs = requests(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_paged_counts()
    metrics = batcher.run(reqs)
    torch.cuda.synchronize()
    launches = pa.launches
    by_route = dict(pa.launches_by_route)
    metrics["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    if launches <= 0:
        raise AssertionError("the serving run never launched the kernel")
    if batcher.engine.decode_compiles != 1:
        raise AssertionError(f"decode step took "
                             f"{batcher.engine.decode_compiles} shapes")
    for r in reqs:
        if len(r.tokens) != N_NEW or not all(
                0 <= t < cfg.vocab for t in r.tokens):
            raise AssertionError(f"{r.request_id}: bad tokens {r.tokens}")
    # bf16 decode plans "sm90", fp32 "simt"; every launch on that route
    want = "sm90" if dtype == torch.bfloat16 else "simt"
    if by_route[want] != launches:
        raise AssertionError(f"{dtype} serving: B4 launches by route "
                             f"{by_route}, not all {want!r}")
    return batcher, reqs, metrics, launches, by_route


def dense_tokens(params, cfg, reqs, dtype, n_new: int = N_NEW):
    from torchbooster_tpu_torch.models.gpt import generate

    out = []
    for r in reqs:
        ids = torch.as_tensor(r.prompt, device="cuda").long()[None]
        full = generate(params, ids, cfg, n_new=n_new, temperature=0.0,
                        compute_dtype=dtype)
        out.append(full[0, len(r.prompt):].tolist())
    return out


def device_breakdown(batcher, cfg) -> dict:
    """Replay the same trace under the profiler (CUDA activity only):
    device busy share of the wall time and the top kernels by their own
    device time. Busy time and B4's time are unions of device intervals,
    so B4's merge, which starts under its first pass (programmatic
    dependent launch), counts once; ``paged_kernel_sum_s`` is B4's kernels'
    own times summed, the measure of the smoke's earlier revisions. The
    profiled run is not the one the tok/s figures come from."""
    from torch.profiler import ProfilerActivity, profile

    reqs = requests(cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = batcher.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = device_spans(prof)
    own: dict = {}
    for start, stop, name in spans:
        own[name] = own.get(name, 0.0) + (stop - start) / 1e6
    busy = union_us(spans) / 1e6
    paged_spans = [sp for sp in spans if "paged_" in sp[2]]
    paged = union_us(paged_spans) / 1e6
    return {"wall_s": wall, "device_busy_s": busy,
            "device_busy_share": busy / wall, "paged_kernel_s": paged,
            "paged_kernel_sum_s": sum(stop - start
                                      for start, stop, _ in paged_spans) / 1e6,
            "paged_share_of_device": paged / max(busy, 1e-12),
            "decode_s": m["elapsed_s"],
            "top": sorted(own.items(), key=lambda kv: -kv[1])[:8]}


def phase_serve(params, cfg, dtype, smi: str, report: dict, key: str,
                breakdown: bool = False):
    batcher, reqs, m, launches, by_route = serve(params, cfg, dtype)
    dense = dense_tokens(params, cfg, reqs, dtype)
    match = [r.tokens == d for r, d in zip(reqs, dense)]
    n_steps = launches // cfg.n_layers
    report[key] = {"metrics": m, "launches": launches,
                   "launches_per_step": cfg.n_layers,
                   "launches_by_route": by_route,
                   "decode_steps": n_steps, "token_match": match,
                   "card": smi}
    log(f"{key}: {sum(match)}/{len(match)} requests token-exact vs dense "
        f"generate; kernel launches {launches} ({cfg.n_layers} per decode "
        f"step), B4 by route {by_route}; decode {m['decode_tok_s']} tok/s, "
        f"p50 TTFT "
        f"{m['ttft_p50_s']} s, peak mem {m['peak_mem_bytes'] / 2**20:.1f} "
        f"MiB [{smi}]")
    if breakdown:
        b = report[key]["breakdown"] = device_breakdown(batcher, cfg)
        log(f"{key} profiled replay: wall {b['wall_s']:.3f} s, device busy "
            f"{b['device_busy_s']:.4f} s ({100 * b['device_busy_share']:.1f}"
            f"%), paged kernel {b['paged_kernel_s']:.5f} s "
            f"({100 * b['paged_share_of_device']:.1f}% of device time; its "
            f"kernels' own times summed {b['paged_kernel_sum_s']:.5f} s)")
    return match, launches, by_route


# ---------------------------------------------- speculative and fork serving
SPEC_NEW = 64          # new tokens a request in the speculative phases
DRAFT_LEN = 4          # S = 5 verify rows a slot
FORK_LENS = (256, 100)
FORK_NEW = 32
FORK_N = 4             # n = best_of


def repetitive_prompt(rs, n: int, vocab: int) -> np.ndarray:
    """``n`` tokens of a tiled random pattern of 3-8 tokens (the JAX
    suite's ``_repetitive_prompt``)."""
    pat = rs.randint(0, vocab, int(rs.randint(3, 9))).astype(np.int32)
    return np.resize(pat, n).astype(np.int32)


def ambiguous_prompt(params, cfg, dtype, rs, n: int) -> np.ndarray:
    """About ``n`` tokens of a tiled pattern ``R`` cut by one n-gram ``u v
    f`` seen twice: ``R + [u, v, f, t] + R + [u, v, f, w] + R + [u, v]``,
    where ``f`` and ``t`` are the dense model's own first two greedy picks
    after the whole prompt (found by iterating to a fixed point), and
    ``w`` another token. After the first token (``f``) the tree drafter
    sees two continuations of the suffix: ``w`` (the most recent, the
    primary branch) and ``t`` (the side branch), and the model picks
    ``t``: an ambiguous repetitive prompt whose side branch is right."""
    from torchbooster_tpu_torch.serving import Request

    vocab = cfg.vocab
    for _ in range(8):
        pat = rs.randint(0, vocab, int(rs.randint(3, 9))).astype(np.int32)
        seg = np.resize(pat, max((n - 10) // 3 // len(pat), 1) * len(pat))
        u, v, w = (int(x) for x in rs.randint(0, vocab, 3))
        f = t = v
        for _ in range(4):
            prompt = np.concatenate([seg, [u, v, f, t], seg, [u, v, f, w],
                                     seg, [u, v]]).astype(np.int32)
            got = dense_tokens(params, cfg, [Request(prompt=prompt)], dtype,
                               n_new=2)[0]
            if got == [f, t] and t != w:
                return prompt
            f, t = got
            if t == w:
                w = (w + 1) % vocab
    raise AssertionError("no ambiguous prompt reached a fixed point")


def spec_run(batcher, cfg, dtype, prompts, tree: bool) -> dict:
    """One run of the speculative ``batcher`` over ``prompts`` (SPEC_NEW
    new tokens each), with the exact B4 launch count and route checks."""
    from torchbooster_tpu_torch.ops import paged_attention as pa
    from torchbooster_tpu_torch.serving import Request

    eng = batcher.engine
    steps0, slot_steps0 = eng.spec_steps, eng.spec_slot_steps
    side0 = eng.tree_side_accepts
    reqs = [Request(prompt=p, max_new_tokens=SPEC_NEW, request_id=f"s{i}")
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    reset_paged_counts()
    m = batcher.run(reqs)
    torch.cuda.synchronize()
    launches, by_route = pa.launches, dict(pa.launches_by_route)
    steps = eng.spec_steps - steps0
    want = "sm90" if dtype == torch.bfloat16 else "simt"
    if launches != cfg.n_layers * steps or by_route[want] != launches:
        raise AssertionError(
            f"{dtype} speculative serving: {launches} B4 launches by route "
            f"{by_route} over {steps} verify steps, not {cfg.n_layers} a "
            f"step all on {want!r}")
    if eng.verify_compiles != 1 or eng.decode_compiles != 0:
        raise AssertionError(f"verify step took {eng.verify_compiles} "
                             f"shapes, decode {eng.decode_compiles}")
    if m["n_spec_accepted"] <= 0:
        raise AssertionError("no draft was accepted")
    side = eng.tree_side_accepts - side0
    if tree and side <= 0:
        raise AssertionError("no side branch of a tree was accepted")
    eng.tables.check()
    slot_steps = eng.spec_slot_steps - slot_steps0
    # tokens the verify steps delivered (the prefill's first tokens apart)
    delivered = m["new_tokens"] - len(prompts)
    return {"reqs": reqs, "metrics": m, "launches": launches,
            "by_route": by_route, "spec_steps": steps,
            "slot_steps": slot_steps, "side_accepts": side,
            "tokens_per_step": delivered / max(steps, 1),
            "tokens_per_slot_step": delivered / max(slot_steps, 1)}


def phase_serve_spec(params, cfg, dtype, smi: str, report: dict, key: str,
                     tree: bool = False) -> tuple[int, dict]:
    """A speculative serving phase built through ``ServingConfig.make``
    (``speculative: true, draft_len: 4[, spec_tree: true,
    spec_tree_width: 2]``): every request equal to the dense
    ``generate``; the plain decode engine (``serve_bf16``'s
    configuration) on the same prompts in turns with it (plain, spec,
    spec, plain), so their times compare within the call."""
    from torchbooster_tpu_torch.config import ServingConfig
    from torchbooster_tpu_torch.serving import Request

    rs = np.random.RandomState(7)
    if tree:
        prompts = [ambiguous_prompt(params, cfg, dtype, rs, n)
                   for n in PROMPT_LENS]
    else:
        prompts = [repetitive_prompt(rs, n, cfg.vocab) for n in PROMPT_LENS]
    spec = ServingConfig(page_size=PS, n_pages=N_PAGES, max_slots=SLOTS,
                         speculative=True, draft_len=DRAFT_LEN,
                         spec_tree=tree, spec_tree_width=2).make(
        params, cfg, compute_dtype=dtype, on_recompile="raise")
    if spec.engine.decode_backend != "kernel" \
            or spec.engine.draft_len != DRAFT_LEN:
        raise AssertionError("the CUDA speculative engine is not on the "
                             "kernel backend with draft_len 4")
    plain = ServingConfig(page_size=PS, n_pages=N_PAGES,
                          max_slots=SLOTS).make(params, cfg,
                                                compute_dtype=dtype)
    dense = None
    runs, plain_runs = [], []
    for turn in ("plain", "spec", "spec", "plain"):
        if turn == "spec":
            run = spec_run(spec, cfg, dtype, prompts, tree)
            runs.append(run)
            got = [r.tokens for r in run["reqs"]]
        else:
            reqs = [Request(prompt=p, max_new_tokens=SPEC_NEW)
                    for p in prompts]
            plain_runs.append(plain.run(reqs))
            torch.cuda.synchronize()
            got = [r.tokens for r in reqs]
        if dense is None:
            dense = dense_tokens(params, cfg, [Request(prompt=p)
                                               for p in prompts],
                                 dtype, n_new=SPEC_NEW)
        match = [g == d for g, d in zip(got, dense)]
        if not all(match):
            raise AssertionError(f"{key} ({turn}): {match.count(False)} of "
                                 f"{len(match)} requests differ from dense "
                                 "generate")
    m = runs[-1]["metrics"]
    report[key] = {
        "runs": [{k: v for k, v in r.items() if k != "reqs"} for r in runs],
        "plain_runs": plain_runs, "token_match": match, "card": smi}
    tok_s = [r["metrics"]["decode_tok_s"] for r in runs]
    plain_tok_s = [pm["decode_tok_s"] for pm in plain_runs]
    log(f"{key}: {len(match)}/{len(match)} requests token-exact vs dense "
        f"generate in both runs; {runs[-1]['spec_steps']} verify steps a "
        f"run, B4 launches {runs[-1]['launches']} ({cfg.n_layers} a step), "
        f"by route {runs[-1]['by_route']}; accept rate "
        f"{m['spec_accept_rate']} ({m['n_spec_accepted']}/"
        f"{m['n_spec_proposed']}), "
        f"{runs[-1]['tokens_per_slot_step']:.2f} tokens a slot a verify "
        f"step, {runs[-1]['tokens_per_step']:.2f} a verify step, "
        + (f"{runs[-1]['side_accepts']} side-branch acceptances, " if tree
           else "")
        + f"decode {tok_s} tok/s, p50 TTFT "
        f"{[r['metrics']['ttft_p50_s'] for r in runs]} s; the plain decode "
        f"engine on the same prompts (before and after) {plain_tok_s} "
        f"tok/s, p50 TTFT {[pm['ttft_p50_s'] for pm in plain_runs]} s "
        f"[{smi}]")
    return (sum(r["launches"] for r in runs),
            {k: sum(r["by_route"][k] for r in runs)
             for k in runs[0]["by_route"]})


def phase_serve_fork(params, cfg, smi: str, report: dict) -> tuple[int, dict]:
    """``parallel_sampling``: two requests (FORK_LENS prompt tokens), n =
    best_of = 4, at bf16. Greedy: every branch equals dense ``generate``,
    full prompt pages are shared through several lanes and tail pages
    copied. Seeded sampling (temperature 0.8, top-k 50): each branch
    equals the engine's own run admitted alone with ``(seed, branch)``."""
    from torchbooster_tpu_torch.config import ServingConfig
    from torchbooster_tpu_torch.ops import paged_attention as pa
    from torchbooster_tpu_torch.serving import (ContinuousBatcher, Request,
                                                best_completions)

    dtype = torch.bfloat16
    rs = np.random.RandomState(11)
    prompts = [rs.randint(0, cfg.vocab, n).astype(np.int32)
               for n in FORK_LENS]

    def family(batcher) -> tuple[list, int]:
        reqs = [Request(prompt=p, max_new_tokens=FORK_NEW, n=FORK_N,
                        best_of=FORK_N, seed=100 + i, request_id=f"f{i}")
                for i, p in enumerate(prompts)]
        batcher.start_session()
        for r in reqs:
            batcher.submit(r)
        max_lanes = 0
        while any(r.branches is None or any(b.finished_at is None
                                            for b in r.branches)
                  for r in reqs):
            batcher.step()
            refs = batcher.engine.tables.kernel_args()["work_refs"]
            max_lanes = max(max_lanes, int((refs >= 0).sum(axis=1).max()))
        batcher.finish_session()
        return reqs, max_lanes

    conf = dict(page_size=PS, n_pages=N_PAGES, max_slots=SLOTS,
                parallel_sampling=True)
    greedy = ServingConfig(**conf).make(params, cfg, compute_dtype=dtype,
                                        on_recompile="raise")
    eng = greedy.engine
    torch.cuda.synchronize()
    reset_paged_counts()
    reqs, max_lanes = family(greedy)
    torch.cuda.synchronize()
    launches, by_route = pa.launches, dict(pa.launches_by_route)
    dense = dense_tokens(params, cfg, reqs, dtype, n_new=FORK_NEW)
    greedy_match = [b.tokens == d for r, d in zip(reqs, dense)
                    for b in r.branches]
    if not all(greedy_match):
        raise AssertionError(f"serve_fork: {greedy_match.count(False)} greedy "
                             "branches differ from dense generate")
    if eng.forks != len(reqs) or eng.fork_pages <= 0 or eng.cow_copies <= 0:
        raise AssertionError(f"serve_fork: forks {eng.forks}, fork pages "
                             f"{eng.fork_pages}, tail copies "
                             f"{eng.cow_copies}")
    if max_lanes < FORK_N:
        raise AssertionError(f"serve_fork: shared pages were read through "
                             f"at most {max_lanes} lanes")
    if launches <= 0 or launches % cfg.n_layers or by_route["sm90"] \
            != launches or eng.decode_compiles != 1:
        raise AssertionError(f"serve_fork: B4 launches {launches} by route "
                             f"{by_route}, {eng.decode_compiles} decode "
                             "shapes")
    eng.tables.check()
    sampled = ServingConfig(**conf, temperature=0.8, top_k=50).make(
        params, cfg, compute_dtype=dtype, on_recompile="raise")
    reqs_s, _ = family(sampled)
    seeded_match = []
    for r in reqs_s:
        for b in r.branches:
            ind = Request(prompt=r.prompt, max_new_tokens=FORK_NEW,
                          seed=r.seed)
            ind.branch = b.branch
            ContinuousBatcher(sampled.engine).run([ind])
            seeded_match.append(ind.tokens == b.tokens)
    if not all(seeded_match):
        raise AssertionError(f"serve_fork: {seeded_match.count(False)} seeded "
                             "branches differ from their independent runs")
    distinct = [len({tuple(b.tokens) for b in r.branches}) for r in reqs_s]
    best = [[b.branch for b in best_completions(r)] for r in reqs_s]
    report["serve_fork"] = {
        "launches": launches, "launches_by_route": by_route,
        "forks": eng.forks, "fork_pages": eng.fork_pages,
        "cow_copies": eng.cow_copies, "max_lanes": max_lanes,
        "greedy_match": greedy_match, "seeded_match": seeded_match,
        "distinct_sampled_branches": distinct, "best_of_order": best,
        "card": smi}
    log(f"serve_fork: {sum(greedy_match)}/{len(greedy_match)} greedy branches "
        f"token-exact vs dense generate; {sum(seeded_match)}/"
        f"{len(seeded_match)} seeded branches (temperature 0.8, top-k 50) "
        f"equal their independent (seed, branch) runs, {distinct} distinct "
        f"streams a request, best_of order {best}; forks {eng.forks}, pages "
        f"shared {eng.fork_pages}, tail copies {eng.cow_copies}, shared "
        f"pages read through up to {max_lanes} lanes; B4 launches "
        f"{launches} by route {by_route} [{smi}]")
    return launches, by_route


# ------------------------------- structured, quantized and LoRA serving
STRUCT_EOS = 50256     # GPT-2's end-of-text id: outside the byte alphabet
STRUCT_LENS = (64, 100, 150, 200, 256)
RIDER_LENS = (64, 300, 512)
STRUCT_N = 4           # branches of the parallel-sampling request
WQ_GROUP = 64          # int4 scale group
LORA_RANK, LORA_LIVE, LORA_STD = 8, 4, 0.25
LORA_ADAPTERS = 6


def structured_trace(cfg, constrained: bool = True) -> list:
    """The five ``SCHEMA_LIBRARY`` schemas (``max_new_tokens`` their
    budget, EOS 50256) and three unconstrained riders (N_NEW tokens).
    ``constrained=False`` sends the schema requests' prompts unconstrained
    with the same token budget (the structured-off yardstick)."""
    from torchbooster_tpu_torch.serving import Request
    from torchbooster_tpu_torch.serving.structured import (
        SCHEMA_LIBRARY, library_response_format, schema_budget)

    rs = np.random.RandomState(13)
    reqs = []
    for i, (sid, n) in enumerate(zip(sorted(SCHEMA_LIBRARY), STRUCT_LENS)):
        prompt = rs.randint(0, cfg.vocab, n).astype(np.int32)
        kw = (dict(response_format=library_response_format(sid),
                   eos_id=STRUCT_EOS) if constrained else {})
        reqs.append(Request(prompt=prompt, max_new_tokens=schema_budget(sid),
                            request_id=f"{sid}", **kw))
    for i, n in enumerate(RIDER_LENS):
        reqs.append(Request(prompt=rs.randint(0, cfg.vocab, n).astype(
            np.int32), max_new_tokens=N_NEW, request_id=f"rider{i}"))
    return reqs


def schema_text(tokens: list) -> str:
    toks = tokens[:-1] if tokens and tokens[-1] == STRUCT_EOS else tokens
    return "".join(chr(int(t)) for t in toks if int(t) < 256)


def paged_us_per_call(run) -> float:
    """B4's device µs a call over one profiled serving run: the union of
    its kernels' intervals over the run, over its launches."""
    from torch.profiler import ProfilerActivity, profile
    from torchbooster_tpu_torch.ops import paged_attention as pa

    reset_paged_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    spans = [sp for sp in device_spans(prof) if "paged_" in sp[2]]
    return union_us(spans) / max(pa.launches, 1)


def phase_serve_structured(params, cfg, smi: str, report: dict
                           ) -> tuple[int, dict]:
    """``structured: {enabled: true}`` at bf16 on the five library
    schemas and three riders: every constrained completion conforms and
    stops on EOS, every rider equals the dense ``generate``, one decode
    shape, every B4 launch on ``"sm90"``. Then ``speculative: true,
    draft_len: 4`` on the same trace (constrained streams equal the
    plain structured run's, one verify shape, 12 B4 launches a verify
    step) and one constrained ``n = 4`` request on a parallel-sampling
    engine (every branch conforms)."""
    from torchbooster_tpu_torch.config import ServingConfig, StructuredConfig
    from torchbooster_tpu_torch.ops import paged_attention as pa
    from torchbooster_tpu_torch.serving import Request
    from torchbooster_tpu_torch.serving.structured import (
        SCHEMA_LIBRARY, conforms, library_response_format, schema_budget)

    dtype = torch.bfloat16
    geo = dict(page_size=PS, n_pages=N_PAGES, max_slots=SLOTS,
               structured=StructuredConfig(enabled=True))
    batcher = ServingConfig(**geo).make(params, cfg, compute_dtype=dtype,
                                        on_recompile="raise")
    eng = batcher.engine
    if not eng.structured or eng.decode_backend != "kernel":
        raise AssertionError("the structured engine is not on the kernel "
                             "backend")
    compile_ms = {}
    for sid in sorted(SCHEMA_LIBRARY):
        t = time.perf_counter()
        dfa = eng.structured_compile(library_response_format(sid))
        compile_ms[sid] = {"ms": 1e3 * (time.perf_counter() - t),
                           "states": dfa.n_states}
    launches, by_route = 0, dict.fromkeys(pa.launches_by_route, 0)

    def counted_run(b, reqs):
        nonlocal launches
        torch.cuda.synchronize()
        reset_paged_counts()
        m = b.run(reqs)
        torch.cuda.synchronize()
        launches += pa.launches
        for r, n in pa.launches_by_route.items():
            by_route[r] += n
        return m, pa.launches, dict(pa.launches_by_route)

    def check_constrained(reqs, label):
        for r in reqs:
            if r.response_format is None:
                continue
            if r.finish_reason != "stop" or r.tokens[-1] != STRUCT_EOS \
                    or not conforms(r.response_format, schema_text(r.tokens)):
                raise AssertionError(f"{label} {r.request_id}: "
                                     f"{schema_text(r.tokens)!r} "
                                     f"({r.finish_reason}) does not conform")

    torch.cuda.reset_peak_memory_stats()
    reqs = structured_trace(cfg)
    m, n, routes = counted_run(batcher, reqs)
    # the run's masked share of the vocabulary, unrounded
    masked_frac = eng.structured_masked_sum / max(
        eng.structured_masked_rows, 1)
    check_constrained(reqs, "serve_structured")
    if n <= 0 or routes["sm90"] != n or eng.decode_compiles != 1:
        raise AssertionError(f"serve_structured: B4 {n} by route {routes}, "
                             f"{eng.decode_compiles} decode shapes")
    riders = [r for r in reqs if r.response_format is None]
    dense = dense_tokens(params, cfg, riders, dtype)
    rider_match = [r.tokens == d for r, d in zip(riders, dense)]
    if not all(rider_match):
        raise AssertionError(f"serve_structured: riders {rider_match} vs "
                             "dense generate")
    eng.tables.check()
    # the same prompts with structured off (the schema requests sent
    # unconstrained with the same budgets), in turns with it
    plain = ServingConfig(page_size=PS, n_pages=N_PAGES,
                          max_slots=SLOTS).make(params, cfg,
                                                compute_dtype=dtype)
    tok_s_on, tok_s_off = [m["decode_tok_s"]], []
    for turn in ("off", "on", "off"):
        if turn == "on":
            tok_s_on.append(counted_run(batcher, structured_trace(cfg))[0]
                            ["decode_tok_s"])
        else:
            tok_s_off.append(plain.run(structured_trace(
                cfg, constrained=False))["decode_tok_s"])
    want = {r.request_id: r.tokens for r in reqs}
    # speculative verify over the same trace
    spec = ServingConfig(**geo, speculative=True, draft_len=DRAFT_LEN).make(
        params, cfg, compute_dtype=dtype, on_recompile="raise")
    seng = spec.engine
    spec_reqs = structured_trace(cfg)
    sm, sn, sroutes = counted_run(spec, spec_reqs)
    check_constrained(spec_reqs, "serve_structured (speculative)")
    spec_match = {r.request_id: r.tokens == want[r.request_id]
                  for r in spec_reqs}
    if not all(spec_match[r.request_id] for r in spec_reqs
               if r.response_format is not None):
        raise AssertionError(f"serve_structured: speculative streams "
                             f"{spec_match} vs the plain structured run")
    if seng.verify_compiles != 1 or seng.decode_compiles != 0 \
            or sn != cfg.n_layers * seng.spec_steps \
            or sroutes["sm90"] != sn:
        raise AssertionError(
            f"serve_structured (speculative): {sn} B4 launches by route "
            f"{sroutes} over {seng.spec_steps} verify steps, "
            f"{seng.verify_compiles} verify shapes")
    seng.tables.check()
    # B4's device time a call inside the serving trace: decode (S = 1)
    # and verify (S = 5), each over one profiled replay
    us_s1 = paged_us_per_call(lambda: batcher.run(structured_trace(cfg)))
    us_s5 = paged_us_per_call(lambda: spec.run(structured_trace(cfg)))
    # one constrained n = 4 request on a parallel-sampling engine
    par = ServingConfig(**geo, parallel_sampling=True, temperature=0.8,
                        top_k=50).make(params, cfg, compute_dtype=dtype,
                                       on_recompile="raise")
    rf = library_response_format("verdict")
    fam = Request(prompt=np.random.RandomState(17).randint(
        0, cfg.vocab, 100).astype(np.int32),
        max_new_tokens=schema_budget("verdict"), eos_id=STRUCT_EOS,
        response_format=rf, n=STRUCT_N, best_of=STRUCT_N, seed=5)
    counted_run(par, [fam])
    check_constrained(fam.branches, "serve_structured (n = 4)")
    if len(fam.branches) != STRUCT_N or par.engine.decode_compiles != 1:
        raise AssertionError("serve_structured: the n = 4 family did not "
                             "fork or took more than one decode shape")
    par.engine.tables.check()
    texts = {r.request_id: schema_text(r.tokens) for r in reqs
             if r.response_format is not None}
    report["serve_structured"] = {
        "compile_ms": compile_ms, "metrics": m, "spec_metrics": sm,
        "masked_frac": masked_frac,
        "launches": launches, "launches_by_route": by_route,
        "rider_match": rider_match, "spec_match": spec_match,
        "texts": texts,
        "branch_texts": [schema_text(b.tokens) for b in fam.branches],
        "decode_tok_s_on": tok_s_on, "decode_tok_s_off": tok_s_off,
        "spec_decode_tok_s": sm["decode_tok_s"],
        "paged_us_per_call_s1": us_s1, "paged_us_per_call_s5": us_s5,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "card": smi}
    log(f"serve_structured: schema compile at vocab {cfg.vocab} "
        + ", ".join(f"{k} {v['ms']:.1f} ms ({v['states']} states)"
                    for k, v in compile_ms.items())
        + f"; 5/5 constrained completions conform and stop on EOS "
        f"{texts}; riders {sum(rider_match)}/{len(rider_match)} token-exact "
        f"vs dense generate; masked share {masked_frac!r}; "
        f"decode tok/s structured on {tok_s_on}, off {tok_s_off} (same "
        f"prompts and budgets, in turns); speculative (draft_len 4): "
        f"constrained streams equal the plain run's, "
        f"{seng.spec_steps} verify steps, B4 {sn} ({cfg.n_layers} a step) "
        f"by route {sroutes}, accept rate {sm['spec_accept_rate']}, decode "
        f"{sm['decode_tok_s']} tok/s; n = {STRUCT_N}: "
        f"{len(fam.branches)}/{STRUCT_N} branches conform "
        f"{[schema_text(b.tokens) for b in fam.branches]}; B4 device "
        f"{us_s1:.2f} µs a call at S = 1 and {us_s5:.2f} at S = 5 in the "
        f"profiled replays; B4 launches {launches} by route {by_route} "
        f"[{smi}]")
    return launches, by_route


def phase_serve_wq(params, cfg, smi: str, report: dict
                   ) -> tuple[int, dict, int]:
    """``weights: {dtype: int8}`` and ``{dtype: int4, group_size: 64}``
    at fp32 and bf16 on the serving trace: each quantized engine equals
    the dense ``generate`` over the same quantized tree, int8 at fp32
    equals the full-precision engine 8/8, one decode shape an arm; the
    int8-weights + ``cache_dtype: int8`` arm at bf16 puts every B4 launch
    on ``"sm90"`` over the int8 pool and equals the dense ``generate``
    with ``cache_dtype="int8"``. Returns B4's launches, by route, and
    the int8-pool launches."""
    from torchbooster_tpu_torch.config import ServingConfig, WeightsConfig
    from torchbooster_tpu_torch.models.gpt import cast_params, generate
    from torchbooster_tpu_torch.models.quant import (quantize_params,
                                                     weight_stream_bytes)
    from torchbooster_tpu_torch.ops import paged_attention as pa

    launches, by_route = 0, dict.fromkeys(pa.launches_by_route, 0)
    arms, streams = {}, {}
    int8_pool = 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = "fp32" if dtype == torch.float32 else "bf16"
        want = "simt" if dtype == torch.float32 else "sm90"
        for wname, kv in (("full", ""), ("int8", ""), ("int4", ""),
                          ("int8", "int8")):
            if kv and dtype == torch.float32:
                continue
            weights = WeightsConfig(dtype="bf16" if wname == "full"
                                    else wname, group_size=WQ_GROUP)
            batcher = ServingConfig(
                page_size=PS, n_pages=N_PAGES, max_slots=SLOTS,
                cache_dtype=kv, weights=weights).make(
                params, cfg, compute_dtype=dtype, on_recompile="raise")
            reqs = requests(cfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_paged_counts()
            m = batcher.run(reqs)
            torch.cuda.synchronize()
            n, routes = pa.launches, dict(pa.launches_by_route)
            peak = torch.cuda.max_memory_allocated()
            launches += n
            for r, c in routes.items():
                by_route[r] += c
            key = f"{dname}_{wname}" + (f"_kv{kv}" if kv else "")
            if n <= 0 or routes[want] != n \
                    or batcher.engine.decode_compiles != 1:
                raise AssertionError(f"serve_wq {key}: B4 {n} by route "
                                     f"{routes}, "
                                     f"{batcher.engine.decode_compiles} "
                                     "decode shapes")
            if kv:
                int8_pool += n
            tree = batcher.engine.params if wname == "full" else \
                quantize_params(params, wname, group_size=WQ_GROUP)
            dense = []
            for r in reqs:
                ids = torch.as_tensor(r.prompt, device="cuda").long()[None]
                dense.append(generate(
                    tree, ids, cfg, n_new=N_NEW, temperature=0.0,
                    compute_dtype=dtype, cache_dtype=kv or None)[
                        0, len(r.prompt):].tolist())
            match = [r.tokens == d for r, d in zip(reqs, dense)]
            if not all(match):
                raise AssertionError(f"serve_wq {key}: {match} vs dense "
                                     "generate over the same tree")
            streams[key] = [r.tokens for r in reqs]
            arms[key] = {"decode_tok_s": m["decode_tok_s"],
                         "ttft_p50_s": m["ttft_p50_s"], "peak_mem_bytes": peak,
                         "launches": n, "launches_by_route": routes,
                         "dense_match": match}
            batcher.engine.tables.check()
            del batcher
            torch.cuda.empty_cache()
    vs_full = {k: sum(a == b for a, b in zip(v, streams[
        "fp32_full" if k.startswith("fp32") else "bf16_full"]))
        for k, v in streams.items() if "full" not in k}
    if vs_full["fp32_int8"] != len(PROMPT_LENS):
        raise AssertionError(f"serve_wq: int8 matches the full-precision "
                             f"engine on {vs_full['fp32_int8']}/8 requests "
                             "at fp32")
    stream_bytes = {"bf16": weight_stream_bytes(cast_params(
        params, torch.bfloat16))}
    for w in ("int8", "int4"):
        stream_bytes[w] = weight_stream_bytes(quantize_params(
            params, w, group_size=WQ_GROUP))
    report["serve_wq"] = {"arms": arms, "match_vs_full": vs_full,
                          "weight_stream_bytes": stream_bytes,
                          "launches": launches, "launches_by_route": by_route,
                          "int8_pool_launches": int8_pool, "card": smi}
    log(f"serve_wq: every arm token-exact vs dense generate over its own "
        f"tree (8/8), int8 8/8 vs the full-precision engine at fp32; "
        f"matches vs the full-precision stream {vs_full}; weight stream "
        f"bytes {stream_bytes}; decode tok/s "
        + ", ".join(f"{k} {a['decode_tok_s']}" for k, a in arms.items())
        + "; peak MiB "
        + ", ".join(f"{k} {a['peak_mem_bytes'] / 2**20:.1f}"
                    for k, a in arms.items())
        + f"; B4 launches {launches} by route {by_route}, {int8_pool} of "
        f"them over the int8 pool on \"sm90\" [{smi}]")
    return launches, by_route, int8_pool


def merged_params(params: dict, adapter: dict) -> dict:
    """The dense model an adapter defines: ``W_qkv + A_q B_q`` and
    ``W_proj + A_p B_p`` per layer (fp32)."""
    def t(a):
        return torch.as_tensor(a, device="cuda")

    blocks = dict(params["blocks"])
    for name, a, b in (("attn_qkv", "a_qkv", "b_qkv"),
                       ("attn_proj", "a_proj", "b_proj")):
        blocks[name] = {**blocks[name], "kernel": blocks[name]["kernel"]
                        + t(adapter[a]) @ t(adapter[b])}
    return {**params, "blocks": blocks}


def phase_serve_lora(params, cfg, smi: str, report: dict
                     ) -> tuple[int, dict]:
    """``adapters: {rank: 8, max_live: 4}`` with six adapters on eight
    requests (two base): seating waits on lanes and evicts. Base riders
    equal the LoRA-off engine at bf16 and fp32, each adapter request at
    fp32 equals the dense ``generate`` over its merged weights; one
    decode shape, one lane-writer shape, no pin left, tables consistent,
    B4 on its planned route."""
    from torchbooster_tpu_torch.config import AdaptersConfig, ServingConfig
    from torchbooster_tpu_torch.ops import paged_attention as pa
    from torchbooster_tpu_torch.serving import Request, random_adapter

    adapters = {f"a{i}": random_adapter(i, cfg, LORA_RANK, std=LORA_STD)
                for i in range(1, LORA_ADAPTERS + 1)}
    names = ["", "a1", "a2", "a3", "", "a4", "a5", "a6"]
    launches, by_route = 0, dict.fromkeys(pa.launches_by_route, 0)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = "fp32" if dtype == torch.float32 else "bf16"
        want = "simt" if dtype == torch.float32 else "sm90"
        conf = dict(page_size=PS, n_pages=N_PAGES, max_slots=SLOTS)
        lora = ServingConfig(**conf, adapters=AdaptersConfig(
            rank=LORA_RANK, max_live=LORA_LIVE)).make(
            params, cfg, compute_dtype=dtype, on_recompile="raise")
        eng = lora.engine
        for name, w in adapters.items():
            eng.adapters.register(name, w)
        reqs = [Request(prompt=r.prompt, max_new_tokens=N_NEW, adapter=a,
                        request_id=f"{a or 'base'}{i}")
                for i, (r, a) in enumerate(zip(requests(cfg), names))]
        torch.cuda.synchronize()
        reset_paged_counts()
        m = lora.run(reqs)
        torch.cuda.synchronize()
        n, routes = pa.launches, dict(pa.launches_by_route)
        launches += n
        for r, c in routes.items():
            by_route[r] += c
        if n <= 0 or routes[want] != n:
            raise AssertionError(f"serve_lora {dname}: B4 {n} by route "
                                 f"{routes}")
        if eng.decode_compiles != 1 or eng.lora_load_compiles != 1 \
                or eng.adapters.pinned_count != 0 \
                or eng.adapters.evictions <= 0:
            raise AssertionError(
                f"serve_lora {dname}: {eng.decode_compiles} decode shapes, "
                f"{eng.lora_load_compiles} writer shapes, "
                f"{eng.adapters.pinned_count} pins left, "
                f"{eng.adapters.evictions} evictions")
        eng.tables.check()
        off = ServingConfig(**conf).make(params, cfg, compute_dtype=dtype,
                                         on_recompile="raise")
        base = [Request(prompt=r.prompt, max_new_tokens=N_NEW)
                for r in reqs]
        m_off = off.run(base)
        base_match = [r.tokens == b.tokens for r, b in zip(reqs, base)
                      if not r.adapter]
        steered = [r.tokens != b.tokens for r, b in zip(reqs, base)
                   if r.adapter]
        if not all(base_match):
            raise AssertionError(f"serve_lora {dname}: base riders "
                                 f"{base_match} vs the LoRA-off engine")
        if not all(steered):
            raise AssertionError(f"serve_lora {dname}: adapters {steered} "
                                 "did not change their streams")
        merged_match = None
        if dtype == torch.float32:
            merged_match = []
            for r in reqs:
                if not r.adapter:
                    continue
                dense = dense_tokens(merged_params(params, adapters[
                    r.adapter]), cfg, [r], dtype)[0]
                merged_match.append(r.tokens == dense)
            if not all(merged_match):
                raise AssertionError(f"serve_lora fp32: adapters "
                                     f"{merged_match} vs dense generate "
                                     "over the merged weights")
        out[dname] = {"metrics": m, "off_decode_tok_s": m_off["decode_tok_s"],
                      "launches": n, "launches_by_route": routes,
                      "base_match": base_match, "steered": steered,
                      "merged_match": merged_match,
                      "registry": eng.adapters.debug()}
        log(f"serve_lora {dname}: base riders {sum(base_match)}/"
            f"{len(base_match)} equal the LoRA-off engine, "
            f"{sum(steered)}/{len(steered)} adapters steer"
            + (f", {sum(merged_match)}/{len(merged_match)} equal dense "
               "generate over merged weights" if merged_match else "")
            + f"; loads {m['n_adapter_loads']}, evictions "
            f"{m['n_adapter_evictions']}, hits {m['n_adapter_hits']}, per "
            f"adapter {m['adapters']}; decode {m['decode_tok_s']} tok/s with "
            f"LoRA, {m_off['decode_tok_s']} without (same prompts); B4 {n} "
            f"by route {routes} [{smi}]")
        del lora, off
        torch.cuda.empty_cache()
    report["serve_lora"] = {**out, "launches": launches,
                            "launches_by_route": by_route, "card": smi}
    return launches, by_route


# --------------------------------------- host spill tier, disaggregation
SPILL_PREFIX_PAGES = 8     # the probe's shared prefix, in 64-token pages
SPILL_TAIL = 16            # its own tail tokens
SPILL_REPEATS = 5          # probes a tier, each with its own prefix
SPILL_N_PAGES = 33         # a pool the churn overflows (32 usable pages)
SPILL_BUDGET_MB = 256.0
DISAGG_LENS = (640, 64, 800, 96, 128, 960, 160, 192)   # 3 long, 5 short
DISAGG_MIN_PAGES = 4


def n_params_of(params) -> int:
    from torchbooster_tpu_torch.utils import tree_leaves

    return sum(int(p.numel()) for p in tree_leaves(params))


def warm_up(batcher, cfg) -> None:
    """One short request before a timed run, so that first-use costs
    (cuBLAS handles, the kernels' build) fall outside it."""
    from torchbooster_tpu_torch.serving import Request

    prompt = np.random.RandomState(99).randint(0, cfg.vocab, 2 * PS + 5)
    batcher.run([Request(prompt=prompt.astype(np.int32), max_new_tokens=4)])
    torch.cuda.synchronize()


def spill_probe(eng, prompt, n_new: int) -> dict:
    """One request driven through the engine alone: seat, promote (timed
    and synchronized on its own), prefill to the first token (the TTFT:
    seat to first token on the host), then decode to ``n_new``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slot = eng.admit_begin(prompt)
    if slot is None:
        raise AssertionError("serve_spill: the probe did not seat")
    b0 = eng.promoted_bytes
    tp = time.perf_counter()
    n_prom = eng.issue_promotions()
    torch.cuda.synchronize()
    prom_s = time.perf_counter() - tp
    while True:
        done = eng.prefill_step()
        if done is not None and done[0] == slot:
            break
    ttft = time.perf_counter() - t0
    toks = [done[1]]
    for _ in range(n_new - 1):
        if eng.grow_slots():
            raise AssertionError("serve_spill: the probe starved for pages")
        toks.append(int(eng.step()[slot]))
    eng.retire(slot)
    return {"tokens": toks, "ttft_s": ttft, "promoted": n_prom,
            "promote_s": prom_s, "promoted_bytes": eng.promoted_bytes - b0}


def spill_churn(batcher, rs, keys, cfg) -> int:
    """Serve rounds of eight distinct 2-4-page prompts until every probe
    key has left the HBM index for the host pool; returns the rounds."""
    from torchbooster_tpu_torch.serving import Request

    tables = batcher.engine.tables
    for rounds in range(1, 41):
        batcher.run([Request(prompt=rs.randint(0, cfg.vocab, int(
            rs.randint(2, 5)) * PS - int(rs.randint(0, 8))).astype(np.int32),
            max_new_tokens=2) for _ in range(SLOTS)])
        if all(k in tables.host_pool and k not in tables._index
               for k in keys):
            return rounds
    raise AssertionError("serve_spill: churn never demoted the probe prefix")


def phase_serve_spill(params, cfg, smi: str, report: dict
                      ) -> tuple[int, dict, int]:
    """The host spill tier at GPT-2 small width: per arm (bf16 over an
    int8 pool, B4 on ``"sm90"``; fp32 over a wide pool, ``"simt"``), five
    probes of an 8-page prefix + 16 tokens, each served cold, as an HBM
    prefix hit and, after churn has demoted its 8 pages, as a host hit
    whose 8 pages promote through 4-lane staging (two groups back to
    back). Every stream equals the dense ``generate`` at the pool's cache
    dtype; one decode and one promotion shape; promoted bytes equal
    ``promotion_traffic``; tables consistent. Returns B4's launches, by
    route, and those over the int8 pool."""
    from torchbooster_tpu_torch.comms.accounting import (promotion_traffic,
                                                         spill_breakeven)
    from torchbooster_tpu_torch.config import HostSpillConfig, ServingConfig
    from torchbooster_tpu_torch.models.gpt import generate
    from torchbooster_tpu_torch.ops import paged_attention as pa

    launches, by_route = 0, dict.fromkeys(pa.launches_by_route, 0)
    int8_pool, arms = 0, {}
    n_par = n_params_of(params)
    for dname, dtype, kv, want in (("bf16_int8", torch.bfloat16, "int8",
                                    "sm90"),
                                   ("fp32_wide", torch.float32, "", "simt")):
        batcher = ServingConfig(
            page_size=PS, n_pages=SPILL_N_PAGES, max_slots=SLOTS,
            cache_dtype=kv, prefix_cache=True,
            host_spill=HostSpillConfig(enabled=True,
                                       budget_mb=SPILL_BUDGET_MB)).make(
            params, cfg, compute_dtype=dtype, on_recompile="raise")
        eng = batcher.engine
        rs = np.random.RandomState(7)
        warm_up(batcher, cfg)
        probes = [np.concatenate([
            rs.randint(0, cfg.vocab, SPILL_PREFIX_PAGES * PS),
            rs.randint(0, cfg.vocab, SPILL_TAIL)]).astype(np.int32)
            for _ in range(SPILL_REPEATS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_paged_counts()
        runs = {"cold": [], "hbm": [], "host": []}
        rounds = []
        for probe in probes:
            keys = [probe[:(i + 1) * PS].tobytes()
                    for i in range(SPILL_PREFIX_PAGES)]
            runs["cold"].append(spill_probe(eng, probe, N_NEW))
            runs["hbm"].append(spill_probe(eng, probe, N_NEW))
            rounds.append(spill_churn(batcher, rs, keys, cfg))
            runs["host"].append(spill_probe(eng, probe, N_NEW))
        torch.cuda.synchronize()
        n, routes = pa.launches, dict(pa.launches_by_route)
        peak = torch.cuda.max_memory_allocated()
        launches += n
        for r, c in routes.items():
            by_route[r] += c
        if kv:
            int8_pool += n
        if n <= 0 or routes[want] != n:
            raise AssertionError(f"serve_spill {dname}: B4 {n} by route "
                                 f"{routes}, not all {want!r}")
        dense = []
        for probe in probes:
            ids = torch.as_tensor(probe, device="cuda").long()[None]
            dense.append(generate(params, ids, cfg, n_new=N_NEW,
                                  temperature=0.0, compute_dtype=dtype,
                                  cache_dtype=kv or None)[
                0, len(probe):].tolist())
        match = {tier: [r["tokens"] == d for r, d in zip(rs_, dense)]
                 for tier, rs_ in runs.items()}
        if not all(all(v) for v in match.values()):
            raise AssertionError(f"serve_spill {dname}: streams vs dense "
                                 f"generate {match}")
        if any(r["promoted"] != SPILL_PREFIX_PAGES for r in runs["host"]) \
                or any(r["promoted"] for r in runs["cold"] + runs["hbm"]):
            raise AssertionError(f"serve_spill {dname}: promoted pages "
                                 + str({t: [r["promoted"] for r in v]
                                        for t, v in runs.items()}))
        lanes = eng._promote_lanes
        groups = -(-SPILL_PREFIX_PAGES // lanes)
        if groups < 2:
            raise AssertionError(f"serve_spill {dname}: {lanes} lanes take "
                                 "the probe's pages in one group")
        model = promotion_traffic(eng.promotions, page_size=PS,
                                  kv_heads=cfg.kv_heads, head_dim=cfg.head_dim,
                                  n_layers=cfg.n_layers)
        if eng.promoted_bytes != model["total_bytes"]:
            raise AssertionError(f"serve_spill {dname}: promoted "
                                 f"{eng.promoted_bytes} bytes, model "
                                 f"{model['total_bytes']}")
        if eng.promote_compiles != 1 or eng.decode_compiles != 1:
            raise AssertionError(f"serve_spill {dname}: "
                                 f"{eng.promote_compiles} promotion and "
                                 f"{eng.decode_compiles} decode shapes")
        eng.tables.check()
        gbs = [r["promoted_bytes"] / r["promote_s"] / 1e9
               for r in runs["host"]]
        flops = (BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS) / 1e12
        be = spill_breakeven(n_params=n_par, page_size=PS,
                             per_page_bytes=model["per_page_bytes"],
                             h2d_gbs=float(np.median(gbs)),
                             flops_tps=flops, n_pages=SPILL_PREFIX_PAGES)
        ttft = {t: [r["ttft_s"] for r in v] for t, v in runs.items()}
        stats = eng.debug_stats()
        arms[dname] = {
            "ttft_s": ttft, "promote_s": [r["promote_s"] for r in runs["host"]],
            "promotion_gbs": gbs, "lanes": lanes, "groups_per_seat": groups,
            "churn_rounds": rounds, "spills": eng.spills,
            "promotions": eng.promotions, "host_hit_pages": eng.host_hit_pages,
            "promoted_bytes": eng.promoted_bytes,
            "per_page_bytes": model["per_page_bytes"],
            "host_bytes_used": stats["host_bytes_used"],
            "host_evictions": stats["host_evictions"], "peak_mem_bytes": peak,
            "breakeven": be, "launches": n, "launches_by_route": routes,
            "match": match}
        med = {t: float(np.median(v)) * 1e3 for t, v in ttft.items()}
        log(f"serve_spill {dname}: 5 probes x cold/HBM/host token-exact vs "
            f"dense generate (cache {kv or 'wide'}); TTFT ms median cold "
            f"{med['cold']:.2f}, HBM hit {med['hbm']:.2f}, host hit "
            f"{med['host']:.2f} (each "
            + ", ".join(f"{t} " + "/".join(f"{x * 1e3:.2f}" for x in v)
                        for t, v in ttft.items())
            + f"); promotion {SPILL_PREFIX_PAGES} pages in {groups} groups of "
            f"{lanes} lanes, GB/s " + "/".join(f"{g:.2f}" for g in gbs)
            + f"; spills {eng.spills}, promotions {eng.promotions}, host "
            f"hits {eng.host_hit_pages}, promoted bytes {eng.promoted_bytes} "
            f"== promotion_traffic; breakeven {be['breakeven_pages']:.3g} "
            f"pages (host {be['host_s_per_page'] * 1e6:.1f} us/page, "
            f"recompute {be['recompute_s_per_page'] * 1e6:.1f} us/page at "
            f"{flops:.0f} TFLOP/s); peak {peak / 2**20:.1f} MiB; one decode "
            f"and one promotion shape; B4 {n} by route {routes} [{smi}]")
        del batcher, eng
        torch.cuda.empty_cache()
    report["serve_spill"] = {**arms, "launches": launches,
                             "launches_by_route": by_route,
                             "int8_pool_launches": int8_pool, "card": smi}
    return launches, by_route, int8_pool


def pump(srv, reqs) -> tuple[dict, float]:
    """Drive a batcher or a ``DisaggPair`` over requests arriving at 0
    until it drains; returns the metrics and the wall seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.start_session()
    for r in reqs:
        srv.submit(r, arrival=0.0)
    deadline = t0 + 300
    while srv.has_work:
        if time.perf_counter() > deadline:
            raise AssertionError("the serving pump did not drain")
        srv.step()
        decode = getattr(srv, "decode", None)
        if decode is not None and not decode.has_work:
            time.sleep(0.0005)       # only the prefill worker has work
    m = srv.finish_session()
    torch.cuda.synchronize()
    return m, time.perf_counter() - t0


def pool_bytes(eng) -> int:
    return sum(a.numel() * a.element_size()
               for half in (eng.pool["k"], eng.pool["v"])
               for a in (half if isinstance(half, tuple) else (half,)))


def phase_serve_disagg(params, cfg, smi: str, report: dict
                       ) -> tuple[int, dict, int]:
    """``disagg: {enabled: true, min_prefill_pages: 4}`` over an int8
    pool at bf16 with the spill tier: eight requests at 0 (three of
    640-960 tokens through the prefill engine, five of 64-192 straight to
    decode), 32 new tokens each, beside the same trace through the
    unified batcher in the same call. Every stream equals the unified
    run's; streamed payload bytes equal ``disagg_traffic``; one decode,
    prefill and promotion shape on the decode engine, none decoded on the
    prefill engine; every B4 launch ``"sm90"`` over the int8 pool."""
    from torchbooster_tpu_torch.comms.accounting import disagg_traffic
    from torchbooster_tpu_torch.config import (DisaggConfig, HostSpillConfig,
                                               ServingConfig)
    from torchbooster_tpu_torch.ops import paged_attention as pa
    from torchbooster_tpu_torch.serving import DisaggPair, Request

    rs = np.random.RandomState(11)
    prompts = [rs.randint(0, cfg.vocab, n).astype(np.int32)
               for n in DISAGG_LENS]
    longs = [i for i, n in enumerate(DISAGG_LENS)
             if (n - 1) // PS >= DISAGG_MIN_PAGES]
    launches, by_route = 0, dict.fromkeys(pa.launches_by_route, 0)
    out, streams = {}, {}
    warm_up(ServingConfig(page_size=PS, n_pages=N_PAGES, max_slots=SLOTS,
                          cache_dtype="int8").make(
        params, cfg, compute_dtype=torch.bfloat16), cfg)
    for arm in ("off", "on"):
        conf = ServingConfig(
            page_size=PS, n_pages=N_PAGES, max_slots=SLOTS,
            cache_dtype="int8", prefix_cache=True,
            host_spill=HostSpillConfig(enabled=True,
                                       budget_mb=SPILL_BUDGET_MB),
            disagg=DisaggConfig(enabled=arm == "on",
                                min_prefill_pages=DISAGG_MIN_PAGES))
        srv = conf.make(params, cfg, compute_dtype=torch.bfloat16,
                        on_recompile="raise")
        if (arm == "on") != isinstance(srv, DisaggPair):
            raise AssertionError(f"serve_disagg {arm}: make built "
                                 f"{type(srv).__name__}")
        reqs = [Request(prompt=p, max_new_tokens=N_NEW, request_id=f"d{i}")
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_paged_counts()
        m, wall = pump(srv, reqs)
        n, routes = pa.launches, dict(pa.launches_by_route)
        launches += n
        for r, c in routes.items():
            by_route[r] += c
        if n <= 0 or routes["sm90"] != n:
            raise AssertionError(f"serve_disagg {arm}: B4 {n} by route "
                                 f"{routes}, not all \"sm90\"")
        dec = srv.decode.engine if arm == "on" else srv.engine
        if dec.decode_compiles != 1 or dec.prefill_compiles != 1:
            raise AssertionError(f"serve_disagg {arm}: decode engine "
                                 f"{dec.decode_compiles} decode, "
                                 f"{dec.prefill_compiles} prefill shapes")
        ttft = [r.first_token_at - r.arrival for r in reqs]
        res = {"metrics": m, "wall_s": wall, "launches": n,
               "launches_by_route": routes,
               "ttft_long_p50_s": float(np.median([ttft[i] for i in longs])),
               "ttft_short_p50_s": float(np.median(
                   [t for i, t in enumerate(ttft) if i not in longs])),
               "ttft_s": ttft, "peak_mem_bytes":
                   torch.cuda.max_memory_allocated(),
               "decode_pool_bytes": pool_bytes(dec)}
        if arm == "on":
            d = m["disagg"]
            want_bytes = sum(disagg_traffic(
                DISAGG_LENS[i], page_size=PS, kv_heads=cfg.kv_heads,
                head_dim=cfg.head_dim, n_layers=cfg.n_layers)["total_bytes"]
                for i in longs)
            want_pages = sum((DISAGG_LENS[i] - 1) // PS for i in longs)
            if (d["page_bytes_streamed"], d["pages_streamed"],
                    d["stranded"], d["prefill_requests"]) \
                    != (want_bytes, want_pages, 0, len(longs)):
                raise AssertionError(f"serve_disagg: stream {d} vs "
                                     f"{want_bytes} bytes, {want_pages} "
                                     f"pages over {len(longs)} requests")
            if dec.promote_compiles != 1 or srv.prefill.decode_compiles \
                    or srv.prefill.prefill_compiles != 1:
                raise AssertionError(
                    f"serve_disagg: decode engine {dec.promote_compiles} "
                    f"promotion shapes, prefill engine "
                    f"{srv.prefill.decode_compiles} decode and "
                    f"{srv.prefill.prefill_compiles} prefill shapes")
            res["disagg"] = d
            res["prefill_pool_bytes"] = pool_bytes(srv.prefill)
            res["promotions"] = dec.promotions
        dec.tables.check()
        streams[arm] = [r.tokens for r in reqs]
        out[arm] = res
        del srv, dec
        torch.cuda.empty_cache()
    match = [a == b for a, b in zip(streams["off"], streams["on"])]
    if not all(match) or any(len(t) != N_NEW for t in streams["on"]):
        raise AssertionError(f"serve_disagg: disaggregated streams vs the "
                             f"unified batcher's {match}")
    on, off = out["on"], out["off"]
    d = on["disagg"]
    log(f"serve_disagg: 8/8 streams equal the unified batcher's; "
        f"{d['prefill_requests']} long prompts streamed {d['pages_streamed']} "
        f"pages, {d['page_bytes_streamed']} payload bytes == disagg_traffic, "
        f"{d['framed_bytes_streamed']} framed; p50 TTFT short "
        f"{on['ttft_short_p50_s'] * 1e3:.1f} ms on / "
        f"{off['ttft_short_p50_s'] * 1e3:.1f} ms off, long "
        f"{on['ttft_long_p50_s'] * 1e3:.1f} / "
        f"{off['ttft_long_p50_s'] * 1e3:.1f} ms; decode tok/s "
        f"{on['metrics']['decode_tok_s']} on / "
        f"{off['metrics']['decode_tok_s']} off; pools decode "
        f"{on['decode_pool_bytes'] / 2**20:.1f} + prefill "
        f"{on['prefill_pool_bytes'] / 2**20:.1f} MiB (unified "
        f"{off['decode_pool_bytes'] / 2**20:.1f}), peak "
        f"{on['peak_mem_bytes'] / 2**20:.1f} / "
        f"{off['peak_mem_bytes'] / 2**20:.1f} MiB; decode engine one decode, "
        f"prefill and promotion shape, prefill engine no decode; B4 "
        f"{launches} by route {by_route}, all over the int8 pool [{smi}]")
    report["serve_disagg"] = {**out, "match": match, "launches": launches,
                              "launches_by_route": by_route, "card": smi}
    return launches, by_route, launches


# ----------------------------------------------------------------- train
TRAIN_STEPS = 20
TRAIN_B, TRAIN_S = 8, 1024


def gpt2_train_config(n_iter: int, precision: str = "bf16",
                      sample_tokens: int = 32):
    """``examples/lm/gpt/gpt.yml``'s values built in code (the card's
    machine reads no YAML), with the model block at GPT-2-small width
    (chunked LM head), batch 8 x 1024, ``n_iter`` steps, a 2-step warmup
    so that the loss moves, and a log record every step."""
    from torchbooster_tpu_torch.config import (
        DatasetConfig,
        EnvConfig,
        LoaderConfig,
        OptimizerConfig,
        SchedulerConfig,
    )
    from torchbooster_tpu_torch.recipes.gpt import Config, ModelConfig

    return Config(
        n_iter=n_iter, seed=42, clip=1.0, accumulate_every=1, log_every=1,
        save_every=0, checkpoint_root="checkpoints",
        model=ModelConfig(vocab=50257, n_layers=12, d_model=768,
                          n_heads=12, seq_len=TRAIN_S, remat=True,
                          chunked_head=True),
        env=EnvConfig(distributed=False, precision=precision, mesh="dp"),
        loader=LoaderConfig(batch_size=TRAIN_B, num_workers=0,
                            drop_last=True),
        optim=OptimizerConfig(name="adamw", lr=3e-4, weight_decay=0.1,
                              betas=(0.9, 0.95)),
        scheduler=SchedulerConfig(name="cycle", n_iter=n_iter, warmup=2,
                                  decay=("lin", "cos")),
        dataset=DatasetConfig(name="synthetic_lm", root="dataset/lm"),
        sample_tokens=sample_tokens, sample_temperature=0.8)


def model_flops_per_step(cfg) -> float:
    """6 x parameters x tokens for the matmuls (the tied head counted
    once, the wpe lookup not at all) plus causal attention's two
    products, 6 L S d per token over forward and backward. The remat
    recompute is not counted."""
    d, n_l = cfg.d_model, cfg.n_layers
    n_params = cfg.vocab * d + n_l * (12 * d * d + 13 * d) + 2 * d
    tokens = TRAIN_B * TRAIN_S
    return 6.0 * n_params * tokens + 6.0 * n_l * TRAIN_S * d * tokens


def flash_vs_reference_fp32() -> dict:
    """One fp32 forward + backward of the recipe's loss from the same
    parameters and batch, attention through the flash kernels and
    through ``mha_reference``: loss and gradient norm must agree."""
    from torchbooster_tpu_torch.models.gpt import GPT
    from torchbooster_tpu_torch.ops.losses import lm_head_cross_entropy
    from torchbooster_tpu_torch.recipes import gpt as recipe
    from torchbooster_tpu_torch.utils import tree_leaves

    t = recipe.setup(gpt2_train_config(1, "fp32"))
    batch = t.batch(next(t.batches)[1])
    out = {}
    for impl in ("flash", "reference"):
        hidden = GPT.apply(t.state.params, batch["ids"], t.cfg,
                           compute_dtype=torch.float32, remat=True,
                           attn_impl=impl, return_hidden=True)
        loss = lm_head_cross_entropy(hidden, GPT.head_table(t.state.params),
                                     batch["labels"])
        loss.backward()
        leaves = tree_leaves(t.state.params)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad) for p in leaves])).item()
        out[impl] = {"loss": loss.item(), "grad_norm": norm}
        for p in leaves:
            p.grad = None
    # both sides are fp32 throughout; they differ in the order of the
    # attention sums (online softmax over 64-key tiles against one
    # softmax over the row), worth ~1e-6 relative per layer
    tol = 1e-4
    for key in ("loss", "grad_norm"):
        a, b = out["flash"][key], out["reference"][key]
        if not (math.isfinite(a) and abs(a - b) <= tol * abs(b)):
            raise AssertionError(f"fp32 step: flash {key} {a} vs reference "
                                 f"{b} (rtol {tol})")
    out["rtol"] = tol
    log(f"train fp32 flash vs reference: loss {out['flash']['loss']:.6f} / "
        f"{out['reference']['loss']:.6f}, grad norm "
        f"{out['flash']['grad_norm']:.6f} / "
        f"{out['reference']['grad_norm']:.6f} (rtol {tol})")
    return out


def train_breakdown(n_steps: int = 3) -> dict:
    """A fresh bf16 trainer: two warm steps, then ``n_steps`` under the
    profiler (CUDA activity): device busy share of the wall time, kernels
    per step, the flash kernels' share of device time, and the top
    kernels; then one step with host activity traced, for the host ops
    that take the most CPU time."""
    from torch.profiler import ProfilerActivity, profile

    from torchbooster_tpu_torch.recipes import gpt as recipe

    t = recipe.setup(gpt2_train_config(n_steps + 2, sample_tokens=0))
    for _ in range(2):
        t.state, m = t.step(t.state, t.batch(next(t.batches)[1]))
    m["loss"].item()
    batches = [t.batch(next(t.batches)[1]) for _ in range(n_steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            t.state, m = t.step(t.state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    per_kernel = sorted(((e.key, e.self_device_time_total / 1e6)
                         for e in events), key=lambda kv: -kv[1])
    busy = sum(v for _, v in per_kernel)
    flash = sum(v for k, v in per_kernel if "::flash_" in k)
    # one more step with host (CPU) activity traced, apart from the timed
    # ones because the tracing slows the host: where the host time goes
    batch = t.batch(next(t.batches)[1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as host_prof:
        t.state, m = t.step(t.state, batch)
        torch.cuda.synchronize()
    host_ops = sorted(((e.key, e.self_cpu_time_total / 1e6, e.count)
                       for e in host_prof.key_averages()),
                      key=lambda kv: -kv[1])
    return {"steps": n_steps, "wall_s": wall, "step_ms": wall / n_steps * 1e3,
            "device_busy_s": busy, "device_busy_share": busy / wall,
            "device_ms_per_step": busy / n_steps * 1e3, "flash_s": flash,
            "flash_share_of_device": flash / max(busy, 1e-12),
            "kernels_per_step": sum(e.count for e in events) / n_steps,
            "top": per_kernel[:10], "host_top_one_step": host_ops[:12]}


def phase_train(report: dict, smi: str) -> dict:
    """The recipe's ``main`` at GPT-2-small width on the card; returns
    the flash kernels' launch counts from this run."""
    from torchbooster_tpu_torch.ops import flash_attention as fa
    from torchbooster_tpu_torch.recipes import gpt as recipe

    conf = gpt2_train_config(TRAIN_STEPS)
    cfg = conf.model.make()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    t0 = time.perf_counter()
    res = recipe.main(conf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwd": fa.launches_fwd, "dq": fa.launches_dq,
                "dkv": fa.launches_dkv}
    by_route = {"fwd": dict(fa.launches_fwd_by_route),
                "dq": dict(fa.launches_dq_by_route),
                "dkv": dict(fa.launches_dkv_by_route)}
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in res["log"]]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    n_l = cfg.n_layers
    # remat runs each block's forward twice per step; the sample's
    # prefill adds one forward per layer
    expected = {"fwd": 2 * n_l * TRAIN_STEPS + n_l,
                "dq": n_l * TRAIN_STEPS, "dkv": n_l * TRAIN_STEPS}
    if launches != expected:
        raise AssertionError(f"train: flash launches {launches}, expected "
                             f"{expected}")
    # bf16, D 64, S 1024: every B1-B3 launch on the wgmma kernels
    route_expected = {key: {"sm90": expected[key], "mma_sync": 0, "f32": 0}
                      for key in ("fwd", "dq", "dkv")}
    if by_route != route_expected:
        raise AssertionError(f"train: B1-B3 routes {by_route}, expected "
                             f"{route_expected}")
    # steady state: from the end of step 5 to the end of the last step
    el = [r["elapsed_s"] for r in res["log"]]
    warm = 5
    step_s = (el[-1] - el[warm - 1]) / (TRAIN_STEPS - warm)
    flops = model_flops_per_step(cfg)
    out = {"losses": losses, "launches": launches, "expected": expected,
           "by_route": by_route, "main_wall_s": wall, "step_ms": step_s * 1e3,
           "tokens_per_s": TRAIN_B * TRAIN_S / step_s,
           "model_flops_per_step": flops,
           "mfu_of_989_tflops": flops / step_s / BF16_FLOPS,
           "peak_mem_bytes": peak, "sample_len": len(res.get("sample", [])),
           "card": smi}
    log(f"train: GPT-2 small, batch {TRAIN_B} x {TRAIN_S}, {TRAIN_STEPS} "
        f"steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; step "
        f"{out['step_ms']:.1f} ms, {out['tokens_per_s']:.0f} tokens/s, "
        f"model FLOP share {100 * out['mfu_of_989_tflops']:.2f}% of 989 "
        f"TFLOP/s, peak mem {peak / 2**30:.2f} GiB; flash launches "
        f"{launches}, B1-B3 by route {by_route} [{smi}]")
    out["fp32_flash_vs_reference"] = flash_vs_reference_fp32()
    torch.cuda.empty_cache()
    b = out["breakdown"] = train_breakdown()
    log(f"train profiled: {b['steps']} steps, wall {b['wall_s']:.3f} s "
        f"({b['step_ms']:.1f} ms/step), device {b['device_ms_per_step']:.1f} "
        f"ms/step, busy {100 * b['device_busy_share']:.1f}%, "
        f"{b['kernels_per_step']:.0f} kernels per step, flash kernels "
        f"{100 * b['flash_share_of_device']:.1f}% of device time; top: "
        + "; ".join(f"{k[:60]} {v * 1e3:.1f} ms" for k, v in b["top"][:5]))
    log("train host, one traced step (self CPU ms, calls): " + "; ".join(
        f"{k[:40]} {v * 1e3:.1f} ({n})"
        for k, v, n in b["host_top_one_step"][:8]))
    report["train"] = out
    return {**launches, "by_route": by_route}


# ----------------------------------------------------------- gpt2_import
GPT2_STEPS = 8
# each optimizer's learning rate for the fine-tune (the cycle schedule's
# peak, a 2-step warmup): lion moves every entry by lr, so it takes
# AdamW's; lamb's and adafactor's steps are relative to each leaf's norm
GPT2_LR = {"lamb": 1e-2, "lion": 3e-4, "adafactor": 3e-2}
GPT2_SERVED = "adafactor"       # the fine-tuned model that is served
# one update at the peak lr on the card against the same optimizer on
# the CPU, per leaf: the difference of the updated params over the
# largest entry of the leaf's update. The elementwise rules round alike;
# lamb's norms and adafactor's means sum up to 38.6 M fp32 entries in
# another order on each side (both within ~1e-7 of the exact sum), and
# that factor scales the leaf's whole update; 2 ulp of an entry of size
# 1 (the layer-norm weights), where the updated entry rounds the other
# way, pass in any case
GPT2_UPDATE_RTOL = 1e-5
GPT2_UPDATE_ATOL = 2.4e-7
# HF GPT2LMHeadModel's per-layer keys → the port's (block, leaf)
GPT2_LAYER_KEYS = {
    "ln_1.weight": ("ln1", "scale"), "ln_1.bias": ("ln1", "bias"),
    "attn.c_attn.weight": ("attn_qkv", "kernel"),
    "attn.c_attn.bias": ("attn_qkv", "bias"),
    "attn.c_proj.weight": ("attn_proj", "kernel"),
    "attn.c_proj.bias": ("attn_proj", "bias"),
    "ln_2.weight": ("ln2", "scale"), "ln_2.bias": ("ln2", "bias"),
    "mlp.c_fc.weight": ("mlp_fc1", "kernel"),
    "mlp.c_fc.bias": ("mlp_fc1", "bias"),
    "mlp.c_proj.weight": ("mlp_fc2", "kernel"),
    "mlp.c_proj.bias": ("mlp_fc2", "bias")}
GPT2_TOP_KEYS = {"wte.weight": ("wte", "table"),
                 "wpe.weight": ("wpe", "table"),
                 "ln_f.weight": ("ln_f", "scale"),
                 "ln_f.bias": ("ln_f", "bias")}


def gpt2_shapes(cfg) -> dict:
    """The keys of HF ``GPT2LMHeadModel.state_dict()`` at ``cfg``'s
    widths, with their shapes (Conv1D weights ``(in, out)``)."""
    d, h = cfg.d_model, cfg.mlp_ratio * cfg.d_model
    layer = {"ln_1.weight": (d,), "ln_1.bias": (d,),
             "attn.c_attn.weight": (d, 3 * d), "attn.c_attn.bias": (3 * d,),
             "attn.c_proj.weight": (d, d), "attn.c_proj.bias": (d,),
             "ln_2.weight": (d,), "ln_2.bias": (d,),
             "mlp.c_fc.weight": (d, h), "mlp.c_fc.bias": (h,),
             "mlp.c_proj.weight": (h, d), "mlp.c_proj.bias": (d,)}
    out = {"transformer.wte.weight": (cfg.vocab, d),
           "transformer.wpe.weight": (cfg.seq_len, d)}
    for i in range(cfg.n_layers):
        out.update({f"transformer.h.{i}.{k}": s for k, s in layer.items()})
    out.update({"transformer.ln_f.weight": (d,),
                "transformer.ln_f.bias": (d,),
                "lm_head.weight": (cfg.vocab, d)})
    return out


def gpt2_state_dict(cfg, seed: int = 0) -> dict:
    """A GPT-2 checkpoint laid out as HF ``GPT2LMHeadModel.state_dict()``
    is (the ``transformer.`` prefix, Conv1D ``(in, out)`` weights),
    numpy fp32 drawn from ``np.random.RandomState(seed)``: every tensor
    N(0, 0.02), the layer-norm weights 1 + N(0, 0.02), ``wte`` scaled by
    4 (the decisive head of :func:`gpt2_small`), and ``lm_head.weight``
    the ``wte`` array itself (GPT-2's tied head)."""
    rs = np.random.RandomState(seed)
    sd = {}
    for key, shape in gpt2_shapes(cfg).items():
        if key == "lm_head.weight":
            sd[key] = sd["transformer.wte.weight"]
            continue
        a = (rs.standard_normal(shape) * 0.02).astype(np.float32)
        if key.endswith(("ln_1.weight", "ln_2.weight", "ln_f.weight")):
            a += 1.0
        elif key == "transformer.wte.weight":
            a *= 4.0
        sd[key] = a
    return sd


def imported_leaf(params: dict, key: str) -> torch.Tensor:
    """The port tensor that HF key ``key`` was imported into."""
    key = key.removeprefix("transformer.")
    if key in GPT2_TOP_KEYS:
        block, leaf = GPT2_TOP_KEYS[key]
        return params[block][leaf]
    _, i, rest = key.split(".", 2)
    block, leaf = GPT2_LAYER_KEYS[rest]
    return params["blocks"][block][leaf][int(i)]


def gpt2_import_check(sd: dict, params: dict, cfg) -> None:
    """The imported config is GPT-2 small's, and every imported tensor
    equals its source bit for bit."""
    from torchbooster_tpu_torch.models.gpt import GPTConfig

    if cfg != GPTConfig():
        raise AssertionError(f"gpt2_import: config {cfg}, expected GPT-2 "
                             f"small's {GPTConfig()}")
    if "head" in params:
        raise AssertionError("gpt2_import: an untied head was imported")
    for key, want in sd.items():
        if key == "lm_head.weight":
            continue
        got = imported_leaf(params, key)
        if got.dtype != torch.float32 or got.device.type != "cuda" or \
                not torch.equal(got.cpu(), torch.from_numpy(want)):
            raise AssertionError(f"gpt2_import: {key} is not its source "
                                 f"bit for bit")


def gpt2_finetune_config(name: str):
    """``gpt2_train_config`` (GPT-2 small, batch 8 x 1024, bf16 over fp32
    masters, remat, chunked head, clip 1.0, ``synthetic_lm``) for
    ``GPT2_STEPS`` steps with optimizer ``name`` at ``GPT2_LR[name]``
    (lamb and lion keep gpt.yml's betas and decay; adafactor ignores
    them, as the JAX package does)."""
    import dataclasses

    conf = gpt2_train_config(GPT2_STEPS, sample_tokens=0)
    return dataclasses.replace(conf, optim=dataclasses.replace(
        conf.optim, name=name, lr=GPT2_LR[name]))


def gpt2_update_check(state, tx, loss_fn, batch, lr: float) -> dict:
    """One more update of the fine-tuned state at learning rate ``lr`` on
    the card, and the same update by the same optimizer on the CPU from
    the same fp32 params, gradients and optimizer state. Returns the
    largest difference of the updated params, and the largest of each
    leaf's difference over the largest entry of its update; raises where
    a leaf differs by more than ``GPT2_UPDATE_RTOL`` of that entry plus
    ``GPT2_UPDATE_ATOL``."""
    from torchbooster_tpu_torch.models.gpt import map_tensors
    from torchbooster_tpu_torch.utils import _paths, tree_leaves

    for p in tree_leaves(state.params):
        p.grad = None
    loss_fn(state.params, batch, state.generator)[0].backward()
    before = map_tensors(state.params, lambda t: t.detach().cpu())
    host = map_tensors(before, torch.clone)
    for p, q in zip(tree_leaves(host), tree_leaves(state.params)):
        p.grad = q.grad.cpu()
    host_opt = tx.init(host)
    host_opt.load_state_dict(state.optimizer.state_dict())
    for opt in (state.optimizer, host_opt):
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    out = {"max_abs_err": 0.0, "max_rel_to_update": 0.0, "worst_leaf": None}
    for (path, p0), card, cpu in zip(_paths(before), tree_leaves(
            state.params), tree_leaves(host), strict=True):
        card = card.detach().cpu()
        err = (card - cpu).abs().max().item()
        scale = (card - p0).abs().max().item()
        rel = err / max(scale, 1e-30)
        if not err <= GPT2_UPDATE_RTOL * scale + GPT2_UPDATE_ATOL:
            raise AssertionError(
                f"one update on the card and on the CPU differ by {err} on "
                f"{path}, whose update reaches {scale} (rtol "
                f"{GPT2_UPDATE_RTOL}, atol {GPT2_UPDATE_ATOL})")
        if err > out["max_abs_err"]:
            out["max_abs_err"] = err
        if rel > out["max_rel_to_update"]:
            out.update(max_rel_to_update=rel, worst_leaf=path)
    return out


def gpt2_finetune(name: str, imported: dict, cfg, smi: str) -> tuple:
    """``GPT2_STEPS`` steps of ``utils.make_step`` from the imported
    params with optimizer ``name``; returns ``(report, flash launches by
    kernel and route, the fine-tuned params)``."""
    from torchbooster_tpu_torch import utils
    from torchbooster_tpu_torch.dataset import Split
    from torchbooster_tpu_torch.models.gpt import map_tensors
    from torchbooster_tpu_torch.ops import flash_attention as fa
    from torchbooster_tpu_torch.recipes import gpt as recipe

    conf = gpt2_finetune_config(name)
    loss_fn = recipe.make_loss(conf, cfg)
    tx = conf.optim.make(conf.scheduler.make(conf.optim))
    state = utils.TrainState.create(
        map_tensors(imported, lambda t: t.clone()), tx,
        generator=conf.seed)
    step = utils.make_step(loss_fn, tx, clip=conf.clip)
    data = conf.dataset.make(Split.TRAIN, seq_len=cfg.seq_len + 1,
                             vocab=cfg.vocab)
    batches = utils.iter_loader(conf.loader.make(data, shuffle=True,
                                                 seed=conf.seed))

    def to_card(tokens):
        tokens = torch.from_numpy(np.ascontiguousarray(tokens)).long()
        tokens = tokens.pin_memory().to(DEV, non_blocking=True)
        return {"ids": tokens[:, :-1], "labels": tokens[:, 1:]}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    losses, step_s = [], []
    for _ in range(GPT2_STEPS):
        batch = to_card(next(batches)[1])
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(m["loss"].item())
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    launches = {"fwd": fa.launches_fwd, "dq": fa.launches_dq,
                "dkv": fa.launches_dkv}
    by_route = {"fwd": dict(fa.launches_fwd_by_route),
                "dq": dict(fa.launches_dq_by_route),
                "dkv": dict(fa.launches_dkv_by_route)}
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"gpt2_import {name}: losses {losses}")
    n_l = cfg.n_layers
    # the remat policy recomputes B1 (its output is no saved product)
    expected = {"fwd": 2 * n_l * GPT2_STEPS, "dq": n_l * GPT2_STEPS,
                "dkv": n_l * GPT2_STEPS}
    route_expected = {k: {"sm90": n, "mma_sync": 0, "f32": 0}
                      for k, n in expected.items()}
    if launches != expected or by_route != route_expected:
        raise AssertionError(f"gpt2_import {name}: flash launches "
                             f"{by_route}, expected {route_expected}")
    state_bytes = sum(v.numel() * v.element_size()
                      for leaf in state.optimizer.state.values()
                      for v in leaf.values())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in utils.tree_leaves(state.params))
    if name == "adafactor" and not state_bytes < 0.01 * param_bytes:
        raise AssertionError(f"gpt2_import adafactor: state {state_bytes} "
                             f"bytes against {param_bytes} of params: the "
                             f"moments did not factor")
    update = gpt2_update_check(state, tx, loss_fn,
                               to_card(next(batches)[1]), conf.optim.lr)
    # steady state: the median of steps 3-8
    steady = sorted(step_s[2:])
    step_ms = (steady[(len(steady) - 1) // 2]
               + steady[len(steady) // 2]) / 2 * 1e3
    out = {"lr": GPT2_LR[name], "losses": losses, "step_ms": step_ms,
           "step_ms_each": [s * 1e3 for s in step_s],
           "tokens_per_s": TRAIN_B * TRAIN_S / step_ms * 1e3,
           "peak_mem_bytes": peak, "optimizer_state_bytes": state_bytes,
           "param_bytes": param_bytes,
           "state_share_of_params": state_bytes / param_bytes,
           "launches": launches, "by_route": by_route,
           "update_vs_cpu": update,
           "update_tol": {"rtol": GPT2_UPDATE_RTOL,
                          "atol": GPT2_UPDATE_ATOL},
           "card": smi}
    log(f"gpt2_import {name} (lr {GPT2_LR[name]}): {GPT2_STEPS} steps at "
        f"batch {TRAIN_B} x {TRAIN_S}, {conf.env.precision}, remat "
        f"policy, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; step {step_ms:.1f} ms "
        f"(median of steps 3-{GPT2_STEPS}), {out['tokens_per_s']:.0f} "
        f"tokens/s, peak mem {peak / 2**30:.2f} GiB, optimizer state "
        f"{state_bytes} bytes ({100 * out['state_share_of_params']:.3f}% "
        f"of the fp32 params' {param_bytes}); B1-B3 by route {by_route}; "
        f"one update at lr {conf.optim.lr}, card vs CPU: max abs err "
        f"{update['max_abs_err']:.3g}, at most "
        f"{update['max_rel_to_update']:.3g} of a leaf's largest update "
        f"entry ({update['worst_leaf']}; rtol {GPT2_UPDATE_RTOL}) [{smi}]")
    params = state.params
    del state
    return out, {**launches, "by_route": by_route}, params


def phase_gpt2_import(report: dict, smi: str) -> dict:
    """Import a GPT-2 small checkpoint in HF's layout, fine-tune it with
    lamb, lion and adafactor, and serve one fine-tuned model at bf16 and
    fp32. Returns the flash launch counts of the fine-tunes and the
    paged kernel's of the serving runs."""
    from torchbooster_tpu_torch.models.gpt import (
        GPTConfig,
        load_torch_gpt2,
        map_tensors,
    )

    t0 = time.perf_counter()
    sd = gpt2_state_dict(GPTConfig())
    imported, cfg = load_torch_gpt2(sd, device=DEV)
    gpt2_import_check(sd, imported, cfg)
    import_s = time.perf_counter() - t0
    n_params = sum(a.size for k, a in sd.items() if k != "lm_head.weight")
    log(f"gpt2_import: {len(sd)} HF tensors ({n_params} parameters, "
        f"lm_head tied) imported bit for bit into GPT-2 small "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads, {cfg.seq_len} positions), {import_s:.1f} s with the draw")
    del sd
    out: dict = {"import_s": import_s}
    flash = {"fwd": 0, "dq": 0, "dkv": 0,
             "by_route": {k: dict.fromkeys(("sm90", "mma_sync", "f32"), 0)
                          for k in ("fwd", "dq", "dkv")}}
    served = None
    for name in GPT2_LR:
        res, launches, params = gpt2_finetune(name, imported, cfg, smi)
        out[name] = res
        for k in ("fwd", "dq", "dkv"):
            flash[k] += launches[k]
            for r, n in launches["by_route"][k].items():
                flash["by_route"][k][r] += n
        if name == GPT2_SERVED:
            served = map_tensors(params, lambda t: t.detach())
        del params
        torch.cuda.empty_cache()
    del imported
    paged = {"launches": 0, "by_route": {"sm90": 0, "simt": 0}}
    for dtype, key in ((torch.bfloat16, "serve_bf16"),
                       (torch.float32, "serve_fp32")):
        sub: dict = {}
        match, launches, by_route = phase_serve(
            served, cfg, dtype, smi, sub, f"gpt2_import {key} "
            f"({GPT2_SERVED}-tuned)")
        out[key] = next(iter(sub.values()))
        if not all(match):
            raise AssertionError(f"gpt2_import {key}: the {GPT2_SERVED}-"
                                 f"tuned model disagrees with dense "
                                 f"generate on {match.count(False)} "
                                 f"requests")
        paged["launches"] += launches
        for r, n in by_route.items():
            paged["by_route"][r] += n
    out["served"] = GPT2_SERVED
    report["gpt2_import"] = out
    del served
    torch.cuda.empty_cache()
    return {"flash": flash, "paged": paged}


# ------------------------------------------------------------- train_long
LONG_STEPS = 12
LONG_SAVE_EVERY = 4
LONG_SAMPLE = 128
# gpt-long.yml's keys that phase train_long sets otherwise, and why
LONG_OVERRIDES = {
    "env.distributed": "one card; the sp:8 mesh waits for ROADMAP A5",
    "env.mesh": "one card; the sp:8 mesh waits for ROADMAP A5",
    "dataset.root": "the repo's *.py and *.md text, nothing fetched",
    "n_iter": "time", "scheduler.n_iter": "time",
    "scheduler.warmup": "the loss moves within 12 steps",
    "save_every": "saves at 4, 8 and 12", "checkpoint_root": "a temp dir",
    "log_every": "a record a step", "eval_batches": "time"}


def gpt_long_config(corpus, checkpoint_root, n_iter: int = LONG_STEPS):
    """``examples/lm/gpt/gpt-long.yml``'s values built in code (the card's
    machine reads no YAML), with the keys of ``LONG_OVERRIDES`` set for
    one card and a short run."""
    from torchbooster_tpu_torch.config import (
        DatasetConfig,
        EnvConfig,
        LoaderConfig,
        OptimizerConfig,
        SchedulerConfig,
    )
    from torchbooster_tpu_torch.recipes.gpt import Config, ModelConfig

    return Config(
        n_iter=n_iter, seed=42, clip=1.0, accumulate_every=1, log_every=1,
        save_every=LONG_SAVE_EVERY, checkpoint_root=str(checkpoint_root),
        sample_tokens=LONG_SAMPLE, sample_temperature=0.8, sample_top_p=0.95,
        eval_batches=1,
        model=ModelConfig(vocab=256, n_layers=12, d_model=768, n_heads=16,
                          n_kv_heads=8, seq_len=8192, pos="rope",
                          dropout=0.1, remat=True, sp_strategy="auto",
                          chunked_head=True),
        env=EnvConfig(distributed=False, precision="bf16", mesh="dp"),
        loader=LoaderConfig(batch_size=8, num_workers=0, drop_last=True),
        optim=OptimizerConfig(name="adamw", lr=3e-4, weight_decay=0.1,
                              decay_matrices_only=True),
        scheduler=SchedulerConfig(name="cycle", n_iter=n_iter, warmup=2,
                                  decay=("cos", "cos")),
        dataset=DatasetConfig(name="text_file", root=str(corpus)))


def repo_corpus(path: Path) -> int:
    """Every ``*.py`` and ``*.md`` file of this checkout, concatenated in
    sorted path order into ``path`` (hidden directories and build
    outputs left out); returns its bytes."""
    root = Path(__file__).resolve().parent
    skip = {"build", "chiprun_out", "chip_checkout", "__pycache__"}
    files = sorted(f for ext in ("*.py", "*.md") for f in root.rglob(ext)
                   if not any(part.startswith(".") or part in skip
                              for part in f.relative_to(root).parts))
    with path.open("wb") as out:
        for f in files:
            out.write(f.read_bytes())
    return path.stat().st_size


def long_flops_per_step(cfg, n_params: int, b: int) -> dict:
    """Model FLOPs a step: 6 x parameters x tokens for the matmuls (the
    tied head counted once) plus causal attention's products, 2 D per
    visible (query, key) pair each: 2 in the forward and 5 in the
    backward (dV, dP, dQ, dK and the recomputed scores). The remat
    recompute and the backward kernels' second recompute are not
    counted."""
    s, d = cfg.seq_len, cfg.head_dim
    dense = 6.0 * n_params * b * s
    product = 2.0 * d * visible_pairs(s, s, True) * b * cfg.n_heads
    attn = 7 * product * cfg.n_layers
    return {"dense": dense, "attention": attn, "total": dense + attn,
            "causal_product": product}


def reset_flash_counts() -> None:
    from torchbooster_tpu_torch.ops import attention as at
    from torchbooster_tpu_torch.ops import flash_attention as fa

    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    for counts in (fa.launches_fwd_by_route, fa.launches_dq_by_route,
                   fa.launches_dkv_by_route):
        for route in counts:
            counts[route] = 0
    at.reference_calls = 0


def state_diff(a, b) -> dict:
    """Leaves of two train states that differ, by name: parameters,
    AdamW's moments and step count, the step and the generator state."""
    from torchbooster_tpu_torch.utils import tree_leaves

    out = {}
    for i, (x, y) in enumerate(zip(tree_leaves(a.params),
                                   tree_leaves(b.params), strict=True)):
        if not torch.equal(x, y):
            out[f"param{i}"] = (x - y).abs().max().item()
    sa, sb = a.optimizer.state_dict()["state"], \
        b.optimizer.state_dict()["state"]
    for i in sa:
        for key in sa[i]:
            if not torch.equal(sa[i][key], sb[i][key]):
                out[f"optimizer{i}.{key}"] = (
                    sa[i][key] - sb[i][key]).abs().max().item()
    if a.step != b.step:
        out["step"] = (a.step, b.step)
    if not torch.equal(a.generator.get_state(), b.generator.get_state()):
        out["generator"] = "differs"
    return out


def long_dropout_checks(t, batch) -> dict:
    """The dropout rules on the trainer's params and one batch: the same
    generator state gives the same loss bit for bit (the training
    forward, remat on), another state another loss; the eval loss (no
    generator) equals a dropout-0 forward bit for bit."""
    import dataclasses

    from torchbooster_tpu_torch.models.gpt import GPT
    from torchbooster_tpu_torch.ops.losses import lm_head_cross_entropy

    gen = t.state.generator
    start = gen.get_state()
    losses = []
    for _ in range(2):
        gen.set_state(start)
        losses.append(t.loss_fn(t.state.params, batch, gen)[0].detach())
    moved = t.loss_fn(t.state.params, batch, gen)[0].detach()
    gen.set_state(start)
    with torch.no_grad():
        evaluated = t.loss_fn(t.state.params, batch, None)[0]
        cfg0 = dataclasses.replace(t.cfg, dropout=0.0)
        hidden = GPT.apply(t.state.params, batch["ids"], cfg0,
                           compute_dtype=t.conf.env.compute_dtype(),
                           return_hidden=True, generator=gen)
        plain = lm_head_cross_entropy(hidden, GPT.head_table(t.state.params),
                                      batch["labels"])
    gen.set_state(start)
    out = {"same_state": [x.item() for x in losses],
           "other_state": moved.item(), "eval": evaluated.item(),
           "dropout0": plain.item()}
    if not torch.equal(losses[0], losses[1]):
        raise AssertionError(f"train_long: one generator state, two losses "
                             f"{out['same_state']}")
    if torch.equal(moved, losses[0]):
        raise AssertionError("train_long: a moved generator gave the same "
                             "loss: no dropout was drawn")
    if not torch.equal(evaluated, plain):
        raise AssertionError(f"train_long: eval loss {out['eval']} is not "
                             f"the dropout-0 loss {out['dropout0']}")
    return out


def long_breakdown(t, n_steps: int = 2) -> dict:
    """``n_steps`` more steps of a trainer under the profiler (CUDA
    activity): device busy share of the wall time, B1-B3's share of the
    device time and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    batches = [t.batch(next(t.batches)[1]) for _ in range(n_steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            t.state, m = t.step(t.state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    per_kernel = sorted(((e.key, e.self_device_time_total / 1e6)
                         for e in events), key=lambda kv: -kv[1])
    busy = sum(v for _, v in per_kernel)
    flash = {name: sum(v for k, v in per_kernel if f"::{name}<" in k)
             for name in ("flash_fwd_mma", "flash_dq_mma", "flash_dkv_mma")}
    return {"steps": n_steps, "wall_s": wall, "step_ms": wall / n_steps * 1e3,
            "device_busy_s": busy, "device_busy_share": busy / wall,
            "device_ms_per_step": busy / n_steps * 1e3,
            "flash_ms_per_step": {k: v / n_steps * 1e3
                                  for k, v in flash.items()},
            "flash_share_of_device": sum(flash.values()) / max(busy, 1e-12),
            "kernels_per_step": sum(e.count for e in events) / n_steps,
            "top": per_kernel[:12]}


def phase_train_long(report: dict, smi: str) -> dict:
    """The GPT recipe's ``main`` at ``gpt-long.yml``'s widths on one card
    (batch 8 x 8192 bytes of the repo's own text, 12 layers, d_model 768,
    16 heads over 8 kv heads, rope, dropout 0.1, remat, chunked head,
    AdamW with decay on matrices only, a cos/cos cycle), 12 steps with a
    checkpoint every 4, one validation batch and a 128-token top-p
    sample; then the resume, dropout and breakdown checks. Returns the
    flash launch counts of the ``main`` run."""
    import tempfile

    from torchbooster_tpu_torch.data.tokenizer import ByteTokenizer
    from torchbooster_tpu_torch.ops import attention as at
    from torchbooster_tpu_torch.ops import flash_attention as fa
    from torchbooster_tpu_torch.recipes import gpt as recipe
    from torchbooster_tpu_torch.utils import tree_leaves

    with tempfile.TemporaryDirectory(prefix="train_long_") as tmp:
        tmp = Path(tmp)
        corpus_bytes = repo_corpus(tmp / "corpus.txt")
        conf = gpt_long_config(tmp / "corpus.txt", tmp / "checkpoints")
        cfg = conf.model.make()
        b, s = conf.loader.batch_size, cfg.seq_len
        # the validation split (5%) must hold one batch of windows
        need = math.ceil(b * (s + 1) / 0.05)
        if corpus_bytes < need:
            raise AssertionError(f"train_long: corpus of {corpus_bytes} "
                                 f"bytes; one validation batch needs {need}")
        t1 = recipe.setup(conf)
        if t1.start_iter != 0:
            raise AssertionError("train_long: a fresh directory resumed")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_flash_counts()
        t0 = time.perf_counter()
        res = recipe.run(t1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fwd": fa.launches_fwd, "dq": fa.launches_dq,
                    "dkv": fa.launches_dkv}
        by_route = {"fwd": dict(fa.launches_fwd_by_route),
                    "dq": dict(fa.launches_dq_by_route),
                    "dkv": dict(fa.launches_dkv_by_route)}
        reference_calls = at.reference_calls
        peak = torch.cuda.max_memory_allocated()

        # 1. attention routes: per step B1 twice a layer (remat), B2 and B3
        # once; one B1 a layer for the eval batch and for the sample's
        # prefill; all on "mma_sync" (bf16, D 48); never the reference
        n_l = cfg.n_layers
        expected = {"fwd": 2 * n_l * LONG_STEPS + 2 * n_l,
                    "dq": n_l * LONG_STEPS, "dkv": n_l * LONG_STEPS}
        route_expected = {k: {"sm90": 0, "mma_sync": n, "f32": 0}
                          for k, n in expected.items()}
        if launches != expected or by_route != route_expected:
            raise AssertionError(f"train_long: flash launches {by_route}, "
                                 f"expected {route_expected}")
        if reference_calls:
            raise AssertionError(f"train_long: mha_reference called "
                                 f"{reference_calls} times")
        # 2. the loss: finite, and the mean of the last 3 below the first
        losses = [r["loss"] for r in res["log"]]
        if len(losses) != LONG_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"train_long: losses {losses}")
        if not sum(losses[-3:]) / 3 < losses[0]:
            raise AssertionError(f"train_long: the loss did not fall: "
                                 f"{losses}")
        # 4. checkpoints at 4, 8 and 12 under the JAX path scheme
        names = sorted(p.name for p in (tmp / "checkpoints").iterdir())
        want_names = [f"ckpt_{i:02d}" for i in range(
            LONG_SAVE_EVERY, LONG_STEPS + 1, LONG_SAVE_EVERY)]
        if names != want_names:
            raise AssertionError(f"train_long: checkpoints {names}, "
                                 f"expected {want_names}")
        saves = [{k: r[k] for k in ("step", "block_s", "bytes", "write_s")}
                 for r in t1.save_cb.saves]
        # 5. the sample: 8 prompt + 128 new byte tokens
        sample = res["sample"]
        if len(sample) != 8 + LONG_SAMPLE or not all(
                0 <= i < 256 for i in sample):
            raise AssertionError(f"train_long: sample {sample}")
        text = ByteTokenizer().decode(sample)

        el = [r["elapsed_s"] for r in res["log"]]
        # steps 3-12: the time between the records of steps 2 and 12
        step_s = sorted(el[i] - el[i - 1] for i in range(2, LONG_STEPS))
        step_med = step_s[len(step_s) // 2 - 1: len(step_s) // 2 + 1]
        step_med = sum(step_med) / len(step_med)
        n_params = sum(p.numel() for p in tree_leaves(t1.state.params))
        flops = long_flops_per_step(cfg, n_params, b)
        out = {"losses": losses, "val_loss": res.get("val_loss"),
               "launches": launches, "by_route": by_route,
               "expected": expected, "reference_calls": reference_calls,
               "main_wall_s": wall, "step_ms_median": step_med * 1e3,
               "step_ms": [x * 1e3 for x in step_s],
               "tokens_per_s": b * s / step_med, "n_params": n_params,
               "flops": flops,
               "mfu_of_989_tflops": flops["total"] / step_med / BF16_FLOPS,
               "peak_mem_bytes": peak, "corpus_bytes": corpus_bytes,
               "checkpoints": names, "saves": saves, "sample": sample,
               "sample_text": text, "overrides": LONG_OVERRIDES,
               "card": smi}
        log(f"train_long: gpt-long.yml at one card (overrides: "
            + "; ".join(f"{k} ({v})" for k, v in LONG_OVERRIDES.items())
            + f"); corpus {corpus_bytes} bytes; {n_params / 1e6:.2f} M "
            f"params; loss {losses[0]:.4f} -> {losses[-1]:.4f} (last 3 "
            f"mean {sum(losses[-3:]) / 3:.4f}); val loss "
            f"{res.get('val_loss', float('nan')):.4f}; step "
            f"{out['step_ms_median']:.1f} ms (median of steps 3-12), "
            f"{out['tokens_per_s']:.0f} tokens/s, model FLOP share "
            f"{100 * out['mfu_of_989_tflops']:.2f}% of 989 TFLOP/s "
            f"({flops['dense'] / 1e12:.1f} TFLOP dense + "
            f"{flops['attention'] / 1e12:.1f} TFLOP causal attention a "
            f"step), peak mem {peak / 2**30:.2f} GiB; flash launches "
            f"{by_route}, mha_reference calls {reference_calls} [{smi}]")
        log("train_long checkpoints: " + ", ".join(names) + "; " + "; ".join(
            f"step {r['step']}: {r['bytes']} bytes, {r['block_s'] * 1e3:.1f} "
            f"ms blocking (device to host), {r['write_s'] * 1e3:.1f} ms "
            f"background write" for r in saves))
        log(f"train_long sample ({len(sample)} tokens): {text!r}")

        # 4. resume: a fresh setup restores step 12 bit for bit, and one
        # more step on one batch from both trainers agrees bit for bit
        t2 = recipe.setup(conf)
        if (t2.start_iter, t2.state.step) != (LONG_STEPS, LONG_STEPS):
            raise AssertionError(f"train_long: resumed at {t2.start_iter}")
        diff = state_diff(t1.state, t2.state)
        if diff:
            raise AssertionError(f"train_long: the restored state differs: "
                                 f"{diff}")
        batch = t1.batch(next(t1.batches)[1])
        t1.state, m1 = t1.step(t1.state, batch)
        t2.state, m2 = t2.step(t2.state, batch)
        after = state_diff(t1.state, t2.state)
        same_loss = torch.equal(m1["loss"], m2["loss"])
        if after or not same_loss:
            raise AssertionError(f"train_long: one step from the original "
                                 f"and the restored trainer: losses "
                                 f"{m1['loss'].item()} / {m2['loss'].item()}"
                                 f", leaves that differ {after}")
        out["resume"] = {"step": t2.state.step, "loss": m1["loss"].item(),
                         "bit_identical": True}
        log(f"train_long resume: setup restored step {LONG_STEPS}, params, "
            f"AdamW moments, step and generator bit for bit; one more step "
            f"from both: loss {m1['loss'].item():.6f}, state bit for bit")
        del t2
        torch.cuda.empty_cache()

        # 3. dropout: reproducible, and off without a generator
        drop = out["dropout"] = long_dropout_checks(t1, batch)
        log(f"train_long dropout: one generator state twice "
            f"{drop['same_state'][0]:.6f} / {drop['same_state'][1]:.6f} "
            f"(bit for bit), a moved state {drop['other_state']:.6f}; eval "
            f"{drop['eval']:.6f} = dropout 0 {drop['dropout0']:.6f} (bit for "
            f"bit)")

        bd = out["breakdown"] = long_breakdown(t1)
        log(f"train_long profiled: {bd['steps']} steps, "
            f"{bd['step_ms']:.1f} ms/step, device "
            f"{bd['device_ms_per_step']:.1f} ms/step, busy "
            f"{100 * bd['device_busy_share']:.1f}%, "
            f"{bd['kernels_per_step']:.0f} kernels a step; B1-B3 "
            f"{100 * bd['flash_share_of_device']:.1f}% of device time ("
            + ", ".join(f"{k} {v:.1f} ms" for k, v in
                        bd["flash_ms_per_step"].items())
            + " a step); top: " + "; ".join(
                f"{k[:60]} {v * 1e3:.1f} ms" for k, v in bd["top"][:6]))
        del t1
        torch.cuda.empty_cache()
    report["train_long"] = out
    return {**launches, "by_route": by_route}


# ------------------------------------------------------------------ conv
RN_B = 512            # the ResNet recipe's batch (examples/img_cls/resnet)
GROUPS = 32
# (name, kind, B, H, W, Cin, Cout, stride); kind "gn" runs B5 and B6,
# "1x1" B7, "3x3" B8. The first eleven are the ResNet-18 CIFAR training
# path at batch 512 (stage s at 32 / 2^s): the stem norm and the stride-2
# 3x3s' norms (B5/B6), the stride-2 projections (B7), the stride-1 3x3s.
CONV_MAIN = [
    ("stem_gn", "gn", RN_B, 32, 32, 64, 64, 1),
    ("stage1_gn", "gn", RN_B, 16, 16, 128, 128, 1),
    ("stage2_gn", "gn", RN_B, 8, 8, 256, 256, 1),
    ("stage3_gn", "gn", RN_B, 4, 4, 512, 512, 1),
    ("stage1_proj", "1x1", RN_B, 32, 32, 64, 128, 2),
    ("stage2_proj", "1x1", RN_B, 16, 16, 128, 256, 2),
    ("stage3_proj", "1x1", RN_B, 8, 8, 256, 512, 2),
    ("stage0_3x3", "3x3", RN_B, 32, 32, 64, 64, 1),
    ("stage1_3x3", "3x3", RN_B, 16, 16, 128, 128, 1),
    ("stage2_3x3", "3x3", RN_B, 8, 8, 256, 256, 1),
    ("stage3_3x3", "3x3", RN_B, 4, 4, 512, 512, 1),
]
# calls of each main-path geometry per training step (forward)
CONV_PER_STEP = {"stem_gn": 1, "stage1_gn": 1, "stage2_gn": 1,
                 "stage3_gn": 1, "stage1_proj": 1, "stage2_proj": 1,
                 "stage3_proj": 1, "stage0_3x3": 4, "stage1_3x3": 3,
                 "stage2_3x3": 3, "stage3_3x3": 3}
# ResNet-50 at 224² (bottleneck geometries, batch 32) and a non-square map
CONV_EXTRA = [
    ("r50_56sq_1x1_64to256", "1x1", 32, 56, 56, 64, 256, 1),
    ("r50_56sq_3x3_64", "3x3", 32, 56, 56, 64, 64, 1),
    ("r50_7sq_gn_2048", "gn", 32, 7, 7, 2048, 2048, 1),
    ("nonsquare_7x9_gn", "gn", 8, 7, 9, 64, 64, 1),
    ("nonsquare_7x9_1x1_s2", "1x1", 8, 7, 9, 64, 128, 2),
    ("nonsquare_7x9_3x3", "3x3", 8, 7, 9, 64, 32, 1),
    # widths off the 16-byte vectors: the one-element load routes, a
    # ragged Cout tile and 20 groups of 2 (``groups`` clipped from 32)
    ("odd_c12_gn", "gn", 8, 7, 9, 12, 12, 1),
    ("odd_cin12_cout40_3x3", "3x3", 8, 7, 9, 12, 40, 1),
    ("odd_cin12_cout40_1x1_s2", "1x1", 8, 7, 9, 12, 40, 2),
    # B8's one-pass routes at small batch: a cluster of 8 CTAs per sample,
    # a pack of 8 whose only pack holds 5 samples
    ("cluster_b3_32sq_3x3", "3x3", 3, 32, 32, 64, 64, 1),
    ("pack_rem_b5_4sq_3x3", "3x3", 5, 4, 4, 512, 512, 1),
    # B5's two samples a CTA, the last CTA holding one
    ("pack_rem_b3_8sq_gn", "gn", 3, 8, 8, 256, 256, 1),
]
# cases whose bf16 calls must repeat bit for bit: B8 on each route, B7 on
# both one-pass routes ("cluster" at 16², "pack" of 8 at 4²), B6 at
# clusters of 4, 2 and 1 CTAs
CONV_REPEAT = ("stage0_3x3", "stage3_3x3", "pack_rem_b5_4sq_3x3",
               "odd_cin12_cout40_3x3", "stage1_proj", "stage3_proj",
               "stem_gn", "stage1_gn", "nonsquare_7x9_gn")
# B5's: a cluster of 2 CTAs (the stem), one CTA of 16 and of 63 positions,
# two samples a CTA
GN_FWD_REPEAT = ("stem_gn", "stage3_gn", "nonsquare_7x9_gn", "stage2_gn")


def groups_for(c: int) -> int:
    """The recipe's 32 groups, clipped to a divisor of ``c`` as
    ``layers.group_norm`` and the fused kernels' wrappers clip them."""
    g = min(GROUPS, c)
    while c % g:
        g -= 1
    return g


# the kernel each kernels-line entry is timed at: the largest main-path call
CONV_TIMED = {"gn_fwd": "stem_gn", "gn_bwd": "stem_gn",
              "conv1x1": "stage1_proj", "conv3x3": "stage0_3x3"}
# atol = rtol, per dtype. bf16: both sides compute in fp32 from the same
# bf16 values and round the output once, so one bf16 ulp of the output;
# fp32: only the summation order differs
CONV_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def conv_inputs(gen, kind, b, h, w, cin, cout, dtype):
    """x (and dy for "gn") in ``dtype``, w (k, k, Cin, Cout) scaled by
    1/sqrt(fan-in) in ``dtype``, scale and bias fp32."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEV)
    k = 3 if kind == "3x3" else 1
    x = (randn(b, h, w, cin) * 2.0 + 0.5).to(dtype)
    return dict(x=x, dy=randn(b, h, w, cin).to(dtype),
                w=(randn(k, k, cin, cout) / math.sqrt(k * k * cin)).to(dtype),
                scale=1.0 + 0.1 * randn(cout), bias=0.1 * randn(cout))


def planned_route(case, dtype, key: str = "gn_bwd") -> str:
    """The route ``case``'s kernel takes at ``dtype``: B8's and B7's from
    their plans (``"f32"`` at fp32); for a GroupNorm case, B5's
    (``plan_gn_fwd``) when ``key`` is ``"gn_fwd"``, else B6's
    (``plan_gn_bwd``)."""
    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gnk

    _, kind, b, h, w, cin, cout, stride = case
    if kind == "gn":
        plan = gnk.plan_gn_fwd if key == "gn_fwd" else gnk.plan_gn_bwd
        return plan(b, h * w, cin, groups_for(cin), dtype).route
    if dtype != torch.bfloat16:
        return "f32"
    if kind == "1x1":
        return fb.plan_conv1x1(b, h, w, cin, cout, groups_for(cout),
                               stride).route
    return fb.plan_conv3x3(b, h, w, cin, cout, groups_for(cout)).route


# the older route each one-pass route is also forced onto and timed beside
OLDER_ROUTE = {"one_pass": "two_pass", "cluster": "mma_sync",
               "pack": "mma_sync"}


def counted(counter: dict, route: str, call):
    """``call()``, asserting that it moved ``counter`` (a per-route launch
    count) by one on ``route`` and nowhere else."""
    before = dict(counter)
    res = call()
    torch.cuda.synchronize()
    if counter != {**before, route: before[route] + 1}:
        raise AssertionError(f"expected one launch on the {route!r} route: "
                             f"{counter} after {before}")
    return res


def check_conv_case(gen, case, dtype, relu) -> tuple[dict, dict]:
    """One geometry through its kernel(s) and plain version(s): max abs
    error and the share of the allowance atol + rtol|ref| used, per
    output. B5's-B8's per-route counters must move on the planned route; a
    one-pass route's case runs forced onto the older route too (outputs
    keyed ``<name>@<route>``)."""
    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gnk

    name, kind, b, h, w, cin, cout, stride = case
    a = conv_inputs(gen, kind, b, h, w, cin, cout, dtype)
    x, s, bi = a["x"], a["scale"], a["bias"]
    g = groups_for(cout)
    route = planned_route(case, dtype)
    routes = [route] + ([OLDER_ROUTE[route]]
                        if route in OLDER_ROUTE and kind != "3x3" else [])
    if kind == "gn":
        y_ref, st_ref = gnk.group_norm_fwd_reference(x, s, bi, g, 1e-5, relu)
        dx_ref, part_ref = gnk.group_norm_bwd_reference(
            x, a["dy"], st_ref, s, bi, g, relu)
        pairs = {}
        fwd = planned_route(case, dtype, "gn_fwd")
        for i, r in enumerate([fwd] + ([OLDER_ROUTE[fwd]]
                                       if fwd in OLDER_ROUTE else [])):
            y, st = counted(gnk.launches_fwd_by_route, r, lambda: (
                gnk.launch_fwd(x, s, bi, g, 1e-5, relu,
                               route=None if i == 0 else r)))
            tag = "" if i == 0 else f"@{r}"
            pairs.update({f"y{tag}": (y, y_ref), f"stats{tag}": (st, st_ref)})
        for i, r in enumerate(routes):
            dx, part = counted(gnk.launches_bwd_by_route, r, lambda: (
                gnk.launch_bwd(x, a["dy"], st_ref, s, bi, g, relu,
                               route=None if i == 0 else r)))
            tag = "" if i == 0 else f"@{r}"
            pairs.update({f"dx{tag}": (dx, dx_ref),
                          f"part{tag}": (part, part_ref)})
    else:
        ref = fb.conv_gn_reference(x, a["w"], s, bi, g, 1e-5, relu, stride)
        pairs = {}
        for i, r in enumerate(routes):
            if kind == "1x1":
                got = counted(fb.launches_1x1_by_route, r, lambda: (
                    fb.launch_1x1(x, a["w"], s, bi, g, 1e-5, relu, stride,
                                  route=None if i == 0 else r)))
            else:
                got = counted(fb.launches_3x3_by_route, r, lambda: (
                    fb.launch_3x3(x, a["w"], s, bi, g, 1e-5, relu)))
            tag = "" if i == 0 else f"@{r}"
            pairs.update({f"{k}{tag}": (o, want) for k, o, want in
                          zip(("out", "mu", "rstd"), got, ref)})
    tol = CONV_TOL[dtype]
    errs, used = {}, {}
    for key, (got, want) in pairs.items():
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        errs[key] = diff.max().item()
        used[key] = (diff / (tol + tol * want.abs())).max().item()
        if not (used[key] <= 1.0 and math.isfinite(errs[key])):
            raise AssertionError(f"conv case {name} {dtype} relu={relu}: "
                                 f"{key} disagrees with the plain version: "
                                 f"max abs err {errs[key]} (atol = rtol = "
                                 f"{tol})")
    return errs, used


def conv_work(case, el: int) -> dict:
    """Bytes each kernel must move (each input read once, each output
    written once) and the operations it does, per call. "gn_fwd": x in, y
    out, stats; about 6 fp32 flops an element (moments, affine, ReLU).
    "gn_bwd": x and dy in, dx out, stats and partials; about 12. "conv":
    the positions the conv reads (the strided quarter for a stride-2 1x1),
    the weight, out, mu/rstd; 2 flops per multiply-add of the product, at
    the tensor-core rate."""
    name, kind, b, h, w, cin, cout, stride = case
    if kind == "gn":
        n = b * h * w * cin
        small = 2 * cin * 4 + b * 2 * cin * 4
        return {"gn_fwd": (2 * n * el + small, 6 * n, FP32_FLOPS),
                "gn_bwd": (3 * n * el + small + b * 2 * cin * 4, 12 * n,
                           FP32_FLOPS)}
    k = 3 if kind == "3x3" else 1
    ho, wo = (h + stride - 1) // stride, (w + stride - 1) // stride
    x_pos = b * (ho * wo if k == 1 else h * w) * cin
    nbytes = (x_pos + k * k * cin * cout + b * ho * wo * cout) * el \
        + 2 * cout * 4 + 2 * b * cout * 4
    flops = 2 * b * ho * wo * cout * k * k * cin
    key = "conv1x1" if kind == "1x1" else "conv3x3"
    return {key: (nbytes, flops, BF16_FLOPS if el == 2 else FP32_FLOPS)}


def time_conv_case(gen, case) -> dict:
    """Each kernel of one main-path geometry at bf16 (ReLU as on the
    path: on for the norms and the 3x3 timed, off for the projections)
    beside its plain version, its bound and the library yardstick."""
    import torch.nn.functional as F

    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gnk

    name, kind, b, h, w, cin, cout, stride = case
    dtype = torch.bfloat16
    relu = kind != "1x1"
    a = conv_inputs(gen, kind, b, h, w, cin, cout, dtype)
    x, s, bi = a["x"], a["scale"], a["bias"]
    x4 = x.permute(0, 3, 1, 2)                  # channels-last NCHW view
    s_x, b_x = s.to(dtype), bi.to(dtype)
    runs = {}
    if kind == "gn":
        _, st = gnk.launch_fwd(x, s, bi, GROUPS, 1e-5, relu)
        xg = x4.detach().clone(memory_format=torch.channels_last) \
            .requires_grad_()
        sg, bg = s_x.clone().requires_grad_(), b_x.clone().requires_grad_()
        out_lib = F.group_norm(xg, GROUPS, sg, bg, 1e-5)
        dy4 = a["dy"].permute(0, 3, 1, 2)
        runs["gn_fwd"] = (
            lambda: gnk.launch_fwd(x, s, bi, GROUPS, 1e-5, relu),
            lambda: gnk.group_norm_fwd_reference(x, s, bi, GROUPS, 1e-5,
                                                 relu),
            lambda: F.group_norm(x4, GROUPS, s_x, b_x, 1e-5))
        runs["gn_bwd"] = (
            lambda: gnk.launch_bwd(x, a["dy"], st, s, bi, GROUPS, relu),
            lambda: gnk.group_norm_bwd_reference(x, a["dy"], st, s, bi,
                                                 GROUPS, relu),
            lambda: torch.autograd.grad(out_lib, (xg, sg, bg), dy4,
                                        retain_graph=True))
    else:
        k = 3 if kind == "3x3" else 1
        w4 = a["w"].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        pad = (k - 1) // 2

        def library():
            y = F.group_norm(F.conv2d(x4, w4, stride=stride, padding=pad),
                             GROUPS, s_x, b_x, 1e-5)
            return F.relu(y) if relu else y

        if kind == "1x1":
            kern = lambda: fb.launch_1x1(x, a["w"], s, bi, GROUPS, 1e-5,  # noqa: E731
                                         relu, stride)
            key = "conv1x1"
        else:
            kern = lambda: fb.launch_3x3(x, a["w"], s, bi, GROUPS, 1e-5,  # noqa: E731
                                         relu)
            key = "conv3x3"
        runs[key] = (kern, lambda: fb.conv_gn_reference(
            x, a["w"], s, bi, GROUPS, 1e-5, relu, stride), library)
    work = conv_work(case, 2)
    routes = {key: planned_route(case, dtype, key) for key in runs}
    # the older route on the same inputs, timed beside the planned one: B8's
    # two-pass mma_sync kernel (outside the launch counters), B7 forced onto
    # "mma_sync", B5 and B6 onto "two_pass"
    older = {"conv3x3": lambda: fb._launch(x, a["w"], s, bi, GROUPS, 1e-5,
                                           relu, 1)}
    if routes.get("conv1x1") in OLDER_ROUTE:
        older["conv1x1"] = lambda: fb.launch_1x1(
            x, a["w"], s, bi, GROUPS, 1e-5, relu, stride,
            route=OLDER_ROUTE[routes["conv1x1"]])
    if routes.get("gn_fwd") in OLDER_ROUTE:
        older["gn_fwd"] = lambda: gnk.launch_fwd(
            x, s, bi, GROUPS, 1e-5, relu,
            route=OLDER_ROUTE[routes["gn_fwd"]])
    if routes.get("gn_bwd") in OLDER_ROUTE:
        older["gn_bwd"] = lambda: gnk.launch_bwd(
            x, a["dy"], st, s, bi, GROUPS, relu,
            route=OLDER_ROUTE[routes["gn_bwd"]])
    out = {}
    for key, (kern, plain, lib) in runs.items():
        route = routes[key]
        fns = {"kernel": kern, "plain": plain, "library": lib}
        if key in older:
            fns["previous"] = older[key]
        iters = {"plain": 5}
        call = {c: cuda_ms(fn, iters=iters.get(c, 20),
                           warmup=2 if c == "plain" else 5)
                for c, fn in fns.items()}
        own = {}
        dev = {c: device_ms(fn, iters=iters.get(c, 20),
                            by_kernel=own if c == "kernel" else None)
               for c, fn in fns.items()}
        # the port's launches (kernel, older route) are also timed by
        # replays of a CUDA graph; each column whose profiler window lost
        # events takes that time, or, for the plain version and the library
        # call, CUDA events around back-to-back calls
        graphed = {c: graph_ms(fn) for c, fn in fns.items()
                   if c in ("kernel", "previous")}
        stream = {c: stream_ms(fn, iters=iters.get(c, 20),
                               warmup=2 if c == "plain" else 5)
                  for c, fn in fns.items() if not dev[c] and c not in graphed}
        src = {c: dev[c] or graphed.get(c) or stream[c] for c in fns}
        timed_by = {c: DEVICE_TIME if dev[c] else GRAPH_TIME if c in graphed
                    else "CUDA events over back-to-back calls" for c in fns}
        nbytes, flops, peak = work[key]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        out[key] = {"ms": src["kernel"], "plain_ms": src["plain"],
                    "sum_ms": sum(own.values()) if dev["kernel"] else None,
                    "library_ms": src["library"],
                    "previous_ms": src.get("previous"),
                    "timed_by": timed_by["kernel"], "column_timed_by": timed_by,
                    "call_ms": call, "device_ms": dev, "stream_ms": stream,
                    "graph_ms": graphed, "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": nbytes, "flops": flops}
        extra = ""
        out[key]["route"] = route
        if key == "conv3x3":
            # the product counted once, whatever the route computes
            out[key]["tflops"] = flops / (src["kernel"] * 1e-3) / 1e12
            out[key]["two_pass_ms"] = src["previous"]
            extra = (f"; route {route}, {out[key]['tflops']:.1f} TFLOP/s; "
                     f"two-pass mma_sync {src['previous'] * 1e3:.1f} us")
        else:
            if key == "conv1x1":
                plan = fb.plan_conv1x1(b, h, w, cin, cout, GROUPS, stride)
                ctas = (fb.ctas_per_sm_1x1(plan) if route in OLDER_ROUTE
                        else None)
            elif key == "gn_fwd":
                plan = gnk.plan_gn_fwd(b, h * w, cin, GROUPS, dtype)
                ctas = (gnk.ctas_per_sm_fwd(plan, cin, GROUPS)
                        if route in OLDER_ROUTE else None)
            else:
                plan = gnk.plan_gn_bwd(b, h * w, cin, GROUPS, dtype)
                ctas = (gnk.ctas_per_sm_bwd(plan, cin, GROUPS)
                        if route in OLDER_ROUTE else None)
            out[key]["ctas_per_sm"] = ctas
            out[key]["plan"] = plan._asdict()
            extra = f"; {plan}, {ctas} CTAs per SM"
            if "previous" in src:
                extra += (f"; {OLDER_ROUTE[route]} "
                          f"{src['previous'] * 1e3:.1f} us")
            if key == "gn_fwd" and route == "one_pass":
                out[key]["plan_sweep"] = gn_fwd_plan_sweep(
                    x, s, bi, relu, plan)
            if key == "gn_bwd" and route == "one_pass":
                out[key]["plan_sweep"] = gn_bwd_plan_sweep(
                    x, a["dy"], st, s, bi, relu, plan)
            if key == "conv1x1" and route in OLDER_ROUTE:
                out[key]["plan_sweep"] = conv1x1_tile_sweep(
                    x, a["w"], s, bi, relu, stride, plan)
        fell_back = [(how, [c for c in fns if not dev[c] and
                            timed_by[c] == how])
                     for how in (GRAPH_TIME,
                                 "CUDA events over back-to-back calls")]
        extra += (f"; CUDA graph replays: kernel "
                  f"{graphed['kernel'] * 1e3:.1f} us" + (
                      f", {OLDER_ROUTE.get(route, 'two-pass')} "
                      f"{graphed['previous'] * 1e3:.1f} us"
                      if "previous" in graphed else ""))
        log(f"conv timing {key} {name} (bf16, {DEVICE_TIME}"
            + "".join(f"; {how} for {', '.join(cs)}" for how, cs in fell_back
                      if cs) + "): "
            f"kernel {src['kernel'] * 1e3:.1f} us; plain "
            f"{src['plain'] * 1e3:.1f} us; library {src['library'] * 1e3:.1f}"
            f" us; bound {out[key]['bound_ms'] * 1e3:.1f} us "
            f"({out[key]['bound_by']}){extra}")
    return out


def gn_fwd_plan_sweep(x, s, bi, relu, planned) -> list:
    """B5's one-pass kernel at the other plans :func:`gn_fwd_plan` offers
    for these operands (the fewest CTAs a sample that let four, three, two
    or one share an SM; two, four or eight whole samples a CTA where their
    shared memory fits an SM), outside the launch counters, each held to the
    planned route's result and timed in device time: the data behind
    ``plan_gn_fwd``'s rule."""
    from torchbooster_tpu_torch.ops import group_norm as gnk

    n, h, w, c = x.shape
    want = gnk.launch_fwd(x, s, bi, GROUPS, 1e-5, relu)
    rows = []
    for pack, per_sm in itertools.product((1, 2, 4, 8), (4, 3, 2, 1)):
        plan = gnk.gn_fwd_plan(h * w, c, GROUPS, per_sm, pack)
        if plan is None or any(r["plan"] == plan._asdict() for r in rows):
            continue
        call = lambda: gnk._launch_fwd_one_pass(x, s, bi, GROUPS, 1e-5,  # noqa: E731
                                                relu, plan)
        got = call()
        torch.cuda.synchronize()
        err = max((g.float() - r.float()).abs().max().item()
                  for g, r in zip(got, want))
        if not err <= CONV_TOL[torch.bfloat16]:
            raise AssertionError(f"gn_fwd at {plan}: {err} from the planned "
                                 f"route")
        ms = device_ms(call, iters=20) or graph_ms(call)
        rows.append({"plan": plan._asdict(), "planned": plan == planned,
                     "ctas_per_sm": gnk.ctas_per_sm_fwd(plan, c, GROUPS),
                     "ms": ms, "max_abs_err_vs_planned": err})
    log(f"gn_fwd plan sweep {tuple(x.shape)}: " + "; ".join(
        f"cluster {r['plan']['cluster']} x {r['plan']['rows']} rows, pack "
        f"{r['plan']['pack']}, {r['ctas_per_sm']} CTAs/SM"
        f"{' (planned)' if r['planned'] else ''}: {r['ms'] * 1e3:.1f} us"
        for r in rows))
    return rows


def gn_bwd_plan_sweep(x, dy, st, s, bi, relu, planned) -> list:
    """B6's one-pass kernel at the other plans :func:`gn_bwd_plan` offers
    for these operands (the fewest CTAs a sample that let three, two or one
    share an SM), outside the launch counters, each held to the planned
    route's result and timed in device time: the data behind
    ``plan_gn_bwd``'s rule."""
    from torchbooster_tpu_torch.ops import group_norm as gnk

    n, h, w, c = x.shape
    want = gnk.launch_bwd(x, dy, st, s, bi, GROUPS, relu)
    rows = []
    for per_sm in (3, 2, 1):
        plan = gnk.gn_bwd_plan(h * w, c, GROUPS, per_sm)
        if plan is None or any(r["plan"] == plan._asdict() for r in rows):
            continue
        call = lambda: gnk._launch_one_pass(x, dy, st, s, bi, GROUPS,  # noqa: E731
                                            relu, plan)
        got = call()
        torch.cuda.synchronize()
        err = max((g.float() - r.float()).abs().max().item()
                  for g, r in zip(got, want))
        if not err <= CONV_TOL[torch.bfloat16]:
            raise AssertionError(f"gn_bwd at {plan}: {err} from the planned "
                                 f"route")
        ms = device_ms(call, iters=20) or graph_ms(call)
        rows.append({"plan": plan._asdict(), "planned": plan == planned,
                     "ctas_per_sm": gnk.ctas_per_sm_bwd(plan, c, GROUPS),
                     "ms": ms, "max_abs_err_vs_planned": err})
    log(f"gn_bwd plan sweep {tuple(x.shape)}: " + "; ".join(
        f"cluster {r['plan']['cluster']} x {r['plan']['rows']} rows, "
        f"{r['ctas_per_sm']} CTAs/SM"
        f"{' (planned)' if r['planned'] else ''}: {r['ms'] * 1e3:.1f} us"
        for r in rows))
    return rows


def conv1x1_tile_sweep(x, w, s, bi, relu, stride, planned) -> list:
    """B7's one-pass kernel at each Cout tile its instances build (64, 128)
    that the group width divides, on the planned route and outside the
    launch counters, held to the planned tile's result and timed in device
    time."""
    from torchbooster_tpu_torch.ops import fused_block as fb

    want = fb.launch_1x1(x, w, s, bi, GROUPS, 1e-5, relu, stride)
    rows = []
    for bn in (64, 128):
        plan = planned._replace(bn=bn)
        if bn % (w.shape[3] // GROUPS):
            continue
        call = lambda: fb._launch_sm90(x, w, s, bi, GROUPS, 1e-5, relu,  # noqa: E731
                                       stride, plan)
        got = call()
        torch.cuda.synchronize()
        err = max((g.float() - r.float()).abs().max().item()
                  for g, r in zip(got, want))
        if not err <= CONV_TOL[torch.bfloat16]:
            raise AssertionError(f"conv1x1 at {plan}: {err} from the planned "
                                 f"tile")
        ms = device_ms(call, iters=20) or graph_ms(call)
        rows.append({"plan": plan._asdict(), "planned": plan == planned,
                     "ctas_per_sm": fb.ctas_per_sm_1x1(plan), "ms": ms,
                     "max_abs_err_vs_planned": err})
    log(f"conv1x1 tile sweep {tuple(x.shape)} -> {w.shape[3]}: " + "; ".join(
        f"BN {r['plan']['bn']}, {r['ctas_per_sm']} CTAs/SM"
        f"{' (planned)' if r['planned'] else ''}: {r['ms'] * 1e3:.1f} us"
        for r in rows))
    return rows


def repeat_check(gen) -> dict:
    """Two bf16 calls on the same inputs must agree bit for bit (fixed-order
    sums, no atomics, across a cluster's CTAs too): B8's out, mu and rstd;
    B7's on its one-pass routes; B6's dx and part and B5's y and stats on
    ``"one_pass"``."""
    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gnk

    cases = {c[0]: c for c in CONV_MAIN + CONV_EXTRA}
    out = {}
    for name, fwd in [(n, False) for n in CONV_REPEAT] + [
            (n, True) for n in GN_FWD_REPEAT]:
        case = cases[name]
        _, kind, b, h, w, cin, cout, stride = case
        a = conv_inputs(gen, kind, b, h, w, cin, cout, torch.bfloat16)
        g = groups_for(cout)
        if fwd:
            call = lambda: gnk.launch_fwd(a["x"], a["scale"], a["bias"],  # noqa: E731
                                          g, 1e-5, True)
            what = "gn_fwd"
        elif kind == "gn":
            _, st = gnk.group_norm_fwd_reference(a["x"], a["scale"],
                                                 a["bias"], g, 1e-5, True)
            call = lambda: gnk.launch_bwd(a["x"], a["dy"], st, a["scale"],  # noqa: E731
                                          a["bias"], g, True)
            what = "gn_bwd"
        elif kind == "1x1":
            call = lambda: fb.launch_1x1(a["x"], a["w"], a["scale"],  # noqa: E731
                                         a["bias"], g, 1e-5, False, stride)
            what = "conv1x1"
        else:
            call = lambda: fb.launch_3x3(a["x"], a["w"], a["scale"],  # noqa: E731
                                         a["bias"], g)
            what = "conv3x3"
        first, second = call(), call()
        torch.cuda.synchronize()
        same = all(torch.equal(p, q) for p, q in zip(first, second))
        route = planned_route(case, torch.bfloat16, what)
        out[f"{what} {name}"] = {"kernel": what, "route": route,
                                 "bit_identical": same}
        if not same:
            raise AssertionError(f"{what} {name} ({route}): two calls on the "
                                 f"same inputs differ")
    log("conv repeat, bit for bit: " + ", ".join(
        f"{n} ({r['route']}) ok" for n, r in out.items()))
    return out


def phase_conv(report: dict) -> dict:
    """B5-B8 against their plain versions in every case and dtype, with
    and without ReLU; then timed at the ResNet-18 training shapes.
    Returns the four kernels' ``kernels``-line fields."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    worst = {"gn_fwd": 0.0, "gn_bwd": 0.0, "conv1x1": 0.0, "conv3x3": 0.0}
    which = {"y": "gn_fwd", "stats": "gn_fwd", "dx": "gn_bwd",
             "part": "gn_bwd"}
    per_case = {}
    for case in CONV_MAIN + CONV_EXTRA:
        name, kind = case[0], case[1]
        for dtype in (torch.bfloat16, torch.float32):
            for relu in (True, False):
                errs, used = check_conv_case(gen, case, dtype, relu)
                for key, err in errs.items():
                    if "@" in key:   # the older route, held but not reported
                        continue
                    kk = which.get(key, "conv1x1" if kind == "1x1"
                                   else "conv3x3")
                    worst[kk] = max(worst[kk], err)
                tag = f"{name}_{str(dtype)[6:]}_{'relu' if relu else 'norelu'}"
                route = planned_route(case, dtype)
                if kind == "gn":   # B5's route, then B6's
                    route = f"{planned_route(case, dtype, 'gn_fwd')}/{route}"
                per_case[tag] = {"route": route,
                                 "max_abs_err": errs, "allowance_used": used,
                                 "atol": CONV_TOL[dtype],
                                 "rtol": CONV_TOL[dtype]}
                log(f"conv {tag} ({route}): "
                    + ", ".join(f"{k} {errs[k]:.2e} ({100 * used[k]:.0f}%)"
                                for k in errs)
                    + f" (atol = rtol = {CONV_TOL[dtype]})")
        torch.cuda.empty_cache()
    report["conv_cases"] = per_case
    report["conv_repeat"] = repeat_check(gen)
    timing = {}
    for case in CONV_MAIN:
        timing[case[0]] = time_conv_case(gen, case)
        torch.cuda.empty_cache()
    # per training step: every main-path call of each kernel (forward
    # counts; B6 runs once per B5)
    per_step = {}
    for key in worst:
        fields = ("ms", "plain_ms", "library_ms", "bound_ms", "previous_ms")
        per_step[key] = {
            f: sum(CONV_PER_STEP[n] * t[key][f] for n, t in timing.items()
                   if key in t)
            for f in fields}
        log(f"conv per training step {key}: kernel "
            f"{per_step[key]['ms']:.4f} ms, plain "
            f"{per_step[key]['plain_ms']:.4f} ms, library "
            f"{per_step[key]['library_ms']:.4f} ms, bound "
            f"{per_step[key]['bound_ms']:.4f} ms, older route "
            f"{per_step[key]['previous_ms']:.4f} ms")
    report["conv_timing"] = timing
    report["conv_per_step"] = per_step
    res = {key: {**{k: timing[CONV_TIMED[key]][key][k] for k in (
        "ms", "sum_ms", "timed_by", "plain_ms", "library_ms", "bound_ms",
        "bound_by")},
        "max_abs_err": worst[key]} for key in worst}
    for key in ("conv1x1", "conv3x3", "gn_fwd", "gn_bwd"):
        t = timing[CONV_TIMED[key]][key]
        res[key].update(timed_route=t["route"], previous_ms=t["previous_ms"])
    return res


# ---------------------------------------------------------- resnet_train
RESNET_EPOCHS = 2


def resnet_train_config(epochs: int, precision: str = "bf16"):
    """``examples/img_cls/resnet/resnet.yml``'s values built in code (the
    card's machine reads no YAML), with ``epochs`` epochs."""
    from torchbooster_tpu_torch.config import (
        DatasetConfig,
        EnvConfig,
        LoaderConfig,
        OptimizerConfig,
        SchedulerConfig,
    )
    from torchbooster_tpu_torch.recipes.resnet import Config

    return Config(
        epochs=epochs, seed=42, depth=18, num_classes=10, clip=1.0,
        label_smoothing=0.1, pretrained="", freeze_backbone=False,
        env=EnvConfig(distributed=False, precision=precision, n_devices=0,
                      mesh="dp"),
        loader=LoaderConfig(batch_size=RN_B, num_workers=0, drop_last=True),
        optim=OptimizerConfig(name="adamw", lr=1e-3, weight_decay=1e-2),
        scheduler=SchedulerConfig(name="cycle", n_iter=160, warmup=16,
                                  decay=("lin", "cos")),
        dataset=DatasetConfig(name="cifar10", root="dataset/cifar10"))


def resnet_forward_flops(params: dict, size: int = 32) -> float:
    """Forward flops per image of a basic-block ResNet with the CIFAR
    stem: 2 per multiply-add of every conv and the head."""
    flops = 2 * size * size * params["stem"]["conv"]["kernel"].numel()
    hw = size
    for si in range(4):
        stage = params[f"stage{si}"]
        for bi in range(len(stage)):
            block = stage[f"block{bi}"]
            hw = hw // 2 if (bi == 0 and si > 0) else hw
            flops += 2 * hw * hw * sum(block[k]["kernel"].numel() for k in
                                       ("conv1", "conv2", "proj")
                                       if k in block)
    return float(flops + 2 * params["head"]["kernel"].numel())


def resnet_fp32_check() -> dict:
    """One fp32 forward + backward of the recipe's loss from the same
    parameters and batch, through B5-B8 (``fused="auto"``) and through
    ``fused=False`` with the plain GroupNorm: loss and gradient norm must
    agree."""
    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gnk
    from torchbooster_tpu_torch.recipes import resnet as recipe
    from torchbooster_tpu_torch.utils import tree_leaves

    t = recipe.setup(resnet_train_config(1, "fp32"))
    batch = recipe.to_device(next(iter(t.train_loader)), t.device)
    out = {}
    for route, kw in (("kernels", dict(fused="auto", gn_impl="auto")),
                      ("plain", dict(fused=False, gn_impl="plain"))):
        before = (gnk.launches_fwd, fb.launches_3x3)
        loss, _ = recipe.make_loss_fn(t.conf, train=True, **kw)(
            t.state.params, batch, None)
        loss.backward()
        leaves = tree_leaves(t.state.params)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad) for p in leaves])).item()
        out[route] = {"loss": loss.item(), "grad_norm": norm,
                      "launched": (gnk.launches_fwd, fb.launches_3x3)
                      != before}
        for p in leaves:
            p.grad = None
    if not out["kernels"]["launched"] or out["plain"]["launched"]:
        raise AssertionError(f"fp32 check took the wrong routes: {out}")
    # fp32 on both sides (TF32 off); they differ in the order of the conv
    # and moment sums only
    tol = 1e-4
    for key in ("loss", "grad_norm"):
        a, b = out["kernels"][key], out["plain"][key]
        if not (math.isfinite(a) and abs(a - b) <= tol * abs(b)):
            raise AssertionError(f"resnet fp32: kernels {key} {a} vs plain "
                                 f"{b} (rtol {tol})")
    out["rtol"] = tol
    log(f"resnet_train fp32 kernels vs plain: loss {out['kernels']['loss']:.6f}"
        f" / {out['plain']['loss']:.6f}, grad norm "
        f"{out['kernels']['grad_norm']:.6f} / {out['plain']['grad_norm']:.6f}"
        f" (rtol {tol})")
    return out


def resnet_breakdown(n_steps: int = 3) -> dict:
    """A fresh bf16 trainer: two warm steps, then ``n_steps`` steps as the
    recipe runs them (host fetch and augmentation included) under the
    profiler (CUDA activity): device busy share of the wall time, the
    device's own time per step, kernels per step, the share of B5-B8,
    and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from torchbooster_tpu_torch.recipes import resnet as recipe

    t = recipe.setup(resnet_train_config(1))
    batches = iter(t.train_loader)
    for _ in range(2):
        t.state, m = t.step(t.state, recipe.to_device(next(batches),
                                                      t.device))
    m["loss"].item()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            t.state, m = t.step(t.state, recipe.to_device(next(batches),
                                                          t.device))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    per_kernel = sorted(((e.key, e.self_device_time_total / 1e6)
                         for e in events), key=lambda kv: -kv[1])
    busy = sum(v for _, v in per_kernel)
    ours = sum(v for k, v in per_kernel if any(
        n in k for n in ("gn_fwd", "gn_bwd", "conv_mma", "conv_f32",
                         "group_moments", "conv_gn_sm90")))
    return {"steps": n_steps, "wall_s": wall, "step_ms": wall / n_steps * 1e3,
            "device_busy_s": busy, "device_busy_share": busy / wall,
            "device_ms_per_step": busy / n_steps * 1e3,
            "b5_b8_s": ours, "b5_b8_share_of_device": ours / max(busy, 1e-12),
            "kernels_per_step": sum(e.count for e in events) / n_steps,
            "top": per_kernel[:10]}


def phase_resnet_train(report: dict, smi: str) -> dict:
    """The ResNet recipe's ``main`` at the YAML's configuration on the
    card; returns B5-B8's launch counts from this run."""
    from torchbooster_tpu_torch.dataset import Split
    from torchbooster_tpu_torch.ops import fused_block as fb
    from torchbooster_tpu_torch.ops import group_norm as gnk
    from torchbooster_tpu_torch.recipes import resnet as recipe

    conf = resnet_train_config(RESNET_EPOCHS)
    n_eval = RESNET_EPOCHS * (len(conf.dataset.make(Split.TEST)) // RN_B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gnk.launches_fwd = gnk.launches_bwd = 0
    fb.launches_1x1 = fb.launches_3x3 = 0
    for counter in (gnk.launches_fwd_by_route, gnk.launches_bwd_by_route,
                    fb.launches_1x1_by_route, fb.launches_3x3_by_route):
        for route in counter:
            counter[route] = 0
    t0 = time.perf_counter()
    res = recipe.main(conf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"gn_fwd": gnk.launches_fwd, "gn_bwd": gnk.launches_bwd,
                "conv1x1": fb.launches_1x1, "conv3x3": fb.launches_3x3}
    by_route = {"gn_fwd": dict(gnk.launches_fwd_by_route),
                "gn_bwd": dict(gnk.launches_bwd_by_route),
                "conv1x1": dict(fb.launches_1x1_by_route),
                "conv3x3": dict(fb.launches_3x3_by_route)}
    peak = torch.cuda.max_memory_allocated()
    losses = [st["loss"] for st in res["steps"]]
    n_steps = len(losses)
    if n_steps != 32 or not all(map(math.isfinite, losses)):
        raise AssertionError(f"resnet_train: {n_steps} steps, losses "
                             f"{losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"resnet_train: the loss did not fall: {losses}")
    fwd = n_steps + n_eval
    expected = {"gn_fwd": 4 * fwd, "gn_bwd": 4 * n_steps,
                "conv1x1": 3 * fwd, "conv3x3": 13 * fwd}
    if launches != expected:
        raise AssertionError(f"resnet_train: launches {launches}, expected "
                             f"{expected} ({n_steps} steps, {n_eval} eval "
                             f"batches)")
    # B8: stages 0-1 (4 + 3 calls a forward) on clusters, 2-3 (3 + 3)
    # packed; B7: the 16² projection on a cluster, the 8² and 4² packed;
    # B5 and B6: every norm's forward and backward in one pass
    route_expected = {
        "gn_fwd": {"one_pass": 4 * fwd, "two_pass": 0},
        "gn_bwd": {"one_pass": 4 * n_steps, "two_pass": 0},
        "conv1x1": {"cluster": fwd, "pack": 2 * fwd, "mma_sync": 0, "f32": 0},
        "conv3x3": {"cluster": 7 * fwd, "pack": 6 * fwd, "mma_sync": 0,
                    "f32": 0}}
    if by_route != route_expected:
        raise AssertionError(f"resnet_train: routes {by_route}, expected "
                             f"{route_expected}")
    # steady state: the second epoch's training loop (its 16 steps, host
    # fetch and augmentation included, ended by reading its metrics)
    last = res["log"][-1]
    step_s = last["train_s"] / last["train_steps"]
    data_s = float(np.mean([st["data_s"] for st in res["steps"]
                            if st["epoch"] == last["epoch"]]))
    params = recipe.ResNet.init(0, 18, 10, "cifar", device="cpu")
    flops = 3.0 * resnet_forward_flops(params) * RN_B
    out = {"losses": losses, "launches": launches, "expected": expected,
           "by_route": by_route, "eval_batches": n_eval, "main_wall_s": wall,
           "step_ms": step_s * 1e3, "img_per_s": RN_B / step_s,
           "host_data_ms_per_step": data_s * 1e3,
           "model_flops_per_step": flops,
           "mfu_of_989_tflops": flops / step_s / BF16_FLOPS,
           "peak_mem_bytes": peak, "test_acc": res.get("test_acc"),
           "card": smi}
    log(f"resnet_train: ResNet-18 CIFAR, batch {RN_B}, {n_steps} steps, "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, test acc "
        f"{res.get('test_acc')}; step {out['step_ms']:.1f} ms, "
        f"{out['img_per_s']:.0f} img/s, host data {data_s * 1e3:.1f} ms per "
        f"step, model FLOP share {100 * out['mfu_of_989_tflops']:.2f}% of "
        f"989 TFLOP/s, peak mem {peak / 2**30:.2f} GiB; launches {launches}, "
        f"B5 by route {by_route['gn_fwd']}, "
        f"B6 by route {by_route['gn_bwd']}, B7 by route "
        f"{by_route['conv1x1']}, B8 by route {by_route['conv3x3']} [{smi}]")
    out["fp32_kernels_vs_plain"] = resnet_fp32_check()
    torch.cuda.empty_cache()
    b = out["breakdown"] = resnet_breakdown()
    log(f"resnet_train profiled: {b['steps']} steps, wall {b['wall_s']:.3f} s "
        f"({b['step_ms']:.1f} ms/step), device {b['device_ms_per_step']:.1f} "
        f"ms/step, busy {100 * b['device_busy_share']:.1f}%, "
        f"{b['kernels_per_step']:.0f} kernels per step, B5-B8 "
        f"{100 * b['b5_b8_share_of_device']:.1f}% of device time; top: "
        + "; ".join(f"{k[:60]} {v * 1e3:.1f} ms" for k, v in b["top"][:6]))
    report["resnet_train"] = out
    return {**launches, "by_route": by_route}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    phases = ap.parse_args().phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "smoke test needs a CUDA card", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "torchbooster_tpu_torch").is_dir():
        # never drive an installed copy: the smoke tests this checkout
        print(f"chip_smoke: no torchbooster_tpu_torch/ beside {root}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from torchbooster_tpu_torch.ops import _build
    from torchbooster_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report: dict = {"torch": torch.__version__, "cuda": torch.version.cuda}
    smi = smi_line()
    report["card"] = smi
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(x{torch.cuda.device_count()}), torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    blank = {"launches": 0, "max_abs_err": None, "ms": None, "sum_ms": None,
             "timed_by": None, "plain_ms": None, "bound_ms": None,
             "bound_by": None, "library_ms": None}
    kernel = {"name": "paged_attention", "route": "cuda",
              "source": "torchbooster_tpu_torch/ops/csrc/paged_decode_sm90.cu",
              "replaces": "torchbooster_tpu/ops/paged_attention.py:70",
              **blank, "timed_route": None,
              "launches_by_route": dict.fromkeys(("sm90", "simt"), 0),
              "launches_int8_pool": 0, "previous_ms": None}
    csrc = "torchbooster_tpu_torch/ops/csrc"
    flash = {key: {"name": name, "route": "cuda", "source": f"{csrc}/{src}",
                   "replaces": f"torchbooster_tpu/ops/flash_attention.py:{line}",
                   **blank}
             for key, name, src, line in (
                 ("fwd", "flash_fwd", "flash_fwd_sm90.cu", 104),
                 ("dq", "flash_dq", "flash_bwd_sm90.cu", 227),
                 ("dkv", "flash_dkv", "flash_bwd_sm90.cu", 265))}
    # the file each route's launches come from: "ms" and "source" are the
    # "sm90" kernels' (GPT-2 small's D 64); gpt-long's D 48 runs
    # flash_attention.cu's "mma_sync" kernels ("gpt_long" below)
    for key in flash:
        flash[key].update(timed_route=None, launches_by_route=None,
                          previous_ms=None, sources_by_route={
                              "sm90": flash[key]["source"],
                              "mma_sync": f"{csrc}/flash_attention.cu",
                              "f32": f"{csrc}/flash_attention.cu"})
    conv_kernels = {key: {"name": name, "route": "cuda",
                          "source": f"torchbooster_tpu_torch/ops/csrc/{src}",
                          "replaces": f"torchbooster_tpu/ops/{ref}", **blank}
                    for key, name, src, ref in (
                        ("gn_fwd", "gn_fwd", "group_norm_fwd_sm90.cu",
                         "group_norm.py:69"),
                        ("gn_bwd", "gn_bwd", "group_norm_bwd_sm90.cu",
                         "group_norm.py:106"),
                        ("conv1x1", "conv1x1_gn", "conv1x1_gn_sm90.cu",
                         "fused_block.py:70"),
                        ("conv3x3", "conv3x3_gn", "conv3x3_gn_sm90.cu",
                         "fused_block.py:238"))}
    for key in ("gn_fwd", "gn_bwd", "conv1x1", "conv3x3"):
        conv_kernels[key].update(timed_route=None, launches_by_route=None,
                                 previous_ms=None)
    t0 = time.perf_counter()
    if "build" in phases:
        # one nvcc per source, all started together
        from concurrent.futures import ThreadPoolExecutor

        t = time.perf_counter()
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            list(pool.map(_build.build, SOURCES))
        report["build_s"] = time.perf_counter() - t
        report["build_s_each"] = dict(_build.build_seconds)
        report["ptxas"] = {n: _build.ptxas_info.get(n, "") for n in SOURCES}
        log(f"build: {', '.join(f'{n}.cu {sec:.1f} s' for n, sec in _build.build_seconds.items())}"
            f" (in parallel, {report['build_s']:.1f} s)")
        for src, pattern in (
                ("paged_decode_sm90",
                 r"(paged_partials_sm90)ILi(\d+)ELi(\d+)E"
                 r"|(paged_merge_sm90)ILi(\d+)E"),
                ("flash_fwd_sm90", r"(flash_fwd_sm90)ILi(\d+)E"),
                ("flash_bwd_sm90", r"(flash_dq_sm90|flash_dkv_sm90)ILi(\d+)E"),
                ("conv1x1_gn_sm90", r"(conv_gn_sm90)ILi(\d+)ELi(\d+)E"),
                ("conv3x3_gn_sm90", r"(conv_gn_sm90)ILi(\d+)ELi(\d+)E"),
                ("group_norm_fwd_sm90", r"(gn_fwd_sm90)E"),
                ("group_norm_bwd_sm90", r"(gn_bwd_sm90)E")):
            regs = report[f"ptxas_{src}"] = ptxas_kernels(
                report["ptxas"][src], pattern)
            log(f"ptxas {src}: " + "; ".join(
                f"{n} {r.get('registers')} registers, spill stores "
                f"{r.get('spill_stores')} / loads {r.get('spill_loads')} "
                f"bytes" for n, r in sorted(regs.items())))
    if "kernel" in phases:
        res = phase_kernel(report)
        kernel.update({k: res[k] for k in ("max_abs_err", "ms", "sum_ms",
                                           "timed_by", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms", "timed_route",
                                           "previous_ms")})
    if "flash" in phases:
        res = phase_flash(report)
        for key in flash:
            flash[key].update({k: res[key][k] for k in (
                "max_abs_err", "ms", "sum_ms", "timed_by", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "timed_route",
                "previous_ms")})
            # the same kernel at gpt-long's geometry (D 48, "mma_sync")
            long = flash[key]["gpt_long"] = {k: res["long"][key][k] for k in (
                "max_abs_err", "ms", "timed_by", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "timed_route", "tflops")}
            long["source"] = flash[key]["sources_by_route"][long["timed_route"]]
    if set(SERVE_PHASES) & set(phases):
        params, cfg = gpt2_small()
        if "serve_fp32" in phases:
            match, launches, by_route = phase_serve(
                params, cfg, torch.float32, smi, report, "serve_fp32")
            kernel["launches"] += launches
            for r, n in by_route.items():
                kernel["launches_by_route"][r] += n
            if not all(match):
                raise AssertionError(f"fp32 paged serving disagrees with "
                                     f"dense generate on "
                                     f"{match.count(False)} requests")
        if "serve_bf16" in phases:
            _, launches, by_route = phase_serve(
                params, cfg, torch.bfloat16, smi, report, "serve_bf16",
                breakdown=True)
            kernel["launches"] += launches
            for r, n in by_route.items():
                kernel["launches_by_route"][r] += n
        for key, dtype, tree in (("serve_spec_bf16", torch.bfloat16, False),
                                 ("serve_spec_fp32", torch.float32, False),
                                 ("serve_tree", torch.bfloat16, True)):
            if key in phases:
                launches, by_route = phase_serve_spec(
                    params, cfg, dtype, smi, report, key, tree=tree)
                kernel["launches"] += launches
                for r, n in by_route.items():
                    kernel["launches_by_route"][r] += n
        if "serve_fork" in phases:
            launches, by_route = phase_serve_fork(params, cfg, smi, report)
            kernel["launches"] += launches
            for r, n in by_route.items():
                kernel["launches_by_route"][r] += n
        for key, phase in (("serve_structured", phase_serve_structured),
                           ("serve_wq", phase_serve_wq),
                           ("serve_lora", phase_serve_lora),
                           ("serve_spill", phase_serve_spill),
                           ("serve_disagg", phase_serve_disagg)):
            if key not in phases:
                continue
            launches, by_route, *int8_pool = phase(params, cfg, smi, report)
            kernel["launches"] += launches
            for r, n in by_route.items():
                kernel["launches_by_route"][r] += n
            kernel["launches_int8_pool"] += sum(int8_pool)
        # freed so that the train phase's peak memory is its own
        del params
        torch.cuda.empty_cache()
    # B1-B3 launch on three paths: GPT-2 small's training and the imported
    # GPT-2's fine-tunes (D 64, "sm90"), and gpt-long's (D 48,
    # "mma_sync"); the counts add up, as B4's do with the imported
    # model's serving
    for key, phase in (("train", phase_train),
                       ("gpt2_import", phase_gpt2_import),
                       ("train_long", phase_train_long)):
        if key not in phases:
            continue
        launches = phase(report, smi)
        if key == "gpt2_import":
            paged = launches["paged"]
            kernel["launches"] += paged["launches"]
            for r, n in paged["by_route"].items():
                kernel["launches_by_route"][r] += n
            launches = launches["flash"]
        for k in flash:
            flash[k]["launches"] += launches[k]
            if key == "train_long":
                flash[k].setdefault("gpt_long", {})["launches"] = launches[k]
            counts = flash[k]["launches_by_route"] or dict.fromkeys(
                ("sm90", "mma_sync", "f32"), 0)
            flash[k]["launches_by_route"] = {
                r: n + launches["by_route"][k][r] for r, n in counts.items()}
    if "conv" in phases:
        res = phase_conv(report)
        for key in conv_kernels:
            conv_kernels[key].update({k: res[key][k] for k in (
                "max_abs_err", "ms", "sum_ms", "timed_by", "plain_ms",
                "bound_ms", "bound_by", "library_ms")})
        for key in ("gn_fwd", "gn_bwd", "conv1x1", "conv3x3"):
            conv_kernels[key].update(timed_route=res[key]["timed_route"],
                                     previous_ms=res[key]["previous_ms"])
    if "resnet_train" in phases:
        launches = phase_resnet_train(report, smi)
        for key in conv_kernels:
            conv_kernels[key]["launches"] = launches[key]
        for key, counts in launches["by_route"].items():
            conv_kernels[key]["launches_by_route"] = counts
    report["wall_s"] = time.perf_counter() - t0
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                        default=str))
    log(smi)
    print(json.dumps({"kernels": [kernel, *flash.values(),
                                  *conv_kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
