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
   D 128 at S 1024, and non-causal bf16 and fp32 cases; B1 on the route
   ``plan_flash_fwd`` plans and B2 and B3 on the route ``plan_flash_bwd``
   plans (every bf16 case but D 32 on ``"sm90"``), two bf16 calls of each
   bit for bit; then time each kernel at the training geometry (profiler
   device time, or CUDA events around back-to-back calls where the
   profiler loses events) beside its plain version, its bound and SDPA
   (forward, and its backward), B1, B2 and B3 on ``"sm90"`` and on
   ``"mma_sync"`` on the same inputs, and sweep S for the ``"auto"``
   crossover against ``mha_reference``.
5. serve_fp32 — GPT-2 small, random seeded weights with a decisive head
   (tied embeddings x4), ``ServingConfig(page_size=64, n_pages=129,
   max_slots=8).make(...).run(...)`` on 8 requests (prompts 64-512
   tokens, 32 new tokens each); every request must equal the port's
   dense ``generate``, and the kernel must have launched on this path,
   every launch on ``"simt"`` (``"sm90"`` at bf16).
6. serve_bf16 — the same at bf16; prints decode tok/s, p50 TTFT and peak
   device memory beside the card's name and power limit, then replays the
   trace under the profiler for the device busy share and the top kernels.
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
   with the top kernels.
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
          "train", "conv", "resnet_train")
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
]
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
        # B1 on its planned route (every bf16 case but D 32 on "sm90")
        fwd_route = fa.plan_flash_fwd(dtype, d, s_q, s_kv, h // h_kv)
        if dtype == torch.bfloat16 and d != 32 and fwd_route != "sm90":
            raise AssertionError(f"flash case {name}: B1 planned "
                                 f"{fwd_route!r}, not 'sm90'")
        before = fa.launches_fwd_by_route[fwd_route]
        o, lse = fa.launch_fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        if fa.launches_fwd_by_route[fwd_route] != before + 1:
            raise AssertionError(f"flash case {name}: B1 did not take the "
                                 f"{fwd_route!r} route")
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, scale)
        # the backward pair on the same inputs: the plain forward's o/lse,
        # on the planned route (every bf16 case but D 32 on "sm90")
        route = fa.plan_flash_bwd(dtype, d, s_q, s_kv, h // h_kv)
        if dtype == torch.bfloat16 and d != 32 and route != "sm90":
            raise AssertionError(f"flash case {name}: planned {route!r}, "
                                 f"not 'sm90'")
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
        errs, used = {}, {}
        for key, got, want in (("o", o, o_ref), ("lse", lse, lse_ref),
                               ("dq", dq, dq_ref), ("dk", dk, dk_ref),
                               ("dv", dv, dv_ref)):
            got, want = got.float(), want.float()
            diff = (got - want).abs()
            errs[key] = diff.max().item()
            # the largest share of its allowance atol + rtol|want| that
            # any element uses: <= 1 is what torch.allclose accepts
            used[key] = (diff / (tol + tol * want.abs())).max().item()
            if not (used[key] <= 1.0 and math.isfinite(errs[key])):
                raise AssertionError(f"flash case {name}: {key} disagrees "
                                     f"with the plain version: max abs "
                                     f"err {errs[key]} (atol = rtol = "
                                     f"{tol})")
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
    # S 1024, D 64), each kernel beside its plain half and SDPA
    name, b, h, h_kv, s_q, s_kv, d, dtype, causal = FLASH_CASES[0]
    q, k, v, do = flash_inputs(gen, b, h, h_kv, s_q, s_kv, d, dtype)
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.launch_fwd(q, k, v, True, scale)
    _, delta = fa.launch_dq(q, k, v, o, lse, do, True, scale)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4, do4 = (t.reshape(b, -1, t.shape[1], d) for t in (q, k, v, do))
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
    pairs = b * h * visible_pairs(s_q, s_kv, True)
    el = torch.finfo(dtype).bits // 8
    n_q, n_kv = b * h * s_q * d, b * h_kv * s_kv * d
    rows = b * h * s_q
    # products per kernel (2 flops per multiply-add over D for each visible
    # pair): B1 QK^T, PV; B2 QK^T, dO V^T, dS K; B3 QK^T, dO V^T, P^T dO,
    # dS^T Q. Bytes: each input read once, each output written once.
    work = {"fwd": (2 * 2, (n_q + 2 * n_kv + n_q) * el + rows * 4),
            "dq": (3 * 2, (3 * n_q + 2 * n_kv + n_q) * el + rows * 8),
            "dkv": (4 * 2, (2 * n_q + 4 * n_kv) * el + rows * 8)}
    # B1, B2 and B3 on their earlier route, on the same inputs (outside
    # the main path's launch counts)
    previous = {
        "fwd": lambda: fa.launch_fwd(q, k, v, True, scale,
                                     route="mma_sync"),
        "dq": lambda: fa.launch_dq(q, k, v, o, lse, do, True, scale,
                                   route="mma_sync"),
        "dkv": lambda: fa.launch_dkv(q, k, v, lse, do, delta, True, scale,
                                     route="mma_sync")}
    timing = {}
    for key, (kern, plain, lib) in runs.items():
        call = {"kernel": cuda_ms(kern, iters=50),
                "plain": cuda_ms(plain, iters=10)}
        own = {}
        dev = {"kernel": device_ms(kern, iters=50, by_kernel=own),
               "plain": device_ms(plain, iters=10)}
        if lib is not None:
            call["library"] = cuda_ms(lib, iters=50)
            dev["library"] = device_ms(lib, iters=50)
        if key in previous:
            call["previous"] = cuda_ms(previous[key], iters=50)
            dev["previous"] = device_ms(previous[key], iters=50)
        stream = {}
        if all(dev.values()):
            src, timed_by = dev, DEVICE_TIME
        else:
            # the profiler lost events: time the calls back to back
            fns = {"kernel": kern, "plain": plain, "library": lib,
                   "previous": previous.get(key)}
            stream = {n: stream_ms(fn, iters=10 if n == "plain" else 50)
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
            "tflops": flops / src["kernel"] / 1e9,
            "max_abs_err": worst[key]}
        lib_txt = (f"; sdpa {src['library'] * 1e3:.1f} us"
                   if lib is not None else "")
        route_txt = ""
        if key in previous:
            timing[key].update(
                timed_route="sm90", previous_route="mma_sync",
                previous_ms=src["previous"],
                previous_tflops=flops / src["previous"] / 1e9)
            route_txt = (f" (route sm90); mma_sync {src['previous'] * 1e3:.1f}"
                         f" us, {timing[key]['previous_tflops']:.1f} TFLOP/s")
        log(f"flash timing {key} (bf16 MHA causal B{b} H{h} S{s_q} D{d}, "
            f"{timing[key]['timed_by']}): kernel {src['kernel'] * 1e3:.1f} "
            f"us{route_txt}; plain {src['plain'] * 1e3:.1f} us{lib_txt}; "
            f"bound {timing[key]['bound_ms'] * 1e3:.1f} us "
            f"({timing[key]['bound_by']}); achieved "
            f"{timing[key]['tflops']:.1f} TFLOP/s")
    # the SDPA yardstick's backward computes dQ, dK and dV in one call: it
    # stands beside B2 and B3 together
    timing["dkv"]["library_ms"] = timing["dq"]["library_ms"]
    timing["sdpa_fwd_bwd_ms"] = timing["fwd"]["library_ms"] \
        + timing["dq"]["library_ms"]
    log(f"flash timing B2 + B3: sm90 {(timing['dq']['ms'] + timing['dkv']['ms']) * 1e3:.1f}"
        f" us, mma_sync {(timing['dq']['previous_ms'] + timing['dkv']['previous_ms']) * 1e3:.1f}"
        f" us, sdpa backward {timing['dq']['library_ms'] * 1e3:.1f} us")
    report["flash_timing"] = timing
    report["auto_crossover"] = crossover()
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
    pa.launches = 0
    pa.launches_by_route.update(dict.fromkeys(pa.launches_by_route, 0))
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


def dense_tokens(params, cfg, reqs, dtype):
    from torchbooster_tpu_torch.models.gpt import generate

    out = []
    for r in reqs:
        ids = torch.as_tensor(r.prompt, device="cuda").long()[None]
        full = generate(params, ids, cfg, n_new=N_NEW, temperature=0.0,
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
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    for counts in (fa.launches_fwd_by_route, fa.launches_dq_by_route,
                   fa.launches_dkv_by_route):
        for route in counts:
            counts[route] = 0
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
              "previous_ms": None}
    csrc = "torchbooster_tpu_torch/ops/csrc"
    flash = {key: {"name": name, "route": "cuda", "source": f"{csrc}/{src}",
                   "replaces": f"torchbooster_tpu/ops/flash_attention.py:{line}",
                   **blank}
             for key, name, src, line in (
                 ("fwd", "flash_fwd", "flash_fwd_sm90.cu", 104),
                 ("dq", "flash_dq", "flash_bwd_sm90.cu", 227),
                 ("dkv", "flash_dkv", "flash_bwd_sm90.cu", 265))}
    for key in flash:
        flash[key].update(timed_route=None, launches_by_route=None,
                          previous_ms=None)
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
    if "serve_fp32" in phases or "serve_bf16" in phases:
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
        # freed so that the train phase's peak memory is its own
        del params
        torch.cuda.empty_cache()
    if "train" in phases:
        launches = phase_train(report, smi)
        for key in flash:
            flash[key]["launches"] = launches[key]
        for key in flash:
            flash[key]["launches_by_route"] = launches["by_route"][key]
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
