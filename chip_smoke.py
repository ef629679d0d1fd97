"""On-card smoke test of the PyTorch/CUDA port (``torchbooster_tpu_torch``).

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases device,build,kernel

Phases, in order; any failure exits non-zero and prints no result:

1. device  — require a CUDA card; print ``nvidia-smi`` name and power limit.
2. build   — compile the port's CUDA sources (nvcc, sm_90a) and time it.
3. kernel  — hold the paged flash-decode kernel against its plain PyTorch
   version at GPT-2-small width (H=12, Dh=64, 64-token pages, 129 pages,
   8 slots): MHA and GQA (4 kv heads), bf16/fp32/int8 pools, S=1 decode,
   S=5 linear verify, a tree-verify mask, and a prefix page shared by two
   lanes; then time it (profiler device time, and CUDA events per call)
   beside its plain version, its bound and ``scaled_dot_product_attention``
   over the same context, each timed call reading another of 12 layer
   pools as the decode step does.
4. serve_fp32 — GPT-2 small, random seeded weights with a decisive head
   (tied embeddings x4), ``ServingConfig(page_size=64, n_pages=129,
   max_slots=8).make(...).run(...)`` on 8 requests (prompts 64-512
   tokens, 32 new tokens each); every request must equal the port's
   dense ``generate``, and the kernel must have launched on this path.
5. serve_bf16 — the same at bf16; prints decode tok/s, p50 TTFT and peak
   device memory beside the card's name and power limit, then replays the
   trace under the profiler for the device busy share and the top kernels.

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

PHASES = ("device", "build", "kernel", "serve_fp32", "serve_bf16")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM published HBM3 rate
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core rate
DEV = "cuda"
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


def device_ms(fn, iters: int = 50) -> float:
    """Milliseconds of device (kernel) time per call, from the profiler:
    the sum of every kernel's own device time over ``iters`` calls. The
    host-side launch cost, which :func:`cuda_ms` includes, is left out.
    Returns 0.0 when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages())
    return total_us / iters / 1e3


# ---------------------------------------------------------------- kernel
def make_case(rs, *, kv_heads, pool, q_dtype, s_q, tree, shared, lens=None):
    """A pool, a compacted work list and queries at serving geometry.
    ``shared``: slots 0 and 1 share their first two (full) pages, listed
    once in the work list with both slots on its lanes."""
    from torchbooster_tpu_torch.models.gpt import _quantize_kv

    dev = DEV
    lens = np.asarray(lens if lens is not None
                      else rs.randint(64, 600, SLOTS), np.int64)
    if shared:
        lens[:2] = np.maximum(lens[:2], 2 * PS + 1)
    n_lanes = SLOTS if shared else 1
    free = list(rs.permutation(np.arange(1, N_PAGES)))
    table = {}
    for s in range(SLOTS):
        need = -(-int(lens[s] + s_q) // PS)
        table[s] = [int(free.pop()) for _ in range(need)]
    if shared:
        table[1][:2] = table[0][:2]
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
    ]
    worst = 0.0
    per_case = {}
    for name, spec in cases:
        case = make_case(rs, **spec)
        args, kw = kernel_inputs(case)
        got = pa.paged_attention(*args, **kw)
        torch.cuda.synchronize()
        want = pa.paged_attention_reference(*args, **kw)
        err = (got.float() - want.float()).abs().max().item()
        if spec["q_dtype"] == torch.bfloat16:
            atol = rtol = 2e-2
        else:
            atol, rtol = 1e-4, 1e-4
        ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
        per_case[name] = {"max_abs_err": err, "atol": atol, "rtol": rtol,
                          "live_pages": case["n_live"]}
        log(f"kernel {name}: max_abs_err={err:.3e} (atol {atol}, rtol "
            f"{rtol}) live_pages={case['n_live']}")
        if not ok or not math.isfinite(err):
            raise AssertionError(f"kernel case {name} disagrees with "
                                 f"paged_attention_reference: {err}")
        worst = max(worst, err)
    report["kernel_cases"] = per_case

    # timing at the main path's shapes: bf16 MHA decode, one lane, the
    # serving prompts mid-decode. A decode step reads a different
    # layer's pool on each launch, so every timed call rotates over
    # N_LAYERS copies (over 300 MB, past the 50 MB L2) as the step does.
    lens = np.asarray(PROMPT_LENS) + N_NEW // 2
    case = make_case(rs, kv_heads=12, pool="bf16", q_dtype=torch.bfloat16,
                     s_q=1, tree=False, shared=False, lens=lens)
    args, kw = kernel_inputs(case)
    q, pk, pv, rest = args[0], args[1], args[2], args[3:]
    layers = [(pk.clone(), pv.clone()) for _ in range(N_LAYERS)]
    turn = itertools.count()

    def run_kernel():
        lk, lv = layers[next(turn) % N_LAYERS]
        return pa.paged_attention(q, lk, lv, *rest, **kw)

    def run_plain():
        lk, lv = layers[next(turn) % N_LAYERS]
        return pa.paged_attention_reference(q, lk, lv, *rest, **kw)

    # yardstick only: SDPA over the same context gathered dense (padded
    # to the longest slot, masked); the gather is outside the timing
    wp = case["work_pages"].long()
    max_len = int(lens.max()) + 1
    wr = case["work_refs"].cpu().numpy()
    wpos = case["work_pos"].cpu().numpy()
    dense = []
    for lk, lv in layers:
        kd = torch.zeros(SLOTS, H, max_len, DH, device="cuda",
                         dtype=torch.bfloat16)
        vd = torch.zeros_like(kd)
        for i in range(case["n_live"]):
            s, base = int(wr[i, 0]), int(wpos[i]) * PS
            n = min(PS, max_len - base)
            if n > 0:
                kd[s, :, base:base + n] = lk[wp[i], :n].transpose(0, 1)
                vd[s, :, base:base + n] = lv[wp[i], :n].transpose(0, 1)
        dense.append((kd, vd))
    mask = (torch.arange(max_len, device="cuda")[None, :]
            <= torch.as_tensor(lens, device="cuda")[:, None])
    qd = q.transpose(1, 2)                               # (slots, H, 1, Dh)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    attn_mask = mask[:, None, None, :]

    def run_library():
        kd, vd = dense[next(turn) % N_LAYERS]
        return sdpa(qd, kd, vd, attn_mask=attn_mask)

    # device time (profiler) is the kernel's own time; call time (CUDA
    # events around each call) adds the host launch path
    call = {"kernel": cuda_ms(run_kernel, iters=200),
            "plain": cuda_ms(run_plain, iters=50),
            "library": cuda_ms(run_library, iters=200)}
    dev = {"kernel": device_ms(run_kernel, iters=200),
           "plain": device_ms(run_plain, iters=50),
           "library": device_ms(run_library, iters=200)}
    src = dev if all(dev.values()) else call
    ms, plain_ms, library_ms = src["kernel"], src["plain"], src["library"]
    # the bound counts what these inputs need: each slot's visible K/V
    # tokens (lengths + 1) read once, q read and the output written once,
    # plus the work list and lengths
    visible = int((lens + 1).sum())
    kv_bytes = 2 * visible * H * DH * 2                   # K and V, bf16
    io_bytes = 2 * SLOTS * H * DH * 2 + wp.numel() * 4 * 3 + SLOTS * 4
    flops = 4 * H * DH * visible
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
              "timed_by": "profiler device time" if src is dev
              else "CUDA events per call", "call_ms": call,
              "device_ms": dev,
              "bound_ms": max(t_bytes, t_ops),
              "bound_by": "bytes" if t_bytes >= t_ops else "operations",
              "live_pages": case["n_live"], "visible_tokens": visible,
              "bytes": kv_bytes + io_bytes, "flops": flops}
    log(f"kernel timing (bf16 MHA decode, {case['n_live']} live pages, "
        f"{timing['timed_by']}): {ms * 1e3:.2f} us; plain "
        f"{plain_ms * 1e3:.2f} us; sdpa over dense gather "
        f"{library_ms * 1e3:.2f} us; bound {timing['bound_ms'] * 1e3:.2f} "
        f"us ({timing['bound_by']}); per-call (events) kernel "
        f"{call['kernel'] * 1e3:.1f} us, plain {call['plain'] * 1e3:.1f} "
        f"us, sdpa {call['library'] * 1e3:.1f} us")
    report["kernel_timing"] = timing
    return {"max_abs_err": worst, **timing}


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
    metrics = batcher.run(reqs)
    torch.cuda.synchronize()
    launches = pa.launches
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
    return batcher, reqs, metrics, launches


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
    device busy share of the wall time and the top kernels by device
    time. The profiled run is not the one the tok/s figures come from."""
    from torch.profiler import ProfilerActivity, profile

    reqs = requests(cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = batcher.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = sorted(((e.key, e.self_device_time_total / 1e6)
                         for e in prof.key_averages()
                         if e.self_device_time_total > 0),
                        key=lambda kv: -kv[1])
    busy = sum(t for _, t in per_kernel)
    paged = sum(t for k, t in per_kernel if "paged_" in k)
    return {"wall_s": wall, "device_busy_s": busy,
            "device_busy_share": busy / wall, "paged_kernel_s": paged,
            "paged_share_of_device": paged / max(busy, 1e-12),
            "decode_s": m["elapsed_s"], "top": per_kernel[:8]}


def phase_serve(params, cfg, dtype, smi: str, report: dict, key: str,
                breakdown: bool = False):
    batcher, reqs, m, launches = serve(params, cfg, dtype)
    dense = dense_tokens(params, cfg, reqs, dtype)
    match = [r.tokens == d for r, d in zip(reqs, dense)]
    n_steps = launches // cfg.n_layers
    report[key] = {"metrics": m, "launches": launches,
                   "launches_per_step": cfg.n_layers,
                   "decode_steps": n_steps, "token_match": match,
                   "card": smi}
    log(f"{key}: {sum(match)}/{len(match)} requests token-exact vs dense "
        f"generate; kernel launches {launches} ({cfg.n_layers} per decode "
        f"step); decode {m['decode_tok_s']} tok/s, p50 TTFT "
        f"{m['ttft_p50_s']} s, peak mem {m['peak_mem_bytes'] / 2**20:.1f} "
        f"MiB [{smi}]")
    if breakdown:
        b = report[key]["breakdown"] = device_breakdown(batcher, cfg)
        log(f"{key} profiled replay: wall {b['wall_s']:.3f} s, device busy "
            f"{b['device_busy_s']:.4f} s ({100 * b['device_busy_share']:.1f}"
            f"%), paged kernel {b['paged_kernel_s']:.5f} s "
            f"({100 * b['paged_share_of_device']:.1f}% of device time)")
    return match, launches


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
    kernel = {"name": "paged_attention", "route": "cuda",
              "source": "torchbooster_tpu_torch/ops/csrc/paged_attention.cu",
              "replaces": "torchbooster_tpu/ops/paged_attention.py:70",
              "launches": 0, "max_abs_err": None, "ms": None,
              "plain_ms": None, "bound_ms": None, "bound_by": None,
              "library_ms": None}
    t0 = time.perf_counter()
    if "build" in phases:
        t = time.perf_counter()
        _build.build("paged_attention")
        report["build_s"] = time.perf_counter() - t
        report["ptxas"] = _build.ptxas_info.get("paged_attention", "")
        log(f"build: paged_attention.cu in {report['build_s']:.1f} s")
    if "kernel" in phases:
        res = phase_kernel(report)
        kernel.update({k: res[k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms")})
    if "serve_fp32" in phases or "serve_bf16" in phases:
        params, cfg = gpt2_small()
    if "serve_fp32" in phases:
        match, launches = phase_serve(params, cfg, torch.float32, smi,
                                      report, "serve_fp32")
        kernel["launches"] = launches
        if not all(match):
            raise AssertionError(f"fp32 paged serving disagrees with dense "
                                 f"generate on {match.count(False)} requests")
    if "serve_bf16" in phases:
        _, launches = phase_serve(params, cfg, torch.bfloat16, smi, report,
                                  "serve_bf16", breakdown=True)
        kernel["launches"] = kernel["launches"] or launches
    report["wall_s"] = time.perf_counter() - t0
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                        default=str))
    log(smi)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
