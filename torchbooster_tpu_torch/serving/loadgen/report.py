"""SLO conformance reports: the comparable artifact a replay leaves
behind, and the regression gate that diffs two of them — a copy of
``torchbooster_tpu/serving/loadgen/report.py``.

A load test that prints one tokens/s number hides everything the SLO
scheduler is for. The report aggregates a replay's per-request
outcomes into the serving-paper metric set: per-class TTFT/TPOT
p50/p90/p99, **goodput** (tokens of completed requests that HIT their
TTFT deadline, per wall second — tokens served late count for
nothing), shed/cancel/preemption rates, and the workload content
fingerprint — so two A/B arms can PROVE they served the identical
trace before anyone compares their numbers
(:func:`fingerprints_comparable` is the one comparability predicate
``bench.py`` and ``scripts/ab_summary.py`` share).

:func:`max_sustainable_speed` binary-searches the time-compression
axis for the largest ×-factor a serving stack still meets its SLOs at
— the capacity headline ("this config sustains 6.5× the captured
load") every later perf PR can regress-test against.
:func:`diff_reports` + ``scripts/replay_diff.py`` are that gate: diff
a candidate report against a baseline, refuse fingerprint mismatches,
flag goodput/deadline/latency regressions beyond tolerance.

Pure host-side aggregation over finished outcomes (numpy + json; no
device reads, no clocks).
"""
from __future__ import annotations

import numpy as np

__all__ = ["conformance_report", "diff_reports",
           "fingerprints_comparable", "max_sustainable_speed"]

REPORT_VERSION = 1


def _pct(vals: list, q: float) -> float | None:
    """Percentile over measured samples — ``None`` (JSON null) when
    nothing was measured: an all-shed class must not report a
    fake-perfect 0.0 latency (which would also make every later real
    measurement read as a regression against it)."""
    if not vals:
        return None
    arr = np.asarray(vals, np.float64)
    return round(np.percentile(arr, q).tolist(), 6)


def _class_block(outs: list, wall_s: float) -> dict:
    ttfts = [o["ttft_s"] for o in outs if o["ttft_s"] is not None]
    tpots = [o["tpot_s"] for o in outs if o["tpot_s"] is not None]
    judged = [o for o in outs if o["deadline_hit"] is not None]
    hit_tokens = sum(
        o["n_tokens"] for o in outs
        if not o["shed"] and not o["cancelled"]
        and not o.get("errored")
        and o["deadline_hit"] is not False)
    return {
        "n": len(outs),
        "n_completed": sum(
            1 for o in outs if not o["shed"] and not o["cancelled"]
            and not o.get("errored")),
        "n_shed": sum(1 for o in outs if o["shed"]),
        "n_cancelled": sum(1 for o in outs if o["cancelled"]),
        "n_errors": sum(1 for o in outs if o.get("errored")),
        "n_tokens": sum(o["n_tokens"] for o in outs),
        "ttft_p50_s": _pct(ttfts, 50),
        "ttft_p90_s": _pct(ttfts, 90),
        "ttft_p99_s": _pct(ttfts, 99),
        "tpot_p50_s": _pct(tpots, 50),
        "tpot_p90_s": _pct(tpots, 90),
        "tpot_p99_s": _pct(tpots, 99),
        "deadline_hit_rate": round(
            sum(1 for o in judged if o["deadline_hit"])
            / len(judged), 4) if judged else 1.0,
        "goodput_tok_s": round(hit_tokens / max(wall_s, 1e-9), 2),
    }


def conformance_report(workload, outcomes: list, *, speed: float,
                       mode: str, elapsed_s: float, wall_s: float,
                       n_preemptions: int | None = None) -> dict:
    """Aggregate one replay's outcomes into the comparable report.

    ``elapsed_s`` is the driver's latency timebase (virtual seconds
    for the deterministic in-process driver, wall for HTTP);
    ``wall_s`` is always real seconds and is the denominator of every
    tokens/s figure — virtual throughput would be meaningless.
    **Goodput** counts only tokens of completed requests whose TTFT
    deadline was met (deadline-free completions count; shed and
    cancelled requests never do)."""
    by_cls: dict[str, list] = {}
    for o in outcomes:
        by_cls.setdefault(o["cls"], []).append(o)
    total = _class_block(outcomes, wall_s)
    out = {
        "version": REPORT_VERSION,
        "mode": mode,
        "speed": round(float(speed), 4),
        "workload_fingerprint": workload.fingerprint(),
        "workload_kind": workload.kind,
        "n_requests": total["n"],
        "n_completed": total["n_completed"],
        "n_shed": total["n_shed"],
        "n_cancelled": total["n_cancelled"],
        "n_errors": total["n_errors"],
        "n_tokens": total["n_tokens"],
        "shed_rate": round(total["n_shed"] / max(total["n"], 1), 4),
        "cancel_rate": round(
            total["n_cancelled"] / max(total["n"], 1), 4),
        "error_rate": round(
            total["n_errors"] / max(total["n"], 1), 4),
        "deadline_hit_rate": total["deadline_hit_rate"],
        "goodput_tok_s": total["goodput_tok_s"],
        "total_tok_s": round(
            total["n_tokens"] / max(wall_s, 1e-9), 2),
        "elapsed_s": round(float(elapsed_s), 4),
        "wall_s": round(float(wall_s), 4),
        "classes": {cls: _class_block(outs, wall_s)
                    for cls, outs in sorted(by_cls.items())},
    }
    if n_preemptions is not None:
        out["n_preemptions"] = int(n_preemptions)
        out["preemption_rate"] = round(
            n_preemptions / max(total["n"], 1), 4)
    return out


def fingerprints_comparable(a: dict | None, b: dict | None) -> bool:
    """THE comparability predicate: two result/report dicts may be
    compared unless BOTH carry a ``workload_fingerprint`` and the
    hashes differ — then they measured different traffic and any
    delta between their numbers is noise dressed as evidence.
    (Results without fingerprints — the resnet/gpt families — stay
    comparable as before.)"""
    fa = (a or {}).get("workload_fingerprint")
    fb = (b or {}).get("workload_fingerprint")
    return fa is None or fb is None or fa == fb


def max_sustainable_speed(run_at, ok=None, lo: float = 1.0,
                          hi: float = 16.0, iters: int = 5) -> float:
    """Binary search the time-compression axis for the largest
    ×-factor where ``ok(report)`` still holds. ``run_at(speed)``
    replays the workload and returns its report; the default verdict
    is "nothing shed and ≥95% of judged deadlines hit". Returns 0.0
    when even ``lo`` fails (the stack cannot sustain the trace as
    captured), ``hi`` when the whole range passes — widen the bracket
    if that happens, the search cannot see past it."""
    if lo <= 0 or hi <= lo:
        raise ValueError(
            f"need 0 < lo < hi, got lo={lo}, hi={hi}")
    if ok is None:
        ok = lambda rep: (rep["n_shed"] == 0
                          and rep.get("n_errors", 0) == 0
                          and rep["deadline_hit_rate"] >= 0.95)
    if not ok(run_at(lo)):
        return 0.0
    if ok(run_at(hi)):
        return round(hi, 2)
    good, bad = lo, hi
    for _ in range(max(iters, 1)):
        mid = (good + bad) / 2.0
        if ok(run_at(mid)):
            good = mid
        else:
            bad = mid
    return round(good, 2)


# metric: (direction, kind). "higher"/"lower" = which way is BETTER;
# rates diff absolutely (a 0 baseline must still catch a rise),
# latencies/throughputs relatively
_DIFF_METRICS = {
    "goodput_tok_s": ("higher", "rel"),
    "total_tok_s": ("higher", "rel"),
    "deadline_hit_rate": ("higher", "abs"),
    "shed_rate": ("lower", "abs"),
    "error_rate": ("lower", "abs"),
}
_CLASS_METRICS = {
    "ttft_p99_s": ("lower", "rel"),
    "tpot_p99_s": ("lower", "rel"),
    "deadline_hit_rate": ("higher", "abs"),
    "goodput_tok_s": ("higher", "rel"),
}


def _regressed(base, cand, direction: str, kind: str,
               tol: float) -> bool:
    if base is None or cand is None:
        return False
    if kind == "abs":
        margin = tol
    else:
        margin = tol * abs(base)
    if direction == "higher":
        return cand < base - margin
    return cand > base + margin


def diff_reports(base: dict, cand: dict,
                 tol: float = 0.10) -> list[str]:
    """Flag SLO regressions of ``cand`` vs ``base``; returns
    human-readable regression lines (empty = clean). Raises when the
    fingerprints differ — reports over different traces are not
    comparable, and silently diffing them is how bogus regressions
    (and bogus all-clears) get shipped."""
    if not fingerprints_comparable(base, cand):
        raise ValueError(
            f"workload fingerprints differ (base "
            f"{base.get('workload_fingerprint')!r} vs candidate "
            f"{cand.get('workload_fingerprint')!r}): the two reports "
            "served different traces and cannot be compared — replay "
            "the same capture through both arms")
    out: list[str] = []
    for key, (direction, kind) in _DIFF_METRICS.items():
        b, c = base.get(key), cand.get(key)
        if _regressed(b, c, direction, kind, tol):
            out.append(f"{key}: {b} -> {c} "
                       f"({'dropped' if direction == 'higher' else 'rose'}"
                       f" beyond tol={tol})")
    base_cls = base.get("classes", {})
    cand_cls = cand.get("classes", {})
    for cls in sorted(set(base_cls) & set(cand_cls)):
        for key, (direction, kind) in _CLASS_METRICS.items():
            b, c = base_cls[cls].get(key), cand_cls[cls].get(key)
            if _regressed(b, c, direction, kind, tol):
                out.append(
                    f"classes.{cls}.{key}: {b} -> {c} "
                    f"({'dropped' if direction == 'higher' else 'rose'}"
                    f" beyond tol={tol})")
    return out
