"""SLO burn-rate engine: multi-window alerting over the serving SLO
series — a copy of ``torchbooster_tpu/observability/slo.py`` over the
port's registry.

The batcher's SLO policy already lands per-class deadline outcomes in
the registry (``serving_slo_deadline_hit_total`` /
``serving_slo_deadline_miss_total``, labelled ``cls`` + ``kind``) and
token throughput in ``serving_decode_tokens_total`` — raw material,
not a signal: an operator (or ROADMAP item 5's autoscaler) needs to
know *how fast the error budget is burning*, not the lifetime totals.

:class:`SLOBurnEngine` closes that gap with the standard SRE
multi-window burn-rate construction:

- each :meth:`tick` (the exporter cadence) samples the cumulative
  per-class hit/miss counters and the fleet token counter onto a
  bounded ring;
- the **burn rate** over a window is the windowed deadline-miss rate
  divided by the error budget (``1 - target``): burn 1.0 = missing
  exactly the budgeted fraction, burn N = burning budget N× too fast;
- an alert FIRES for a class only when BOTH the fast and the slow
  window burn at ``fire_burn`` or above (the fast window gives
  detection latency, the slow window vetoes blips), and RESOLVES when
  the fast window drops under ``resolve_burn`` — the classic
  conjunction that keeps pages non-flappy;
- optionally (``goodput_floor_tok_s > 0``) a fleet-level **goodput**
  alert fires under the same two-window rule when windowed decode
  throughput sits below the floor.

Every tick refreshes ``slo_burn_rate{cls,window}`` and
``slo_goodput_tok_s{window}`` gauges plus the alert counters/gauge,
and every FSM transition emits one structured ``slo_alert`` event
through the sink (``JsonlExporter.write``-shaped callable), so the
JSONL log carries firing/resolved edges alongside the metrics lines.

Host arithmetic only: the engine reads registry series (already
host-side, deferred-drained) and never touches the device or the
wall clock — windowing uses ``perf_counter`` (durations, the
host-sync rule's own doctrine) and tests/replays pass explicit
``now`` values.
"""
from __future__ import annotations

import time
from collections import deque

from torchbooster_tpu_torch.observability.registry import (
    Registry,
    get_registry,
)

__all__ = ["SLOBurnEngine"]

# bounded sample history: at the default 10 s export cadence this
# spans > 5 h, far past any slow window worth alerting on
_MAX_TICKS = 2048


def _series_totals(metric) -> dict[tuple, float]:
    """``{label_key: running_total}`` for every series of a family —
    read-only (never materializes label combinations the way
    ``value(**labels)`` would)."""
    out: dict[tuple, float] = {}
    for key, series in metric.series_items():
        _, total, _, _, _ = series.read()
        out[key] = total
    return out


class SLOBurnEngine:
    """Multi-window burn-rate alerting (see module docstring).

    ``target`` is the deadline-hit-rate objective (0.99 = 1% error
    budget). ``sink`` is an optional callable taking one event dict
    per alert transition (wire ``JsonlExporter.write`` here).
    Constructing the engine registers its metric families; every
    gauge/counter write stays one branch when the registry is
    disabled."""

    def __init__(self, registry: Registry | None = None, *,
                 target: float = 0.99,
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 600.0,
                 fire_burn: float = 2.0,
                 resolve_burn: float = 1.0,
                 goodput_floor_tok_s: float = 0.0,
                 sink=None):
        if not (0.0 < target < 1.0):
            raise ValueError(
                f"slo.target must be in (0, 1), got {target}")
        if fast_window_s <= 0 or slow_window_s <= fast_window_s:
            raise ValueError(
                f"need 0 < fast_window_s < slow_window_s, got "
                f"{fast_window_s} / {slow_window_s}")
        if resolve_burn > fire_burn:
            raise ValueError(
                f"resolve_burn ({resolve_burn}) must not exceed "
                f"fire_burn ({fire_burn}) — the hysteresis inverts")
        self.registry = registry if registry is not None \
            else get_registry()
        self.target = float(target)
        self.budget = 1.0 - self.target
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fire_burn = float(fire_burn)
        self.resolve_burn = float(resolve_burn)
        self.goodput_floor_tok_s = float(goodput_floor_tok_s)
        self.sink = sink
        reg = self.registry
        self._g_burn = reg.gauge(
            "slo_burn_rate",
            "error-budget burn rate of the class's deadline-miss "
            "rate over the window (labels cls, window=fast|slow; "
            "1.0 = burning exactly the budget)")
        self._g_goodput = reg.gauge(
            "slo_goodput_tok_s",
            "windowed decode token throughput (label "
            "window=fast|slow)")
        self._g_active = reg.gauge(
            "slo_alert_active",
            "1 while the class's burn-rate alert is firing "
            "(label cls; goodput alert under cls=goodput)")
        self._c_fired = reg.counter(
            "slo_alerts_fired_total",
            "burn-rate alert firing transitions (label cls)")
        self._c_resolved = reg.counter(
            "slo_alerts_resolved_total",
            "burn-rate alert resolved transitions (label cls)")
        # per-class cumulative (t, hits, misses) samples + fleet
        # (t, tokens) samples, oldest -> newest
        self._samples: dict[str, deque] = {}
        self._tok_samples: deque = deque(maxlen=_MAX_TICKS)
        self._active: dict[str, bool] = {}
        self._t0: float | None = None
        self.n_ticks = 0
        self.n_fired = 0
        self.n_resolved = 0
        self.burns: dict[tuple[str, str], float] = {}
        self.goodput: dict[str, float] = {}

    # ---- sampling -------------------------------------------------
    def _read_outcomes(self) -> dict[str, tuple[float, float]]:
        """Per-class cumulative ``(hits, misses)`` summed over the
        ``kind`` label (ttft + tpot outcomes burn ONE budget — a
        class's user experience, not two separate ledgers)."""
        reg = self.registry
        hit = _series_totals(reg.counter(
            "serving_slo_deadline_hit_total",
            "requests meeting their class deadline (labels cls, "
            "kind=ttft|tpot)"))
        miss = _series_totals(reg.counter(
            "serving_slo_deadline_miss_total",
            "requests missing their class deadline (labels cls, "
            "kind=ttft|tpot)"))
        out: dict[str, list[float]] = {}
        for totals, idx in ((hit, 0), (miss, 1)):
            for key, total in totals.items():
                cls = dict(key).get("cls")
                if cls is None:
                    continue
                out.setdefault(cls, [0.0, 0.0])[idx] += total
        return {cls: (h, m) for cls, (h, m) in out.items()}

    def _read_tokens(self) -> float:
        totals = _series_totals(self.registry.counter(
            "serving_decode_tokens_total", "decoded tokens"))
        return sum(totals.values())

    @staticmethod
    def _window_delta(samples, now: float,
                      window: float) -> tuple | None:
        """Delta between the newest sample and the oldest one inside
        ``[now - window, now]`` — ``None`` until two samples span the
        window's edge (no data is not burn 0, it is unknown)."""
        if len(samples) < 2:
            return None
        cutoff = now - window
        base = None
        for row in samples:
            if row[0] >= cutoff:
                base = row
                break
        newest = samples[-1]
        if base is None or base is newest:
            return None
        dt = newest[0] - base[0]
        if dt <= 0:
            return None
        return tuple(n - b for n, b in zip(newest[1:], base[1:])) \
            + (dt,)

    # ---- the tick -------------------------------------------------
    def tick(self, now: float | None = None) -> dict:
        """Sample the SLO series, refresh the burn/goodput gauges,
        and run the alert FSM (emitting transition events through the
        sink). Returns ``{(cls, window): burn}`` for introspection.
        ``now`` defaults to ``perf_counter()`` — pass explicit values
        under replay/test clocks."""
        if now is None:
            now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        self.n_ticks += 1
        # prune + append this tick's cumulative samples
        horizon = now - self.slow_window_s - 1.0
        for cls, (h, m) in sorted(self._read_outcomes().items()):
            ring = self._samples.setdefault(
                cls, deque(maxlen=_MAX_TICKS))
            while ring and ring[0][0] < horizon:
                ring.popleft()
            ring.append((now, h, m))
        self._tok_samples.append((now, self._read_tokens()))
        while self._tok_samples[0][0] < horizon:
            self._tok_samples.popleft()

        burns: dict[tuple[str, str], float] = {}
        for cls, ring in sorted(self._samples.items()):
            rates: dict[str, float | None] = {}
            for window, span in (("fast", self.fast_window_s),
                                 ("slow", self.slow_window_s)):
                delta = self._window_delta(ring, now, span)
                if delta is None:
                    rates[window] = None
                    continue
                dh, dm, _ = delta
                total = dh + dm
                rates[window] = (dm / total) if total > 0 else None
            for window in ("fast", "slow"):
                rate = rates[window]
                burn = 0.0 if rate is None else rate / self.budget
                burns[(cls, window)] = round(burn, 4)
                self._g_burn.set(burns[(cls, window)],
                                 cls=cls, window=window)
            self._update_alert(cls, burns.get((cls, "fast"), 0.0),
                               burns.get((cls, "slow"), 0.0), now)

        goodput: dict[str, float] = {}
        for window, span in (("fast", self.fast_window_s),
                             ("slow", self.slow_window_s)):
            delta = self._window_delta(self._tok_samples, now, span)
            if delta is None:
                continue
            dtok, dt = delta
            goodput[window] = round(dtok / dt, 2)
            self._g_goodput.set(goodput[window], window=window)
        if self.goodput_floor_tok_s > 0 and len(goodput) == 2:
            # the floor inverts the burn comparison: LOW throughput
            # is the bad direction, so map it onto the same FSM by
            # scoring floor/goodput (>= fire_burn when starved)
            fast = self.goodput_floor_tok_s / max(goodput["fast"],
                                                  1e-9)
            slow = self.goodput_floor_tok_s / max(goodput["slow"],
                                                  1e-9)
            self._update_alert("goodput", fast, slow, now)
        self.burns = burns
        self.goodput = goodput
        return burns

    # ---- the alert FSM --------------------------------------------
    def _update_alert(self, cls: str, fast: float, slow: float,
                      now: float) -> None:
        active = self._active.get(cls, False)
        if not active and fast >= self.fire_burn \
                and slow >= self.fire_burn:
            self._active[cls] = True
            self.n_fired += 1
            self._c_fired.inc(cls=cls)
            self._g_active.set(1, cls=cls)
            self._emit("firing", cls, fast, slow, now)
        elif active and fast < self.resolve_burn:
            self._active[cls] = False
            self.n_resolved += 1
            self._c_resolved.inc(cls=cls)
            self._g_active.set(0, cls=cls)
            self._emit("resolved", cls, fast, slow, now)

    def _emit(self, state: str, cls: str, fast: float, slow: float,
              now: float) -> None:
        if self.sink is None:
            return
        try:
            self.sink({
                "event": "slo_alert", "state": state, "cls": cls,
                "burn_fast": round(fast, 4),
                "burn_slow": round(slow, 4),
                "fire_burn": self.fire_burn,
                "resolve_burn": self.resolve_burn,
                "target": self.target,
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "now_s": round(
                    now - (self._t0 if self._t0 is not None
                           else now), 3),
            })
        except Exception:  # noqa: BLE001 — a broken sink must never
            # take the exporter tick (or the serving loop behind it)
            # down with it; the gauges/counters still landed
            pass

    # ---- introspection --------------------------------------------
    @property
    def active(self) -> dict[str, bool]:
        """``{cls: firing?}`` — only classes ever evaluated appear."""
        return dict(self._active)

    def snapshot(self) -> dict:
        return {
            "target": self.target,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "fire_burn": self.fire_burn,
            "resolve_burn": self.resolve_burn,
            "n_ticks": self.n_ticks,
            "n_fired": self.n_fired,
            "n_resolved": self.n_resolved,
            "burns": {f"{cls}/{w}": v
                      for (cls, w), v in self.burns.items()},
            "goodput_tok_s": dict(self.goodput),
            "active": dict(self._active),
        }
