"""Workload capture & deterministic replay harness (loadgen) — the
port of ``torchbooster_tpu/serving/loadgen``.

The serving stack's load-testing story, grown from ROADMAP item 2's
"trace-capture/replay harness" note into a subsystem:

- :mod:`workload` — the versioned JSONL workload format (arrival
  offsets, prompt ids or privacy-scrubbed seed+length recipes,
  priority classes, deadlines, client cancel/disconnect offsets),
  its content **fingerprint**, the front door's
  :class:`WorkloadCapture` hook, a tracer-ring reconstruction, and
  the synthetic generators (Poisson / bursty / diurnal / sharegpt)
  that emit the same format;
- :mod:`replay` — the open-loop drivers: :func:`replay_inprocess`
  (the batcher ``step()`` core under a deterministic
  :class:`ReplayClock` — bit-reproducible token streams and
  scheduler decisions) and :func:`replay_http` (real asyncio SSE
  clients against a live ``ServingFrontend``), both at a
  configurable ×-compression;
- :mod:`report` — SLO conformance reports (per-class TTFT/TPOT
  percentiles, goodput, shed/cancel/preemption rates, the
  fingerprint), the :func:`max_sustainable_speed` binary search, and
  the :func:`diff_reports` regression gate.

Capture wiring: ``ServingFrontend(capture_path=...)`` (or the
``serving.frontend.capture_path`` YAML knob) records everything the
server is offered; ``chip_smoke.py``'s ``serve_replay`` phase proves the
round trip on the card.
"""
from torchbooster_tpu_torch.serving.loadgen.replay import (
    ReplayClock,
    ReplayResult,
    replay_http,
    replay_inprocess,
)
from torchbooster_tpu_torch.serving.loadgen.report import (
    conformance_report,
    diff_reports,
    fingerprints_comparable,
    max_sustainable_speed,
)
from torchbooster_tpu_torch.serving.loadgen.workload import (
    SYNTHETIC_KINDS,
    Workload,
    WorkloadCapture,
    WorkloadRequest,
    synthesize,
)

__all__ = [
    "ReplayClock",
    "ReplayResult",
    "SYNTHETIC_KINDS",
    "Workload",
    "WorkloadCapture",
    "WorkloadRequest",
    "conformance_report",
    "diff_reports",
    "fingerprints_comparable",
    "max_sustainable_speed",
    "replay_http",
    "replay_inprocess",
    "synthesize",
]
