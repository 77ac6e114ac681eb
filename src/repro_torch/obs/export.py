"""Chrome trace-event JSON export: every trace opens in Perfetto.

``to_chrome_trace`` renders a :class:`~repro.obs.trace.Tracer`'s records
as the Chrome trace-event format (the JSON dialect Perfetto and
``chrome://tracing`` both read natively):

* each distinct ``process`` label becomes one **pid track** — this is how
  simulator-*predicted* timelines (``core.simulator.timeline_to_tracer``)
  overlay *measured* engine/executor timelines in one view;
* **lanes are threads**: task records draw on ``tid = lane`` rows (the
  paper's per-thread task timelines, Figs 6/7/11/12), nested spans draw
  on their recording thread's row, and both get ``thread_name`` metadata;
* spans and task records are complete (``ph: "X"``) events whose nesting
  Perfetto derives from time containment;
* counter samples are ``ph: "C"`` events — Perfetto renders each name as
  a counter track (page-pool occupancy, queue depth);
* a final-value sample of a :class:`~repro.obs.metrics.MetricsRegistry`
  can be attached as trace-level metadata (``otherData``).

Timestamps are normalized to the earliest record and scaled to
microseconds (Chrome's unit).  ``validate_chrome_trace`` is the schema
check the tests and the CI trace-smoke step run against every produced
artifact; the module is runnable as a validator CLI:

    PYTHONPATH=src python -m repro.obs.export /tmp/trace.json

Port note: a copy of ``repro.obs.export`` (it imports nothing of jax).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple, Union

from .metrics import MetricsRegistry
from .trace import NullTracer, Tracer, get_tracer

_US = 1e6      # records hold seconds; Chrome wants microseconds


def _normalize_origin(tracer) -> float:
    ts = ([s.t0 for s in tracer.spans] + [t.t0 for t in tracer.tasks]
          + [c.t for c in tracer.counters])
    return min(ts) if ts else 0.0


class _Tracks:
    """pid/tid assignment: one pid per process label, one tid per
    (process, lane) pair, with metadata events naming both."""

    def __init__(self, events: List[Dict[str, Any]]):
        self.events = events
        self._pids: Dict[str, int] = {}
        self._tids: Dict[Tuple[str, Any], int] = {}

    def pid(self, process: str) -> int:
        p = self._pids.get(process)
        if p is None:
            p = self._pids[process] = len(self._pids) + 1
            self.events.append({
                "ph": "M", "name": "process_name", "pid": p, "tid": 0,
                "ts": 0, "args": {"name": process}})
        return p

    def tid(self, process: str, lane: Any, prefix: str = "lane") -> int:
        key = (process, lane)
        t = self._tids.get(key)
        if t is None:
            n = sum(1 for (pr, _) in self._tids if pr == process)
            t = self._tids[key] = n + 1
            self.events.append({
                "ph": "M", "name": "thread_name",
                "pid": self.pid(process), "tid": t, "ts": 0,
                "args": {"name": lane if isinstance(lane, str)
                         else f"{prefix} {lane}"}})
        return t


def to_chrome_trace(tracer: Optional[Union[Tracer, NullTracer]] = None, *,
                    registry: Optional[MetricsRegistry] = None,
                    type_names: Optional[Dict[int, str]] = None
                    ) -> Dict[str, Any]:
    """Render a tracer's records as a Chrome trace-event JSON object
    (default: the process-global tracer).  ``type_names`` maps task-type
    ints to display names on task events; ``registry`` attaches a final
    metrics snapshot as ``otherData``."""
    if tracer is None:
        tracer = get_tracer()
    events: List[Dict[str, Any]] = []
    tracks = _Tracks(events)
    t0 = _normalize_origin(tracer)

    for s in tracer.spans:
        events.append({
            "ph": "X", "name": s.name, "cat": "span",
            "pid": tracks.pid(s.process),
            "tid": tracks.tid(s.process, s.lane),
            "ts": (s.t0 - t0) * _US,
            "dur": max((s.t1 - s.t0) * _US, 0.0),
            "args": {k: _jsonable(v) for k, v in s.args.items()},
        })
    for t in tracer.tasks:
        tname = (type_names or {}).get(t.task_type, f"type {t.task_type}")
        events.append({
            "ph": "X", "name": t.name or tname, "cat": "task",
            "pid": tracks.pid(t.process),
            "tid": tracks.tid(t.process, t.lane),
            "ts": (t.t0 - t0) * _US,
            "dur": max((t.t1 - t.t0) * _US, 0.0),
            "args": {"tid": t.tid, "type": t.task_type, "lane": t.lane},
        })
    for c in tracer.counters:
        events.append({
            "ph": "C", "name": c.name, "cat": "metric",
            "pid": tracks.pid(c.process), "tid": 0,
            "ts": (c.t - t0) * _US,
            "args": {"value": c.value},
        })

    out: Dict[str, Any] = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
    }
    if registry is not None:
        out["otherData"] = {"metrics": registry.snapshot()}
    return out


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def write_chrome_trace(path: str,
                       tracer: Optional[Union[Tracer, NullTracer]] = None, *,
                       registry: Optional[MetricsRegistry] = None,
                       type_names: Optional[Dict[int, str]] = None
                       ) -> Dict[str, Any]:
    """Export, self-validate, and write one trace file (default: the
    process-global tracer).  Returns the validation summary (event counts
    per phase)."""
    obj = to_chrome_trace(tracer, registry=registry, type_names=type_names)
    summary = validate_chrome_trace(obj)
    with open(path, "w") as f:
        json.dump(obj, f)
    return summary


def validate_chrome_trace(obj: Union[Dict[str, Any], str]
                          ) -> Dict[str, Any]:
    """Schema check for Chrome trace-event JSON (object format).  Accepts
    a parsed dict or a file path; raises ``ValueError`` on the first
    violation; returns a summary with per-phase event counts, counter
    track names and process names."""
    if isinstance(obj, str):
        with open(obj) as f:
            obj = json.load(f)
    if not isinstance(obj, dict):
        raise ValueError("trace must be a JSON object with 'traceEvents'")
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    phases: Dict[str, int] = {}
    counter_tracks = set()
    processes = set()
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            raise ValueError(f"event {i}: not an object")
        for k in ("ph", "name", "pid", "ts"):
            if k not in e:
                raise ValueError(f"event {i}: missing required key {k!r}")
        ph = e["ph"]
        if not isinstance(ph, str) or len(ph) != 1:
            raise ValueError(f"event {i}: bad phase {ph!r}")
        if not isinstance(e["name"], str):
            raise ValueError(f"event {i}: name must be a string")
        for k in ("pid", "ts"):
            if not isinstance(e[k], (int, float)) or isinstance(e[k], bool):
                raise ValueError(f"event {i}: {k} must be a number")
        if ph != "M" and e["ts"] < 0:
            raise ValueError(f"event {i}: negative timestamp {e['ts']}")
        if ph == "X":
            if "dur" not in e or not isinstance(e["dur"], (int, float)):
                raise ValueError(f"event {i}: X event needs numeric 'dur'")
            if e["dur"] < 0:
                raise ValueError(f"event {i}: negative duration {e['dur']}")
        if ph == "C":
            args = e.get("args")
            if (not isinstance(args, dict) or not args
                    or not all(isinstance(v, (int, float))
                               and not isinstance(v, bool)
                               for v in args.values())):
                raise ValueError(
                    f"event {i}: C event needs numeric args series")
            counter_tracks.add(e["name"])
        if ph == "M" and e["name"] == "process_name":
            processes.add(e.get("args", {}).get("name"))
        phases[ph] = phases.get(ph, 0) + 1
    return {
        "events": len(events),
        "phases": phases,
        "counter_tracks": sorted(counter_tracks),
        "processes": sorted(p for p in processes if p),
    }


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="validate a Chrome trace-event JSON file")
    ap.add_argument("paths", nargs="+")
    args = ap.parse_args(argv)
    for path in args.paths:
        summary = validate_chrome_trace(path)
        print(f"{path}: OK — {summary['events']} events, "
              f"phases={summary['phases']}, "
              f"processes={summary['processes']}, "
              f"counters={summary['counter_tracks']}")


if __name__ == "__main__":
    main()
