"""Chrome-trace / Perfetto JSON export of the telemetry flight recorder.

Track layout (open the file in https://ui.perfetto.dev or
chrome://tracing):

* one PROCESS per replica (``pid`` = replica index, named
  ``replica<i> (<role>)``),
* four engine tracks per replica — ``tid`` 0 scheduler, 1 compute,
  2 D2H, 3 H2D — carrying complete ("X") slices per iteration, so
  DuplexKV's full-duplex overlap is literally visible: under load the
  D2H and H2D tracks run concurrently beneath the compute track;
* one track per request (``tid`` = 16 + req_id) carrying its lifecycle
  spans (ADMIT → PREFILL → DECODE/ROTATE_* → FINISH instant).

Timestamps are SIM-CLOCK microseconds (the engine's float seconds
* 1e6) — the same clock the SLO report is computed on. ``analyze_trace``
recomputes channel overlap geometrically from the exported slices so
tests and CI can assert the trace agrees with the engine's own
``overlap_ms`` accounting.

A bus that keeps a wall clock (``TelemetryBus.wall_offset_ns``: the engine
over the paged runner) is laid out on the wall instead, in Unix-epoch
microseconds, ``torch.profiler``'s host clock: two engine tracks, ``tid``
4 one slice a step and 5 its phases (``schedule``, ``kv_plan``,
``execute``, ``commit``), and the request tracks with each span's wall
stamps (ADMIT from submission to the plan of the first prefill chunk,
PREFILL/DECODE the execute phase, ROTATE_* the kv_plan phase, where the
rows move). The slices then line up with the ``superinfer.*`` ranges of a
profiler trace of the same process, whose ``ts`` count from its
``baseTimeNanoseconds``.
"""
import json
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from repro_torch.serving.telemetry import PHASES

TRACK_SCHED = 0
TRACK_COMPUTE = 1
TRACK_D2H = 2
TRACK_H2D = 3
TRACK_STEP = 4          # the wall layout's tracks
TRACK_PHASES = 5
REQ_TRACK_BASE = 16     # request lifecycle tracks start here (16 + req_id)

_TRACK_NAMES = {TRACK_SCHED: "scheduler", TRACK_COMPUTE: "compute",
                TRACK_D2H: "D2H", TRACK_H2D: "H2D"}
_WALL_TRACK_NAMES = {TRACK_STEP: "engine step (wall)",
                     TRACK_PHASES: "step phases (wall)"}

_US = 1e6               # sim seconds -> trace microseconds
SIM_CLOCK = "sim-seconds*1e6"
WALL_CLOCK = ("unix-epoch-us: torch.profiler's host clock (a profiler "
              "trace's ts + baseTimeNanoseconds/1e3)")


def _meta(pid: int, tid: Optional[int], name: str, what: str) -> Dict:
    ev = {"ph": "M", "pid": pid, "name": what,
          "args": {"name": name}}
    if tid is not None:
        ev["tid"] = tid
    return ev


def _slice(pid: int, tid: int, name: str, t_start: float, dur_s: float,
           args: Optional[Mapping[str, Any]] = None) -> Dict:
    return {"ph": "X", "pid": pid, "tid": tid, "name": name,
            "ts": t_start * _US, "dur": max(dur_s, 0.0) * _US,
            "cat": "engine" if tid < REQ_TRACK_BASE else "request",
            "args": dict(args or {})}


def _sim_steps(bus, pid: int) -> List[Dict]:
    """The scheduler, compute and per-direction channel slices of each
    step, on the sim clock."""
    out: List[Dict] = []
    for e in bus.events:
        it = e.iteration
        args = {"iteration": it, "overlap_s": e.overlap_s,
                "stall_s": e.stall_s, "plan_hidden_s": e.plan_hidden_s}
        args.update(e.attrs)
        if e.sched_s > 0:
            out.append(_slice(pid, TRACK_SCHED, f"plan#{it}",
                              e.t_start, e.sched_s, {"iteration": it}))
        if e.exec_s > 0:
            nd = e.attrs.get("decode_reqs", 0)
            np_ = e.attrs.get("prefill_chunks", 0)
            out.append(_slice(pid, TRACK_COMPUTE, f"exec#{it} d{nd} p{np_}",
                              e.exec_start, e.exec_s, args))
        if e.d2h_s > 0:
            out.append(_slice(
                pid, TRACK_D2H, f"d2h#{it}", e.d2h_start, e.d2h_s,
                {"iteration": it,
                 "bytes": e.attrs.get("d2h_bytes", 0)}))
        if e.h2d_s > 0:
            out.append(_slice(
                pid, TRACK_H2D, f"h2d#{it}", e.h2d_start, e.h2d_s,
                {"iteration": it,
                 "bytes": e.attrs.get("h2d_bytes", 0)}))
    return out


def _wall_steps(bus, pid: int) -> List[Dict]:
    """One slice a step and one a phase, on the profiler's clock."""
    out: List[Dict] = []
    for e in bus.events:
        if e.wall_start_ns is None:
            continue
        it = e.iteration
        args = {"iteration": it}
        args.update(e.attrs)
        out.append(_slice(pid, TRACK_STEP, f"step#{it}",
                          _wall_s(bus, e.wall_start_ns),
                          (e.wall_end_ns - e.wall_start_ns) / 1e9, args))
        t = e.wall_start_ns
        for phase in PHASES:
            d = getattr(e, f"{phase}_wall_s")
            out.append(_slice(pid, TRACK_PHASES, f"{phase}#{it}",
                              _wall_s(bus, t), d, {"iteration": it}))
            t += round(d * 1e9)
    return out


def _wall_s(bus, ns: int) -> float:
    """A bus's wall reading in Unix-epoch seconds (the profiler's clock)."""
    return (ns + bus.wall_offset_ns) / 1e9


def trace_events(buses: Iterable) -> List[Dict]:
    """Flatten telemetry buses into a Chrome-trace event list."""
    events: List[Dict] = []
    req_tracks: Dict[Tuple[int, int], None] = {}
    for bus in buses:
        pid = bus.replica
        wall = bus.wall_offset_ns is not None
        events.append(_meta(pid, None, f"replica{pid} ({bus.role})",
                            "process_name"))
        events.append(_meta(pid, None, str(pid), "process_sort_index"))
        for tid, name in (_WALL_TRACK_NAMES if wall
                          else _TRACK_NAMES).items():
            events.append(_meta(pid, tid, name, "thread_name"))
            events.append(_meta(pid, tid, str(tid), "thread_sort_index"))
        events.extend(_wall_steps(bus, pid) if wall
                      else _sim_steps(bus, pid))
        for s in bus.spans:
            if not wall:
                t0, t1 = s.t_start, s.t_end
            elif s.wall_start_ns is None:
                continue
            else:
                t0 = _wall_s(bus, s.wall_start_ns)
                t1 = _wall_s(bus, s.wall_end_ns)
            tid = REQ_TRACK_BASE + s.req_id
            if (pid, tid) not in req_tracks:
                req_tracks[(pid, tid)] = None
                events.append(_meta(pid, tid,
                                    f"req {s.req_id} [{s.slo_class}]",
                                    "thread_name"))
                events.append(_meta(pid, tid, str(tid),
                                    "thread_sort_index"))
            args = {"req_id": s.req_id, "slo_class": s.slo_class}
            args.update(s.attrs)
            if t1 > t0:
                events.append(_slice(pid, tid, s.kind, t0, t1 - t0, args))
            else:
                events.append({"ph": "i", "pid": pid, "tid": tid,
                               "name": s.kind, "ts": t0 * _US,
                               "s": "t", "cat": "request", "args": args})
    return events


def export_trace(buses: Iterable) -> Dict[str, Any]:
    """Assemble the full Chrome-trace document from telemetry buses; its
    ``otherData.clock`` names the clock (one a replica where they
    differ)."""
    buses = list(buses)
    clocks = {str(b.replica): SIM_CLOCK if b.wall_offset_ns is None
              else WALL_CLOCK for b in buses}
    return {
        "traceEvents": trace_events(buses),
        "displayTimeUnit": "ms",
        "otherData": {
            "clock": (clocks if len(set(clocks.values())) > 1
                      else next(iter(clocks.values()), SIM_CLOCK)),
            "replicas": len(buses),
            "counters": {str(b.replica): b.counters() for b in buses},
        },
    }


def trace_from_cores(cores: Sequence) -> Dict[str, Any]:
    from repro_torch.serving.telemetry import buses_of
    return export_trace(buses_of(cores))


def write_trace(path: str, cores: Sequence) -> Dict[str, Any]:
    """Export the replicas' telemetry to a Perfetto-loadable JSON file."""
    trace = trace_from_cores(cores)
    with open(path, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    return trace


# ---------------------------------------------------------------- analysis
def _intervals(trace: Mapping, tid: int
               ) -> Dict[int, List[Tuple[float, float, Any]]]:
    """Per-pid (start, end, iteration) second intervals of one track."""
    out: Dict[int, List[Tuple[float, float, Any]]] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("tid") == tid:
            t0 = e["ts"] / _US
            out.setdefault(e["pid"], []).append(
                (t0, t0 + e["dur"] / _US,
                 e.get("args", {}).get("iteration")))
    return out


def _pair_overlap(a: List[Tuple[float, float, Any]],
                  b: List[Tuple[float, float, Any]],
                  same_iteration: bool = False) -> Tuple[int, float]:
    """Count/sum pairwise interval intersections. With ``same_iteration``
    only slices from the same engine iteration are compared — that is the
    geometry ``PipelineTimeline.advance`` credits, whereas a transfer
    window may ALSO spill under the next iteration's compute window.
    Within one channel the slices are disjoint (each channel serializes),
    so the geometric case is a linear two-pointer sweep, not N^2."""
    pairs, total = 0, 0.0
    if same_iteration:
        by_iter: Dict[Any, List[Tuple[float, float, Any]]] = {}
        for iv in b:
            by_iter.setdefault(iv[2], []).append(iv)
        for s0, e0, i0 in a:
            for s1, e1, _ in by_iter.get(i0, ()):
                ov = min(e0, e1) - max(s0, s1)
                if ov > 0:
                    pairs += 1
                    total += ov
        return pairs, total
    a, b = sorted(a), sorted(b)
    i = j = 0
    while i < len(a) and j < len(b):
        s0, e0, _ = a[i]
        s1, e1, _ = b[j]
        ov = min(e0, e1) - max(s0, s1)
        if ov > 0:
            pairs += 1
            total += ov
        if e0 <= e1:
            i += 1
        else:
            j += 1
    return pairs, total


def analyze_trace(trace: Mapping) -> Dict[str, Any]:
    """Channel-overlap summary recomputed geometrically from the trace.

    Returns, per replica and totalled:

    * ``d2h_h2d_concurrent_pairs`` / ``d2h_h2d_overlap_s`` — full-duplex
      evidence: D2H and H2D slices running at the same instant;
    * ``span_overlap_s`` — transfer-under-compute overlap recomputed from
      the exported slices (sum over both directions of each transfer
      slice's intersection with compute slices);
    * ``event_overlap_s`` / ``plan_hidden_s`` / ``stall_s`` — the values
      the ENGINE recorded on each iteration event, summed. The engine's
      cumulative ``overlap_ms`` equals
      ``(event_overlap_s + plan_hidden_s) * 1e3``, and for pipelined
      runs ``span_overlap_s == event_overlap_s`` (same windows, same
      geometry) — asserted in tests/CI.
    """
    d2h = _intervals(trace, TRACK_D2H)
    h2d = _intervals(trace, TRACK_H2D)
    comp = _intervals(trace, TRACK_COMPUTE)
    per: Dict[str, Dict[str, float]] = {}
    pids = sorted(set(d2h) | set(h2d) | set(comp))
    ev_overlap: Dict[int, float] = {}
    plan_hidden: Dict[int, float] = {}
    stall: Dict[int, float] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("tid") == TRACK_COMPUTE:
            args = e.get("args", {})
            pid = e["pid"]
            ev_overlap[pid] = ev_overlap.get(pid, 0.0) \
                + args.get("overlap_s", 0.0)
            plan_hidden[pid] = plan_hidden.get(pid, 0.0) \
                + args.get("plan_hidden_s", 0.0)
            stall[pid] = stall.get(pid, 0.0) + args.get("stall_s", 0.0)
    tot = dict(d2h_h2d_concurrent_pairs=0, d2h_h2d_overlap_s=0.0,
               span_overlap_s=0.0, event_overlap_s=0.0,
               plan_hidden_s=0.0, stall_s=0.0)
    for pid in pids:
        pairs, dup = _pair_overlap(d2h.get(pid, []), h2d.get(pid, []))
        _, ov_d = _pair_overlap(d2h.get(pid, []), comp.get(pid, []),
                                same_iteration=True)
        _, ov_h = _pair_overlap(h2d.get(pid, []), comp.get(pid, []),
                                same_iteration=True)
        row = dict(d2h_h2d_concurrent_pairs=pairs, d2h_h2d_overlap_s=dup,
                   span_overlap_s=ov_d + ov_h,
                   event_overlap_s=ev_overlap.get(pid, 0.0),
                   plan_hidden_s=plan_hidden.get(pid, 0.0),
                   stall_s=stall.get(pid, 0.0))
        per[str(pid)] = row
        for k in tot:
            tot[k] += row[k]
    tot["per_replica"] = per
    return tot
