"""Flight recorder: bounded ring-buffer telemetry for the serving engine.

Three pieces, all stdlib-only:

* ``TelemetryBus`` — per-replica ring buffers of typed request-lifecycle
  ``Span``s (ADMIT, PREFILL, DECODE, ROTATE_OUT, ROTATE_IN, MIGRATE,
  FINISH) and per-iteration ``EngineEvent``s (batch composition, VLT
  slack, HBM headroom, per-direction transfer-channel windows, pipeline
  overlap/stall). ``t_*``/``*_start`` are SIM-CLOCK seconds — the same
  clock every SLO number is computed on — so the trace is exact, not
  sampled. ``wall_*_ns`` are the same intervals on the host's wall clock
  (``time.monotonic_ns``), from the engine's own phase readings; a bus
  made with ``wall=True`` (the engine over the paged runner) keeps the
  offset that puts them on ``torch.profiler``'s clock
  (``wall_offset_ns``), and its trace export lays them out in place of
  the sim clock's. The bus is default OFF
  (``ServingConfig.telemetry=False``): no bus is allocated and the
  engine's step loop takes the byte-identical golden-replay code path.

* ``StructuredLogger`` / ``log_event`` — the single JSON-lines emitter
  shared by the HTTP server, the launcher supervisor and ``serve.py``:
  one ``{"ts": ..., "event": ..., **fields}`` object per line.

* ``render_prometheus`` / ``validate_prometheus_text`` — Prometheus
  text-format (0.0.4) exposition over one or more ``EngineCore``
  replicas: counters for tokens/rotations/migrations/transfer-bytes,
  gauges for free HBM/queue depth/cache hit-rate, TTFT/TBT/iteration
  histograms with SLO-threshold-aligned buckets, and the TTFT-miss
  attribution components (queue-wait vs. rotation-stall vs.
  prefill-compute) per SLO class.

See DESIGN.md §Observability.
"""
import dataclasses
import json
import re
import sys
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

# ---------------------------------------------------------------- span kinds
SPAN_ADMIT = "ADMIT"            # arrival -> first prefill chunk scheduled
SPAN_PREFILL = "PREFILL"        # one chunked-prefill execution window
SPAN_DECODE = "DECODE"          # one decode-iteration execution window
SPAN_ROTATE_OUT = "ROTATE_OUT"  # D2H rotation leg (bytes, direction=d2h)
SPAN_ROTATE_IN = "ROTATE_IN"    # H2D swap-in leg (bytes, direction=h2d)
SPAN_MIGRATE = "MIGRATE"        # cross-replica handoff (disagg)
SPAN_FINISH = "FINISH"          # terminal marker (reason, token count)

SPAN_KINDS = (SPAN_ADMIT, SPAN_PREFILL, SPAN_DECODE, SPAN_ROTATE_OUT,
              SPAN_ROTATE_IN, SPAN_MIGRATE, SPAN_FINISH)

# the phases of a non-idle engine step, in order (EngineEvent.<phase>_wall_s)
PHASES = ("schedule", "kv_plan", "execute", "commit")


def profiler_clock_offset_ns() -> int:
    """Nanoseconds to add to a ``time.monotonic_ns()`` reading to put it on
    ``torch.profiler``'s host clock, which stamps its events
    (``start_ns()`` of ``kineto_results.events()``) in Unix-epoch
    nanoseconds: ``time.time_ns()`` against the middle of the tightest of
    a few monotonic brackets around it."""
    best = None
    for _ in range(5):
        a = time.monotonic_ns()
        unix = time.time_ns()
        b = time.monotonic_ns()
        if best is None or b - a < best[0]:
            best = (b - a, unix - (a + b) // 2)
    return best[1]


@dataclasses.dataclass(frozen=True)
class Span:
    """One request-lifecycle interval, stamped with sim-clock start/end and,
    where the engine read it, wall start/end (``time.monotonic_ns``)."""
    kind: str
    req_id: int
    t_start: float
    t_end: float
    replica: int = 0
    slo_class: str = "standard"
    attrs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    wall_start_ns: Optional[int] = None
    wall_end_ns: Optional[int] = None

    def row(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["attrs"] = dict(self.attrs)
        return d


@dataclasses.dataclass(frozen=True)
class EngineEvent:
    """One engine iteration: execution + per-direction transfer windows.

    ``*_start`` are absolute sim-clock seconds; ``*_s`` are busy durations.
    ``overlap_s`` is the transfer-under-compute overlap the engine credited
    this iteration (matching ``EngineStats.overlap_ms`` accounting, minus
    the pipelined plan-hiding component recorded separately in
    ``plan_hidden_s``) and ``stall_s`` the serialization the pipeline could
    not hide. ``wall_start_ns``/``wall_end_ns`` are the step's first and
    last wall readings (``time.monotonic_ns``) and ``<phase>_wall_s`` the
    phases between them, in order (``PHASES``).
    """
    replica: int
    iteration: int
    t_start: float
    t_end: float
    exec_start: float
    exec_s: float
    d2h_start: float
    d2h_s: float
    h2d_start: float
    h2d_s: float
    sched_s: float = 0.0
    overlap_s: float = 0.0
    stall_s: float = 0.0
    plan_hidden_s: float = 0.0
    attrs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    wall_start_ns: Optional[int] = None
    wall_end_ns: Optional[int] = None
    schedule_wall_s: float = 0.0
    kv_plan_wall_s: float = 0.0
    execute_wall_s: float = 0.0
    commit_wall_s: float = 0.0

    def row(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["attrs"] = dict(self.attrs)
        return d


class TelemetryBus:
    """Bounded ring buffers of spans and engine events for ONE replica.

    Overflow drops the oldest entry (``deque(maxlen=...)``) and counts it,
    so a long run degrades to "most recent window" instead of growing
    without bound. Recording is append-only float/dict work — no engine
    state is read back, which is what keeps telemetry-ON runs
    timing-identical (the sim clock never sees the bus).
    """

    def __init__(self, capacity: int = 65536, replica: int = 0,
                 role: str = "replica", wall: bool = False):
        self.capacity = int(capacity)
        self.replica = int(replica)
        self.role = role
        self.wall_offset_ns = profiler_clock_offset_ns() if wall else None
        self.spans: deque = deque(maxlen=self.capacity)
        self.events: deque = deque(maxlen=self.capacity)
        self.spans_dropped = 0
        self.events_dropped = 0
        self.spans_recorded = 0
        self.events_recorded = 0

    # -- recording ----------------------------------------------------------
    def span(self, kind: str, req_id: int, t_start: float, t_end: float,
             slo_class: str = "standard",
             wall: Optional[Sequence[int]] = None, **attrs) -> None:
        """``wall``: the span's (start, end) wall readings, if any."""
        if len(self.spans) == self.capacity:
            self.spans_dropped += 1
        self.spans_recorded += 1
        w0, w1 = wall if wall is not None else (None, None)
        self.spans.append(Span(kind=kind, req_id=req_id, t_start=t_start,
                               t_end=t_end, replica=self.replica,
                               slo_class=slo_class, attrs=attrs,
                               wall_start_ns=w0, wall_end_ns=w1))

    def event(self, **kw) -> None:
        if len(self.events) == self.capacity:
            self.events_dropped += 1
        self.events_recorded += 1
        kw.setdefault("replica", self.replica)
        self.events.append(EngineEvent(**kw))

    # -- views --------------------------------------------------------------
    def counters(self) -> Dict[str, int]:
        return dict(spans_recorded=self.spans_recorded,
                    spans_dropped=self.spans_dropped,
                    events_recorded=self.events_recorded,
                    events_dropped=self.events_dropped)

    def snapshot(self) -> Dict[str, Any]:
        return dict(replica=self.replica, role=self.role,
                    counters=self.counters(),
                    spans=[s.row() for s in self.spans],
                    events=[e.row() for e in self.events])


def buses_of(cores: Iterable) -> List[TelemetryBus]:
    """The non-None telemetry buses behind a list of EngineCore replicas."""
    return [c.telemetry for c in cores
            if getattr(c, "telemetry", None) is not None]


# ------------------------------------------------------------ JSON-lines log
class StructuredLogger:
    """One-schema JSON-lines emitter: ``{"ts": ..., "event": ..., **kw}``.

    ``ts`` is WALL-clock epoch seconds (these are operational logs about
    the host process — launcher restarts, server lifecycle); sim-clock
    timestamps live on telemetry spans, never here. Values that JSON
    cannot carry are stringified rather than raised on: a log line must
    never take the server down.
    """

    def __init__(self, stream=None):
        # None resolves to sys.stderr at EACH log call, not at import —
        # redirections (and pytest capture) keep working
        self.stream = stream

    def log(self, event: str, **kw) -> None:
        rec: Dict[str, Any] = {"ts": round(time.time(), 3), "event": event}
        rec.update(kw)
        try:
            line = json.dumps(rec, sort_keys=False, default=str)
        except (TypeError, ValueError):
            line = json.dumps({"ts": rec["ts"], "event": event,
                               "repr": repr(kw)})
        print(line, file=self.stream or sys.stderr, flush=True)


_DEFAULT_LOGGER = StructuredLogger()


def log_event(event: str, **kw) -> None:
    """Module-level shared emitter (stderr). The HTTP server, the launcher
    supervisor and ``serve.py`` all route through this one function."""
    _DEFAULT_LOGGER.log(event, **kw)


def emit_json_report(row: Mapping[str, Any], stream=None) -> None:
    """The ``serve.py --json`` contract: exactly one JSON document on
    stdout (CI pipes it straight into ``json.load``)."""
    print(json.dumps(dict(row), indent=1), file=stream or sys.stdout)


# ------------------------------------------------------------- Prometheus
def slo_buckets(threshold_s: float) -> List[float]:
    """Histogram bucket edges aligned on an SLO threshold: the threshold
    itself is an edge (attainment is readable straight off the bucket) with
    geometric headroom both sides."""
    return [threshold_s * m for m in (0.125, 0.25, 0.5, 1.0, 2.0, 4.0)]


def _esc(v: Any) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _labels(**kw) -> str:
    if not kw:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in kw.items())
    return "{" + inner + "}"


def _fmt(v: float) -> str:
    if v != v:                      # NaN
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


class _Writer:
    """Accumulates samples grouped per metric family (the text format
    forbids interleaving families), one HELP/TYPE header each."""

    def __init__(self):
        self._meta: Dict[str, tuple] = {}        # family -> (type, help)
        self._order: List[str] = []
        self._samples: Dict[str, List[str]] = {}

    def header(self, name: str, mtype: str, help_: str) -> None:
        if name not in self._meta:
            self._meta[name] = (mtype, help_)
            self._order.append(name)
            self._samples[name] = []

    def sample(self, name: str, value, family: Optional[str] = None,
               **labels) -> None:
        fam = family or name
        if fam not in self._meta:
            self.header(fam, "gauge", fam)
        self._samples[fam].append(
            f"{name}{_labels(**labels)} {_fmt(value)}")

    def histogram(self, name: str, values: Sequence[float],
                  buckets: Sequence[float], help_: str, **labels) -> None:
        self.header(name, "histogram", help_)
        svals = sorted(values)
        i = 0
        for edge in list(buckets) + [float("inf")]:
            while i < len(svals) and svals[i] <= edge:
                i += 1
            lb = dict(labels)
            lb["le"] = "+Inf" if edge == float("inf") else _fmt(edge)
            self.sample(name + "_bucket", i, family=name, **lb)
        self.sample(name + "_sum", float(sum(values)), family=name, **labels)
        self.sample(name + "_count", len(values), family=name, **labels)

    def text(self) -> str:
        lines: List[str] = []
        for fam in self._order:
            mtype, help_ = self._meta[fam]
            lines.append(f"# HELP {fam} {help_}")
            lines.append(f"# TYPE {fam} {mtype}")
            lines.extend(self._samples[fam])
        return "\n".join(lines) + "\n"


_ITER_BUCKETS = [0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0]
_NS = "superinfer"


def render_prometheus(cores: Sequence, extra: Optional[Mapping[str, Any]]
                      = None) -> str:
    """Prometheus text-format (0.0.4) snapshot over EngineCore replicas.

    Request-derived series (tokens, TTFT/TBT histograms, miss attribution)
    are labeled ``{replica, slo_class}``; pool/link series are labeled
    ``{replica}`` (+ ``direction``/``shard`` where meaningful). ``extra``
    appends server-level gauges/counters (readiness, http counters) as
    ``superinfer_server_<key>``.
    """
    from repro_torch.core.types import SLO_CLASSES, RequestState

    w = _Writer()
    w.header(f"{_NS}_requests_total", "counter",
             "Requests submitted, by replica and SLO class.")
    w.header(f"{_NS}_tokens_generated_total", "counter",
             "Output tokens generated.")
    w.header(f"{_NS}_rotations_total", "counter",
             "KV rotations (RUNNING->ROTARY), by kind: active "
             "(RotaSched policy) or passive (OOM preempt).")
    w.header(f"{_NS}_migrations_total", "counter",
             "Cross-replica migrations (disaggregated prefill/decode).")
    w.header(f"{_NS}_transfer_bytes_total", "counter",
             "KV bytes moved over the C2C link, by direction.")
    w.header(f"{_NS}_transfer_shard_bytes_total", "counter",
             "KV bytes ONE chip's C2C link carried (global/kv_shards).")
    w.header(f"{_NS}_hbm_free_blocks", "gauge", "Free HBM KV blocks.")
    w.header(f"{_NS}_hbm_total_blocks", "gauge", "Total HBM KV blocks.")
    w.header(f"{_NS}_queue_depth", "gauge",
             "Live requests by state (waiting/running/rotary).")
    w.header(f"{_NS}_cache_hit_rate", "gauge",
             "Prefix-cache hit rate (cached / looked-up prompt tokens).")
    w.header(f"{_NS}_ttft_miss_component_seconds_total", "counter",
             "Summed TTFT-miss attribution over TTFT-missed requests: "
             "component in {queue_wait, rotation_stall, prefill_compute}.")
    w.header(f"{_NS}_ttft_missed_total", "counter",
             "Requests whose TTFT exceeded the class threshold.")

    for idx, core in enumerate(cores):
        rep = str(getattr(core, "replica_index", idx))
        stats = core.stats
        # -- per-class request-derived series
        by_cls: Dict[str, list] = {}
        for r in core.submitted:
            by_cls.setdefault(r.slo_class, []).append(r)
        for cls in sorted(by_cls):
            reqs = by_cls[cls]
            lab = dict(replica=rep, slo_class=cls)
            w.sample(f"{_NS}_requests_total", len(reqs), **lab)
            w.sample(f"{_NS}_tokens_generated_total",
                     sum(r.tokens_generated for r in reqs), **lab)
            ttfts = [r.ttft() for r in reqs if r.ttft() is not None]
            thr = SLO_CLASSES.get(cls)
            tt = thr.ttft_s if thr else reqs[0].slo.ttft_s
            tb = thr.tbt_s if thr else reqs[0].slo.tbt_s
            w.histogram(f"{_NS}_ttft_seconds", ttfts, slo_buckets(tt),
                        "Time-to-first-token (sim seconds); bucket edges "
                        "aligned on the class SLO threshold.", **lab)
            tbts = []
            for r in reqs:
                vals = r.tbt_values()
                if vals:
                    tbts.append(sum(vals) / len(vals))
            w.histogram(f"{_NS}_tbt_seconds", tbts, slo_buckets(tb),
                        "Per-request mean time-between-tokens (sim "
                        "seconds).", **lab)
            comp = {"queue_wait": 0.0, "rotation_stall": 0.0,
                    "prefill_compute": 0.0}
            n_missed = 0
            for r in reqs:
                bd = r.ttft_breakdown()
                if bd is None or bd["ttft_s"] <= r.slo.ttft_s:
                    continue
                n_missed += 1
                comp["queue_wait"] += bd["queue_wait_s"]
                comp["rotation_stall"] += bd["rotation_stall_s"]
                comp["prefill_compute"] += bd["prefill_compute_s"]
            w.sample(f"{_NS}_ttft_missed_total", n_missed, **lab)
            for k, v in comp.items():
                w.sample(f"{_NS}_ttft_miss_component_seconds_total", v,
                         component=k, **lab)
        # -- engine-level counters/gauges
        w.sample(f"{_NS}_rotations_total", stats.active_rotations,
                 replica=rep, kind="active")
        w.sample(f"{_NS}_rotations_total", stats.passive_preemptions,
                 replica=rep, kind="passive")
        w.sample(f"{_NS}_migrations_total",
                 sum(r.migrations for r in core.submitted), replica=rep)
        tc = core.kv.transfer_counters()
        w.sample(f"{_NS}_transfer_bytes_total", tc["d2h_bytes"],
                 replica=rep, direction="d2h")
        w.sample(f"{_NS}_transfer_bytes_total", tc["h2d_bytes"],
                 replica=rep, direction="h2d")
        w.sample(f"{_NS}_transfer_shard_bytes_total",
                 tc["d2h_bytes_per_shard"], replica=rep, direction="d2h")
        w.sample(f"{_NS}_transfer_shard_bytes_total",
                 tc["h2d_bytes_per_shard"], replica=rep, direction="h2d")
        w.header(f"{_NS}_transfer_busy_seconds_total", "counter",
                 "Cumulative per-direction C2C channel busy time "
                 "(sim model seconds).")
        w.sample(f"{_NS}_transfer_busy_seconds_total",
                 tc.get("d2h_busy_s", 0.0), replica=rep, direction="d2h")
        w.sample(f"{_NS}_transfer_busy_seconds_total",
                 tc.get("h2d_busy_s", 0.0), replica=rep, direction="h2d")
        w.sample(f"{_NS}_hbm_free_blocks", core.kv.hbm_free_blocks,
                 replica=rep)
        w.sample(f"{_NS}_hbm_total_blocks", core.serving.num_hbm_blocks,
                 replica=rep)
        live = [r for r in core.active]
        for st, name in ((RequestState.WAITING, "waiting"),
                         (RequestState.RUNNING, "running"),
                         (RequestState.ROTARY, "rotary")):
            w.sample(f"{_NS}_queue_depth",
                     sum(1 for r in live if r.state == st),
                     replica=rep, state=name)
        cc = core.kv.cache_counters()
        looked = cc.get("cache_lookup_tokens", 0)
        rate = cc.get("cache_hit_tokens", 0) / looked if looked else 0.0
        w.sample(f"{_NS}_cache_hit_rate", rate, replica=rep)
        # -- iteration-time histogram from the telemetry bus, if recording
        bus = getattr(core, "telemetry", None)
        if bus is not None:
            iters = [e.t_end - e.t_start for e in bus.events]
            w.histogram(f"{_NS}_iteration_seconds", iters, _ITER_BUCKETS,
                        "Engine iteration wall (sim seconds), from the "
                        "telemetry ring (bounded window).", replica=rep)
            for k, v in bus.counters().items():
                w.header(f"{_NS}_telemetry_{k}", "counter",
                         "Telemetry ring-buffer accounting.")
                w.sample(f"{_NS}_telemetry_{k}", v, replica=rep)
    for k, v in dict(extra or {}).items():
        name = f"{_NS}_server_{k}"
        w.header(name, "gauge", f"Server-level metric {k}.")
        w.sample(name, float(v))
    return w.text()


# A sample line: name{labels} value [timestamp]
_NAME_RE = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_LABEL_RE = r'[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
_VALUE_RE = r"(?:[-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)|[-+]?Inf|NaN)"
_SAMPLE_RE = re.compile(
    rf"^({_NAME_RE})(?:\{{{_LABEL_RE}(?:,{_LABEL_RE})*\}})?"
    rf" {_VALUE_RE}(?: [0-9]+)?$")
_HELP_RE = re.compile(rf"^# (HELP|TYPE) ({_NAME_RE})( .*)?$")


def validate_prometheus_text(text: str) -> Dict[str, str]:
    """Validate Prometheus text-format 0.0.4 line syntax.

    Returns ``{metric_name: type}`` for every TYPE-declared metric. Raises
    ``ValueError`` on a malformed line, a sample for an undeclared
    histogram component, or a histogram missing its ``_bucket``/``_sum``/
    ``_count`` triplet.
    """
    types: Dict[str, str] = {}
    sampled: Dict[str, int] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            m = _HELP_RE.match(line)
            if not m:
                raise ValueError(f"line {ln}: malformed comment: {line!r}")
            if m.group(1) == "TYPE":
                types[m.group(2)] = (m.group(3) or "").strip()
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {ln}: malformed sample: {line!r}")
        sampled[m.group(1)] = sampled.get(m.group(1), 0) + 1
    for name, mtype in types.items():
        if mtype == "histogram":
            for suffix in ("_bucket", "_sum", "_count"):
                if name + suffix not in sampled:
                    raise ValueError(
                        f"histogram {name} missing {name + suffix} samples")
    for name in sampled:
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if name not in types and base not in types:
            raise ValueError(f"sample {name} has no TYPE declaration")
    return types
