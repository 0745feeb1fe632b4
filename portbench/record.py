"""What one run recorded, as the metric readers see it.

Times are seconds on the host's monotonic clock, counted from the due time
of the first request. ``counters`` holds snapshots of the program's
counters, taken at the edges of the span they are read over; ``trace`` the
reduction of the profiler's trace (``trace.py``) of a traced run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

from portbench.costs import Dims


@dataclasses.dataclass
class ClientRecord:
    """One request as its client saw it."""
    due: float
    slo_class: str
    ttft_limit_s: float
    prompt_len: int
    max_tokens: int
    sent: Optional[float] = None
    req_id: Optional[int] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    token_ids: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    error: Optional[str] = None

    @property
    def failed(self) -> bool:
        """An exception, or an end before its tokens were all served other
        than the cut at the window's close (``"cut"``)."""
        return self.error is not None or self.finish_reason not in (
            None, "length", "stop", "cut")

    @property
    def finished(self) -> bool:
        return self.finish_reason in ("length", "stop") and not self.failed

    def ttft(self, until: float) -> Tuple[float, bool]:
        """(Time to first token from the due time, whether a first token
        came): a request with none by ``until`` counts with its wait so
        far."""
        if self.token_times and self.token_times[0] <= until:
            return self.token_times[0] - self.due, True
        return until - self.due, False


@dataclasses.dataclass
class TraceSummary:
    """A traced span ``[t0, t1]`` reduced: device busy seconds, device
    seconds by kernel name, idle seconds by what the host was doing."""
    t0: float
    t1: float
    busy_s: float
    kernel_s: Dict[str, float]
    idle_by_host: Dict[str, float]
    events: int

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class RunRecord:
    dims: Dims
    w0: float                  # the measured window
    w1: float
    span: Tuple[float, float]  # where the counters were read
    counters: Dict[str, Dict[str, float]]   # "start"/"end" of ``span``
    requests: List[ClientRecord]
    setup_s: float
    trace: Optional[TraceSummary] = None

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    def counted(self) -> List[ClientRecord]:
        """Requests due inside the window."""
        return [r for r in self.requests if self.w0 <= r.due < self.w1]

    def delta(self, name: str) -> float:
        """A counter's growth over ``span``."""
        return self.counters["end"][name] - self.counters["start"][name]

    def tokens(self, a: float, b: float
               ) -> Iterator[Tuple[ClientRecord, int, float]]:
        """(request, index of the token, receipt time) of every token
        received in ``[a, b)``."""
        for r in self.requests:
            for k, t in enumerate(r.token_times):
                if a <= t < b:
                    yield r, k, t
