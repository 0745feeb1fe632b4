"""What the host gave the run's process: CPU seconds by thread (the
engine's driver thread, the clients' event-loop thread, all others, also
summed by thread name), the
driver thread's involuntary context switches, and the machine's steal
time. Read from ``/proc`` at the edges of the window; empty where ``/proc``
cannot say. Printed beside the readings, never a metric.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict


def _tick() -> float:
    try:
        return float(os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError):
        return 100.0


def _cpu_s(task: Path) -> float:
    fields = (task / "stat").read_text().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / _tick()


def _switches(task: Path) -> float:
    for line in (task / "status").read_text().splitlines():
        if line.startswith("nonvoluntary_ctxt_switches:"):
            return float(line.split()[1])
    return 0.0


def sample(driver_tid: int, loop_tid: int) -> Dict[str, float]:
    """The process's CPU seconds so far, split by thread, and the
    machine's steal seconds (summed over its CPUs)."""
    try:
        out = {"driver_cpu_s": 0.0, "loop_cpu_s": 0.0, "other_cpu_s": 0.0}
        for task in Path("/proc/self/task").iterdir():
            try:
                cpu = _cpu_s(task)
                name = (task / "comm").read_text().strip()
            except (OSError, ValueError, IndexError):
                continue                    # the thread ended meanwhile
            tid = int(task.name)
            key = ("driver_cpu_s" if tid == driver_tid else
                   "loop_cpu_s" if tid == loop_tid else "other_cpu_s")
            out[key] += cpu
            if key == "other_cpu_s":        # and by the thread's name
                out[f"other_cpu_s.{name}"] = out.get(
                    f"other_cpu_s.{name}", 0.0) + cpu
        out["driver_nvcsw"] = _switches(Path(f"/proc/self/task/{driver_tid}"))
        cpu_line = Path("/proc/stat").read_text().splitlines()[0].split()
        out["steal_s"] = int(cpu_line[8]) / _tick()
        return out
    except (OSError, ValueError, IndexError):
        return {}


def delta(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    return {k: b[k] - a.get(k, 0.0) for k in b}
