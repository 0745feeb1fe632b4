"""Supervised launcher for the HTTP serving front door.

Runs ``repro_torch.serving.server`` as a child process under a small
process manager: structured startup/shutdown logging, SIGTERM/SIGINT
forwarding (the child performs the graceful drain; we just relay the signal
and wait), and a restart-on-crash loop with exponential backoff — a child
that dies with a nonzero code *without being asked to stop* is relaunched up to
``--max-restarts`` times (the consecutive-crash counter resets once a child
stays up past ``RESTART_RESET_S``).

Exit code: the child's code after a requested shutdown (0 = clean drain,
1 = requests were cut off at the drain deadline), or the last crash code once
the restart budget is exhausted.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.server_main \
        --port 8711 --replicas 2 --pipeline --drain-timeout 15

Every ``ServerConfig`` field is a flag; ``--config-file`` loads a JSON base
that individual flags then override. The child inherits the environment
(``PYTHONPATH`` included) and the config's ``device``: ``--paged-runner``
executes on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

from repro_torch.serving.server import ServerConfig
from repro_torch.serving.telemetry import log_event

RESTART_RESET_S = 30.0          # child uptime that clears the crash streak
_BOOL_FLAGS = {"disagg", "pipeline", "prefix_cache", "paged_runner"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="SuperInfer serving launcher: supervises the asyncio "
                    "HTTP server (repro_torch.serving.server) with "
                    "restart-on-crash and signal-forwarded graceful drain")
    ap.add_argument("--config-file", default=None,
                    help="JSON file with ServerConfig fields; flags override")
    defaults = ServerConfig()
    for f in dataclasses.fields(ServerConfig):
        flag = "--" + f.name.replace("_", "-")
        if f.name in _BOOL_FLAGS:
            ap.add_argument(flag, action="store_true", default=None,
                            help=f"enable {f.name} (default off)")
        elif f.type == "bool" or isinstance(getattr(defaults, f.name), bool):
            # tri-state bools (pace): --pace / --no-pace
            ap.add_argument(flag, dest=f.name, action="store_true",
                            default=None)
            ap.add_argument("--no-" + f.name.replace("_", "-"), dest=f.name,
                            action="store_false", default=None)
        else:
            default = getattr(defaults, f.name)
            ap.add_argument(flag, type=str if default is None
                            else type(default), default=None,
                            help=f"default: {default!r}")
    return ap


def config_from_args(args: argparse.Namespace) -> ServerConfig:
    base = {}
    if args.config_file:
        with open(args.config_file) as fh:
            base = json.load(fh)
    for f in dataclasses.fields(ServerConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            base[f.name] = v
    return ServerConfig.from_dict(base).validate()


class Supervisor:
    """Keeps one server child alive until a shutdown is requested."""

    def __init__(self, cfg: ServerConfig):
        self.cfg = cfg
        self.child: Optional[subprocess.Popen] = None
        self.stop_requested = False
        self._pending_sig: Optional[int] = None

    def child_argv(self) -> List[str]:
        return [sys.executable, "-m", "repro_torch.serving.server",
                "--config-json", json.dumps(self.cfg.to_dict())]

    def _on_signal(self, signum, frame) -> None:
        # relay to the child, which owns the graceful drain; remember the
        # signal in case it lands between spawns
        self.stop_requested = True
        self._pending_sig = signum
        if self.child is not None and self.child.poll() is None:
            self.child.send_signal(signum)

    def run(self) -> int:
        signal.signal(signal.SIGTERM, self._on_signal)
        signal.signal(signal.SIGINT, self._on_signal)
        log_event("launcher_up", pid=os.getpid(),
                  config=self.cfg.to_dict())
        crashes = 0
        code = 0
        while not self.stop_requested:
            t_spawn = time.monotonic()
            self.child = subprocess.Popen(self.child_argv())
            log_event("child_spawned", pid=self.child.pid, attempt=crashes)
            if self._pending_sig is not None:   # signal raced the spawn
                self.child.send_signal(self._pending_sig)
            code = self.child.wait()
            uptime = time.monotonic() - t_spawn
            if self.stop_requested:
                log_event("child_exited", code=code,
                          uptime_s=round(uptime, 3), reason="shutdown")
                break
            if code == 0:
                log_event("child_exited", code=0,
                          uptime_s=round(uptime, 3), reason="clean")
                break
            # crash path
            if uptime >= RESTART_RESET_S:
                crashes = 0
            crashes += 1
            if crashes > self.cfg.max_restarts:
                log_event("restart_budget_exhausted", code=code,
                          crashes=crashes - 1,
                          max_restarts=self.cfg.max_restarts)
                break
            backoff = min(self.cfg.backoff_base * (2 ** (crashes - 1)),
                          self.cfg.backoff_cap)
            log_event("child_crashed", code=code, uptime_s=round(uptime, 3),
                      restart_in_s=backoff, attempt=crashes,
                      max_restarts=self.cfg.max_restarts)
            # sleep in small slices so a shutdown signal is honored promptly
            deadline = time.monotonic() + backoff
            while time.monotonic() < deadline and not self.stop_requested:
                time.sleep(0.05)
        log_event("launcher_exit", code=code)
        return code


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        cfg = config_from_args(args)
    except (ValueError, OSError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return Supervisor(cfg).run()


if __name__ == "__main__":
    sys.exit(main())
