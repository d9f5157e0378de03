"""Failure detection & graceful preemption for long trainer runs (a copy of
t2v_turbo_tpu/training/watchdog.py, which imports nothing of JAX; the port
keeps its own copy rather than importing the JAX package).

The reference has no job-level fault tolerance (recovery is checkpoint
auto-resume only). This adds the missing pieces:

- `Heartbeat`: a background thread writing {step, time, host} JSON every few
  seconds; an external supervisor (or the next run) can detect stalls by
  mtime and the job launcher can alert on a stuck step counter.
- `GracefulShutdown`: SIGTERM/SIGINT handler that flips a flag so the train
  loop checkpoints and exits cleanly on preemption instead of dying
  mid-step — paired with LCDTrainer.resume_if_available() this makes
  preemption lossless.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import threading
import time


class Heartbeat:
    def __init__(self, path: str, interval_s: float = 10.0):
        self.path = path
        self.interval_s = interval_s
        self.step = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def update(self, step: int):
        self.step = int(step)

    def _run(self):
        while not self._stop.wait(self.interval_s):
            self._write()

    def _write(self):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "step": self.step,
                    "time": time.time(),
                    "host": socket.gethostname(),
                    "pid": os.getpid(),
                },
                f,
            )
        os.replace(tmp, self.path)

    def __enter__(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        self._write()

    @staticmethod
    def is_stalled(path: str, max_age_s: float = 120.0) -> bool:
        try:
            return time.time() - os.path.getmtime(path) > max_age_s
        except OSError:
            return True


class GracefulShutdown:
    """Flips `requested` on SIGTERM/SIGINT; the loop checks it per step."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._prev = {}
        self._signals = signals

    def _handler(self, signum, frame):
        self.requested = True

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
