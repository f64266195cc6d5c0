"""Levelled logging under the `surreal_tpu_torch` root (port of
surreal_tpu/utils/logger.py): printf-style records to stderr and, given a
log directory, to one file per host process. The port runs one process,
so its file is `host-0.log`."""

from __future__ import annotations

import logging
import os
import sys
import time

ROOT = "surreal_tpu_torch"
_FMT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"
_DATEFMT = "%H:%M:%S"

_configured = False


def _configure_root(level: int = logging.INFO, logdir: str | None = None) -> None:
    global _configured
    if _configured:
        return
    handlers: list[logging.Handler] = [logging.StreamHandler(sys.stderr)]
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(logdir, "host-0.log")))
    root = logging.getLogger(ROOT)
    root.setLevel(level)
    for h in handlers:
        h.setFormatter(logging.Formatter(_FMT, _DATEFMT))
        root.addHandler(h)
    root.propagate = False
    _configured = True


def get_logger(name: str = ROOT, logdir: str | None = None) -> logging.Logger:
    """The logger `surreal_tpu_torch.<name>`; the first call configures the
    root's handlers (a later `logdir` is not attached, as in the reference)."""
    _configure_root(logdir=logdir)
    if not name.startswith(ROOT):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)


class Timer:
    """Context-manager wall-clock timer."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False
