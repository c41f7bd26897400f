"""Leveled logger with CPU and wall timers.

The reference's observability layer (pyscf/lib/logger.py:29-177): QUIET to
DEBUG levels, and a ``timer`` that reports process and wall clock per
phase. The level comes from ``PYSCF_ISDF_TPU_VERBOSE`` or the logger.
"""
from __future__ import annotations

import os
import sys
import time

QUIET, ERROR, WARN, NOTE, INFO, DEBUG, DEBUG1, DEBUG2 = 0, 1, 2, 3, 4, 5, 6, 7


class Logger:
    def __init__(self, verbose: int | None = None, stdout=None):
        if verbose is None:
            verbose = int(os.environ.get("PYSCF_ISDF_TPU_VERBOSE", NOTE))
        self.verbose = verbose
        self.stdout = stdout or sys.stdout
        self._t0 = (time.process_time(), time.perf_counter())

    def _log(self, level, fmt, *args):
        if self.verbose >= level:
            print(fmt % args if args else fmt, file=self.stdout, flush=True)

    def error(self, fmt, *args):
        self._log(ERROR, "ERROR: " + fmt, *args)

    def warn(self, fmt, *args):
        self._log(WARN, "WARN: " + fmt, *args)

    def note(self, fmt, *args):
        self._log(NOTE, fmt, *args)

    def info(self, fmt, *args):
        self._log(INFO, fmt, *args)

    def debug(self, fmt, *args):
        self._log(DEBUG, fmt, *args)

    def debug1(self, fmt, *args):
        self._log(DEBUG1, fmt, *args)

    def timer(self, msg, t=None):
        """Report CPU and wall seconds since ``t`` (or construction); returns now."""
        now = (time.process_time(), time.perf_counter())
        t = t or self._t0
        self._log(DEBUG, "    CPU time for %s %9.2f sec, wall time %9.2f sec",
                  msg, now[0] - t[0], now[1] - t[1])
        return now
