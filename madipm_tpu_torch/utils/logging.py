"""Leveled console + file logger and the profiler hooks: the ``Logger`` and
``profile_trace`` of ``madipm_tpu/utils/logging.py``, and the program's
named spans (:func:`span`, :func:`spanned`)."""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import time
from typing import Optional, TextIO

import torch
from torch._C._profiler import _RecordFunctionFast

from .options import PrintLevel


class Logger:
    """``print_level`` gates the console, ``file_print_level`` the file sink."""

    def __init__(
        self,
        print_level: PrintLevel = PrintLevel.INFO,
        file_print_level: PrintLevel = PrintLevel.INFO,
        output_file: str = "",
    ):
        self.print_level = print_level
        self.file_print_level = file_print_level
        self._file: Optional[TextIO] = None
        if output_file:
            self._file = open(output_file, "a")

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    def log(self, level: PrintLevel, msg: str):
        if level >= self.print_level:
            print(msg, file=sys.stdout, flush=True)
        if self._file is not None and level >= self.file_print_level:
            self._file.write(msg + "\n")
            self._file.flush()

    def info(self, msg: str):
        self.log(PrintLevel.INFO, msg)

    def notice(self, msg: str):
        self.log(PrintLevel.NOTICE, msg)

    def error(self, msg: str):
        self.log(PrintLevel.ERROR, msg)


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str], device=None):
    """Capture a ``torch.profiler`` trace of the block: host activity, and
    the device's kernels and copies when ``device`` is a CUDA device.  The
    Chrome/Perfetto trace goes to ``trace_dir/madipm_<pid>_<ms>.pt.trace.json``
    when the block ends, also when it raises.  No-op when ``trace_dir`` is
    falsy."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"madipm_{os.getpid()}_{int(time.time() * 1e3)}.pt.trace.json")
    prof = profile(activities=activities)
    try:
        with prof:
            try:
                yield
            finally:
                if ProfilerActivity.CUDA in activities:
                    torch.cuda.synchronize(device)
    finally:
        prof.export_chrome_trace(path)


_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span("madipm.ipm.iter"): ...``: a named range around the
    block in the trace of a recording ``torch.profiler``, which also holds
    the CUDA runtime calls and the device's kernels, on the same clock.
    With no profiler recording it costs one check.  The range is the
    profiler's fast form of ``record_function`` (the one torch's compiled
    code emits): ``record_function`` costs several times as much on the
    host, recording or not, and at ~50 spans an iteration it stretches a
    profiled call."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return _RecordFunctionFast(name)


def spanned(name: str):
    """``@spanned(name)``: every call of the function inside :func:`span`."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap
