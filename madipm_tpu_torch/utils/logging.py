"""Leveled console + file logger (the ``Logger`` of
``madipm_tpu/utils/logging.py``; the profiler hook is ROADMAP item A10)."""

from __future__ import annotations

import sys
from typing import Optional, TextIO

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

    def notice(self, msg: str):
        self.log(PrintLevel.NOTICE, msg)

    def error(self, msg: str):
        self.log(PrintLevel.ERROR, msg)
