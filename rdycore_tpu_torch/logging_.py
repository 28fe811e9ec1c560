"""Leveled logging (the rdylogimpl.h replacement): NONE/WARNING/INFO/
DETAIL/DEBUG to stdout or a file, configured from the YAML logging section."""

from __future__ import annotations

import sys
from typing import TextIO

LEVELS = {"none": 0, "warning": 1, "info": 2, "detail": 3, "debug": 4}


class Logger:
    def __init__(self, level: str = "info", file: str = ""):
        self.level = LEVELS[level]
        self._stream: TextIO
        self._own = False
        if file:
            self._stream = open(file, "a")
            self._own = True
        else:
            self._stream = sys.stdout

    def _log(self, lvl: int, tag: str, msg: str):
        if self.level >= lvl:
            self._stream.write(f"[{tag}] {msg}\n")
            self._stream.flush()

    def warning(self, msg: str):
        self._log(1, "WARN", msg)

    def info(self, msg: str):
        self._log(2, "INFO", msg)

    def detail(self, msg: str):
        self._log(3, "DETAIL", msg)

    def debug(self, msg: str):
        self._log(4, "DEBUG", msg)

    def close(self):
        if self._own:
            self._stream.close()
