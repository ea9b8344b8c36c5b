"""ANSI console logger (own copy of ``threepu/utils/logger.py``):
timestamped, colour-coded ``info`` / ``warn`` / ``success`` / ``error``
lines; ``error`` exits the process unless :data:`exit_on_error` is
turned off.
"""

from __future__ import annotations

import datetime
import sys

_RESET = "\033[0m"
_COLORS = {
    "info": "\033[94m",      # blue
    "warn": "\033[93m",      # yellow
    "error": "\033[91m",     # red
    "success": "\033[92m",   # green
}

exit_on_error = True


def _emit(level: str, *messages) -> None:
    stream = sys.stderr if level == "error" else sys.stdout
    stamp = datetime.datetime.now().strftime("%m-%d %H:%M:%S")
    text = " ".join(str(m) for m in messages)
    stream.write(f"{_COLORS[level]}[{level.upper():7s} {stamp}]{_RESET} "
                 f"{text}\n")
    stream.flush()


def info(*messages) -> None:
    _emit("info", *messages)


def warn(*messages) -> None:
    _emit("warn", *messages)


def success(*messages) -> None:
    _emit("success", *messages)


def error(*messages) -> None:
    _emit("error", *messages)
    if exit_on_error:
        sys.exit(1)
