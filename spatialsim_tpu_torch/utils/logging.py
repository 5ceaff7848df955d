"""Tagged logging.

The reference logs with ``[Tag]`` prefixes throughout (``[NBody]``,
``[Record]``, ``[Compress]``, ...; SURVEY.md §5).  Same convention, plus a
global verbosity switch so library use stays quiet.
"""

from __future__ import annotations

import sys
import time

_VERBOSITY = 1


def set_verbosity(level: int) -> None:
    """0 = silent, 1 = normal (default), 2 = debug with timestamps."""
    global _VERBOSITY
    _VERBOSITY = level


def log(tag: str, message: str, level: int = 1) -> None:
    if _VERBOSITY < level:
        return
    prefix = f"[{tag}]"
    if _VERBOSITY >= 2:
        prefix = f"{time.strftime('%H:%M:%S')} {prefix}"
    print(f"{prefix} {message}", file=sys.stderr if level >= 2 else sys.stdout)
