"""Structured ``[event] key=value`` logger for progress/summary lines.

The port's twin of ``repro.obs.log``: the same lines.  One formatter for
the progress prints of ``core/batched.py`` and the launchers: an event
tag plus (insertion-ordered) ``key=value`` fields, floats rendered with
``%.4g`` so lines stay diffable.  The sink defaults to ``print`` with a flush
(so a line survives a process that is killed after it) and is swappable
(``set_sink``) so launchers can tee lines or tests can capture them
without monkeypatching stdout.

>>> format_event("bucket", i=0, path="sharded", shards=2, s=0.12345)
'[bucket] i=0 path=sharded shards=2 s=0.1235'
>>> set_level("warn"); info("quiet", x=1); set_level("info")
"""
from __future__ import annotations

import functools

LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}

_PRINT = functools.partial(print, flush=True)
_level = LEVELS["info"]
_sink = _PRINT


def set_level(name: str) -> None:
    global _level
    try:
        _level = LEVELS[name]
    except KeyError:
        raise ValueError(f"unknown log level {name!r} "
                         f"(choose from {sorted(LEVELS)})") from None


def set_sink(fn) -> None:
    """Route lines through ``fn(line)``; ``None`` restores ``print``."""
    global _sink
    _sink = _PRINT if fn is None else fn


def _fmt(v) -> str:
    if isinstance(v, float):
        return format(v, ".4g")
    return str(v)


def format_event(event: str, _msg: str = "", **fields) -> str:
    parts = [f"[{event}]"]
    if _msg:
        parts.append(_msg)
    parts.extend(f"{k}={_fmt(v)}" for k, v in fields.items())
    return " ".join(parts)


def log(level: str, event: str, _msg: str = "", **fields) -> None:
    if LEVELS[level] >= _level:
        _sink(format_event(event, _msg, **fields))


def debug(event: str, _msg: str = "", **fields) -> None:
    log("debug", event, _msg, **fields)


def info(event: str, _msg: str = "", **fields) -> None:
    log("info", event, _msg, **fields)


def warn(event: str, _msg: str = "", **fields) -> None:
    log("warn", event, _msg, **fields)


def error(event: str, _msg: str = "", **fields) -> None:
    log("error", event, _msg, **fields)
