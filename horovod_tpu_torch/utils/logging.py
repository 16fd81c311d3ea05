"""Rank-aware logging (port of ``horovod_tpu/utils/logging.py``).

Python ``logging`` under the logger ``horovod_tpu_torch``, its level from
``HVD_LOG_LEVEL`` (``trace`` = 5, ``debug``, ``info``, ``warning`` (the
default), ``error``, ``fatal``) and its time prefix from
``HVD_LOG_TIMESTAMP`` (on by default), read when the logger is first used.
"""

from __future__ import annotations

import logging
import sys

from . import envs

_LEVELS = {
    "trace": 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

logging.addLevelName(5, "TRACE")

_logger: logging.Logger | None = None


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        logger = logging.getLogger("horovod_tpu_torch")
        level_name = (envs.get(envs.LOG_LEVEL) or "warning").lower()
        logger.setLevel(_LEVELS.get(level_name, logging.WARNING))
        handler = logging.StreamHandler(sys.stderr)
        if envs.get_bool(envs.LOG_TIMESTAMP, True):
            fmt = "[%(asctime)s] [hvd-torch] [%(levelname)s] %(message)s"
        else:
            fmt = "[hvd-torch] [%(levelname)s] %(message)s"
        handler.setFormatter(logging.Formatter(fmt))
        logger.addHandler(handler)
        logger.propagate = False
        _logger = logger
    return _logger


def log(level: str, msg: str, *args) -> None:
    get_logger().log(_LEVELS.get(level, logging.INFO), msg, *args)


def debug(msg: str, *args) -> None:
    get_logger().debug(msg, *args)


def info(msg: str, *args) -> None:
    get_logger().info(msg, *args)


def warning(msg: str, *args) -> None:
    get_logger().warning(msg, *args)


def error(msg: str, *args) -> None:
    get_logger().error(msg, *args)


def exception(msg: str, *args) -> None:
    get_logger().exception(msg, *args)
