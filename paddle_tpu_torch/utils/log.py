"""VLOG-style logging (counterpart of ``paddle_tpu/utils/log.py``, copied;
backs FLAGS_log_level, the glog VLOG(n) discipline of
paddle/common/flags.cc v/vmodule).

Usage: ``log.vlog(2, "...")`` emits only when FLAGS_log_level >= 2;
``get_logger(name)`` returns a standard logging.Logger wired to the
same threshold.
"""
from __future__ import annotations

import logging
import sys
from typing import Optional

from ..base.flags import flag

_loggers = {}


def get_logger(name: str = "paddle_tpu_torch", level: Optional[int] = None) -> logging.Logger:
    if name in _loggers:
        return _loggers[name]
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(
            logging.Formatter("%(levelname)s %(asctime)s %(name)s] %(message)s",
                              datefmt="%H:%M:%S")
        )
        logger.addHandler(h)
        logger.propagate = False
    logger.setLevel(level if level is not None else logging.INFO)
    _loggers[name] = logger
    return logger


def vlog(level: int, msg: str, *args):
    """Emit when FLAGS_log_level >= level (glog VLOG parity)."""
    if flag("log_level") >= level:
        get_logger().info(msg, *args)


def warning(msg: str, *args):
    get_logger().warning(msg, *args)


def error(msg: str, *args):
    get_logger().error(msg, *args)
