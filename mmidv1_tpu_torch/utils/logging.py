"""Leveled logger with console + optional file sink.

Functional equivalent of the reference's thread-safe ``Logger`` singleton
(``include/utils/Logger.hpp:34-127``): five levels (DEBUG..FATAL), timestamped
``[LEVEL] [component] message`` format, optional append-mode file logging. Built
on :mod:`logging` so it composes with other libraries' logging.
"""

from __future__ import annotations

import logging
import sys
import threading
from typing import Optional

_LEVELS = {
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
    "FATAL": logging.CRITICAL,
}

_FMT = "%(asctime)s [%(levelname)s] [%(component)s] %(message)s"


class Logger:
    """Process-wide logger facade (singleton by module instance)."""

    _instance: Optional["Logger"] = None
    _lock = threading.Lock()

    def __init__(self):
        self._logger = logging.getLogger("mmidv1_tpu_torch")
        self._logger.setLevel(logging.INFO)
        self._logger.propagate = False
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FMT, datefmt="%Y-%m-%d %H:%M:%S"))
        self._logger.addHandler(handler)
        self._file_handler: Optional[logging.Handler] = None

    @classmethod
    def get_instance(cls) -> "Logger":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def set_log_level(self, level: str):
        self._logger.setLevel(_LEVELS[level.upper()])

    def enable_file_logging(self, path: str):
        """Append-mode file sink (reference ``Logger::enableFileLogging``)."""
        if self._file_handler is not None:
            self._logger.removeHandler(self._file_handler)
        self._file_handler = logging.FileHandler(path, mode="a")
        self._file_handler.setFormatter(
            logging.Formatter(_FMT, datefmt="%Y-%m-%d %H:%M:%S"))
        self._logger.addHandler(self._file_handler)

    def disable_file_logging(self):
        if self._file_handler is not None:
            self._logger.removeHandler(self._file_handler)
            self._file_handler = None

    def _log(self, level: int, component: str, message: str):
        self._logger.log(level, message, extra={"component": component})

    def debug(self, component: str, message: str):
        self._log(logging.DEBUG, component, message)

    def info(self, component: str, message: str):
        self._log(logging.INFO, component, message)

    def warning(self, component: str, message: str):
        self._log(logging.WARNING, component, message)

    def error(self, component: str, message: str):
        self._log(logging.ERROR, component, message)

    def fatal(self, component: str, message: str):
        self._log(logging.CRITICAL, component, message)


class BoundLogger:
    """Component-bound view of the singleton: ``log.info(msg)`` style."""

    def __init__(self, component: str):
        self._component = component
        self._logger = Logger.get_instance()

    def __getattr__(self, level):
        if level in ("debug", "info", "warning", "error", "fatal"):
            fn = getattr(self._logger, level)
            return lambda message: fn(self._component, message)
        raise AttributeError(level)


def get_logger(component: Optional[str] = None):
    """The singleton, or a component-bound view when ``component`` is given."""
    if component is None:
        return Logger.get_instance()
    return BoundLogger(component)
