"""Rank-aware logging (analog of reference ``common/logging.{h,cc}``).

Copy of ``horovod_tpu/utils/logging.py``.  Level comes from
``HVD_TPU_LOG_LEVEL`` / ``HOROVOD_LOG_LEVEL``
(trace/debug/info/warning/error/fatal); messages are prefixed with the
process rank once the runtime is initialized.
"""

from __future__ import annotations

import logging
import sys

from . import env

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

_logger: logging.Logger | None = None


class _RankFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        from .. import runtime

        record.hvd_rank = runtime.rank() if runtime.is_initialized() else "-"
        return True


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        logger = logging.getLogger("horovod_tpu_torch")
        level_name = (env.get_env(env.LOG_LEVEL) or "warning").lower()
        logger.setLevel(_LEVELS.get(level_name, logging.WARNING))
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("[%(asctime)s %(hvd_rank)s %(levelname)s] %(message)s")
        )
        handler.addFilter(_RankFilter())
        logger.addHandler(handler)
        logger.propagate = False
        _logger = logger
    return _logger
