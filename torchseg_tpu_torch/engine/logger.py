"""ANSI-colored logger (counterpart of torchseg_tpu/engine/logger.py,
reference furnace/engine/logger.py:14-99): colored console output,
optional file handler, level from ENGINE_LOGGING_LEVEL."""

import logging
import os
import sys

_LOGGER_NAME = "torchseg_tpu_torch"
_COLORS = {"WARNING": 33, "INFO": 36, "DEBUG": 37, "ERROR": 31, "CRITICAL": 31}


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelname, 0)
            return f"\x1b[{color}m{msg}\x1b[0m"
        return msg


def get_logger(log_dir: str = None, log_file: str = None) -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if logger.handlers:
        return logger
    level = os.environ.get("ENGINE_LOGGING_LEVEL", "INFO").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))

    console = logging.StreamHandler()
    console.setFormatter(
        _ColorFormatter("%(asctime)s %(levelname)s %(message)s", "%H:%M:%S")
    )
    logger.addHandler(console)

    if log_dir and log_file:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, log_file))
        fh.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        )
        logger.addHandler(fh)
    return logger
