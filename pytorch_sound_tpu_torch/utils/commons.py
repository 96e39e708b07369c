"""Logging helper, the port's copy of ``pytorch_sound_tpu/utils/commons.py``'s
``log`` (a formatted, non-propagating INFO logger named 'main')."""

import logging


def get_logger(name: str) -> logging.Logger:
    """Get a formatted, non-propagating INFO logger."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.propagate = False
        logger.setLevel(logging.INFO)
        ch = logging.StreamHandler()
        ch.setLevel(logging.INFO)
        ch.setFormatter(logging.Formatter(
            '[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s'))
        logger.addHandler(ch)
    return logger


LOGGER = get_logger('main')


def log(msg: str):
    """Log through the global logger."""
    LOGGER.info(msg)
