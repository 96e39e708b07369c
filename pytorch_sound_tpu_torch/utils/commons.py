"""Logging, a worker pool and checkpoint keys: the port's copies of ``log``
(a formatted, non-propagating INFO logger named 'main'), ``go_multiprocess``
and ``get_loadable_checkpoint`` from ``pytorch_sound_tpu/utils/commons.py``."""

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Sequence, Tuple


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


def get_loadable_checkpoint(checkpoint: Dict[str, Any]) -> Dict[str, Any]:
    """Strip torch-DataParallel ``module.`` prefixes from a flat state dict
    (one prefix per key; other keys as they are)."""
    return {(k[len('module.'):] if k.startswith('module.') else k): v
            for k, v in checkpoint.items()}


def go_multiprocess(worker_func: Callable, inputs: Sequence[Tuple[Any, ...]],
                    num_workers: int = None) -> List[Any]:
    """``[worker_func(*args) for args in inputs]`` on a pool of
    ``num_workers`` (default: half the cores) threads, results in input
    order, as the JAX package's joblib pool returns them. Threads, not
    processes: the workers the port runs here read file headers and
    transcripts, which wait on I/O, and a thread starts without importing
    the package again. A worker's exception is raised here."""
    if not num_workers:
        num_workers = max(1, (os.cpu_count() or 2) // 2)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        return list(pool.map(lambda args: worker_func(*args), inputs))
