"""Host utilities of the data layer (copy of lidardetection_tpu/utils/
common.py:1-45): the name filters of the gt arrays, the rank-0 logger, and
the run's generators.

The JAX package's ``set_random_seed`` seeds numpy's and Python's global
generators; here ``set_random_seed`` returns the generators instead, and
every random draw of the data layer takes its ``np.random.RandomState``
from the caller.
"""

import logging
import random

import numpy as np


def keep_arrays_by_name(gt_names, used_classes):
    """Indices of entries whose name is in used_classes (common_utils.py:229)."""
    inds = [i for i, x in enumerate(gt_names) if x in used_classes]
    return np.array(inds, dtype=np.int64)


def drop_arrays_by_name(gt_names, used_classes):
    inds = [i for i, x in enumerate(gt_names) if x not in used_classes]
    return np.array(inds, dtype=np.int64)


def create_logger(log_file=None, rank=0, log_level=logging.INFO):
    """Rank-0 console+file logger (common_utils.py:116-129)."""
    logger = logging.getLogger(__name__ + f'.rank{rank}')
    logger.setLevel(log_level if rank == 0 else 'ERROR')
    logger.propagate = False
    formatter = logging.Formatter('%(asctime)s  %(levelname)5s  %(message)s')
    if not logger.handlers:
        console = logging.StreamHandler()
        console.setLevel(log_level if rank == 0 else 'ERROR')
        console.setFormatter(formatter)
        logger.addHandler(console)
        if log_file is not None:
            fh = logging.FileHandler(log_file)
            fh.setLevel(log_level if rank == 0 else 'ERROR')
            fh.setFormatter(formatter)
            logger.addHandler(fh)
    return logger


def set_random_seed(seed):
    """The run's host generators made from `seed`: (``random.Random``,
    ``np.random.RandomState``). Nothing global is seeded."""
    return random.Random(seed), np.random.RandomState(seed)
