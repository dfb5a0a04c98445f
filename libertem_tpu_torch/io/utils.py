"""Partition sizing in items (counterpart of
``libertem_tpu/io/utils.py``)."""
from __future__ import annotations

from math import prod
from typing import Tuple

from ..common.shape import Shape


def get_partition_shape(
    dataset_shape: Shape,
    target_size_items: int,
    min_num: int,
    num_cores: int,
) -> Tuple[int, ...]:
    """The nav-shaped extent of a partition of about
    ``target_size_items`` pixels, with at least ``min_num`` partitions
    and a multiple of ``num_cores`` of them.  Nav axes fill from the
    fastest outward; the first axis that overshoots is cut.  (The
    engine itself partitions by bytes, ``DataSet.get_num_partitions``.)
    """
    sig_size = dataset_shape.sig.size
    num_cores = max(1, num_cores)
    num_items = dataset_shape.size / target_size_items
    per_core = num_items // num_cores + min(1, num_items % num_cores)
    num = max(1, min_num, num_cores * per_core)
    target = int(dataset_shape.size // num)

    shape: Tuple[int, ...] = ()
    for dim in reversed(tuple(dataset_shape.nav)):
        proposed = (dim,) + shape
        if prod(proposed) * sig_size <= target:
            shape = proposed
        else:
            overshoot = prod(proposed) * sig_size / target
            shape = (max(1, int(dim // overshoot)),) + shape
            break
    pad = len(tuple(dataset_shape.nav)) - len(shape)
    return (1,) * pad + shape


def get_owner_name(full_path, stat) -> str:
    """The user name owning a stat'ed path (its uid where the passwd
    entry is gone or there is no ``pwd`` module)."""
    try:
        import pwd
        return pwd.getpwuid(stat.st_uid).pw_name
    except (ImportError, KeyError):
        return str(stat.st_uid)
