"""Dataset -> dask.array adapter (counterpart of
``libertem_tpu/contrib/daskadapter.py``); dask is imported where it is
used.  A chunk reads its partition's frames on the host
(``Partition.read_dataset_frames``), not through the card.
"""
from __future__ import annotations

import numpy as np


def make_dask_array(dataset, dtype=None, roi=None):
    """Wrap a DataSet as a dask.array with one chunk per partition.

    With ``roi`` (nav-shaped bool mask) each chunk holds only the
    selected frames of its partition and the array stays flat
    ``(n_selected, *sig)``; only without a roi is it reshaped to the
    nav shape.
    """
    try:
        import dask.base
        import dask.array as da
    except ImportError as e:
        raise ImportError(
            "make_dask_array requires dask to be installed"
        ) from e
    dtype = np.dtype(dtype) if dtype is not None else dataset.dtype
    if roi is not None:
        roi = np.asarray(roi).reshape(-1).astype(bool)
    sig = tuple(dataset.shape.sig)
    chunks = []
    # key on content, not just object identity: two arrays over the
    # same dataset with different dtype/roi must not share graph keys
    # (dask would dedupe them into one task set)
    name = "libertem-tpu-torch-ds-" + dask.base.tokenize(
        id(dataset), str(dtype), None if roi is None else roi.tobytes()
    )
    dsk = {}
    for i, partition in enumerate(dataset.get_partitions()):
        dsk[(name, i) + (0,) * len(sig)] = (
            _read_partition, partition, dtype, roi,
        )
        chunks.append(
            partition.num_frames if roi is None
            else partition.frames_in_roi(roi)
        )
    n_total = (
        dataset.shape.nav.size if roi is None else int(roi.sum())
    )
    arr = da.Array(
        dsk, name, shape=(n_total,) + sig,
        chunks=(tuple(chunks),) + tuple((s,) for s in sig),
        dtype=dtype,
    )
    workers = {}
    if roi is None:
        arr = arr.reshape(dataset.shape.to_tuple())
    return arr, workers


def _read_partition(partition, dtype, roi=None):
    data = partition.read_dataset_frames(
        partition.start_frame,
        partition.start_frame + partition.num_frames,
    )
    if roi is not None:
        sel = roi[
            partition.start_frame:
            partition.start_frame + partition.num_frames
        ]
        data = data[sel]
    return data.astype(dtype)
