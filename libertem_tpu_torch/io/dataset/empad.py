"""Thermo Fisher EMPAD dataset (counterpart of
``libertem_tpu/io/dataset/empad.py``): XML metadata and raw float32
frames of 130x128, whose last 2 rows are per-frame metadata; the sig
is 128x128.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence
from xml.etree import ElementTree as ET

import numpy as np

from ...common.math import prod
from ...common.shape import Shape
from .base import (
    DataSet,
    DataSetException,
    DataSetMeta,
    FileRecords,
    Partition,
    resolve_sig_override,
)

DETECTOR_SIZE = (128, 128)
RAW_FRAME_SIZE = (130, 128)  # 2 trailing junk rows


def params_from_xml(path: str, mode: str = "acquire"):
    root = ET.parse(path).getroot()
    raw_name = root.find("raw_file").attrib["filename"]
    path_raw = os.path.join(
        os.path.dirname(path), os.path.basename(raw_name)
    )
    typ = root.find("type")
    if typ is None or typ.text == "scan":
        scans = [
            e for e in root.findall("scan_parameters")
            if e.attrib.get("mode") == mode
        ]
        if not scans:
            # any scan_parameters element, before failing
            scans = root.findall("scan_parameters")
        if not scans:
            raise DataSetException(
                f"{path}: no scan_parameters element in EMPAD XML"
            )
        nav_x = int(scans[0].find("scan_resolution_x").text)
        nav_y = int(scans[0].find("scan_resolution_y").text)
        nav_shape = (nav_y, nav_x)
    elif typ.text == "series":
        nav_shape = (int(root.find("count").text),)
    else:
        raise DataSetException(f"unknown EMPAD type: {typ.text}")
    return path_raw, nav_shape


class EMPADPartition(Partition):
    def __init__(self, path, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._records = FileRecords(
            [(path, 0, self.meta.image_count, 0)],
            prod(RAW_FRAME_SIZE) * 4, 0, prod(DETECTOR_SIZE) * 4,
            self.io_backend,
        )

    def _read_raw_frames(self, start, stop, out):
        flat = out.reshape(stop - start, -1).view(np.uint8)
        for rows, a, b in self._records.rows(start, stop):
            flat[a:b] = rows


class EMPADDataSet(DataSet):
    """``path``: the XML file (nav from its scan parameters) or the raw
    file (1-D nav without ``nav_shape``)."""

    def __init__(
        self,
        path: str,
        nav_shape: Optional[Sequence[int]] = None,
        sig_shape: Optional[Sequence[int]] = None,
        sync_offset: int = 0,
        scan_size=None,
        io_backend=None,
        num_partitions: Optional[int] = None,
    ):
        super().__init__(io_backend=io_backend,
                         num_partitions=num_partitions)
        self._path = path
        self._nav_shape = tuple(nav_shape or scan_size or ())
        self._sig_override = resolve_sig_override(sig_shape, DETECTOR_SIZE)
        self._sync_offset = int(sync_offset)

    def initialize(self, executor=None) -> "EMPADDataSet":
        path_raw = self._path
        nav_shape = self._nav_shape
        if self._path.lower().endswith(".xml"):
            path_raw, xml_nav = params_from_xml(self._path)
            nav_shape = nav_shape or xml_nav
        self._path_raw = path_raw
        frame_bytes = prod(RAW_FRAME_SIZE) * 4
        image_count = os.path.getsize(path_raw) // frame_bytes
        if not nav_shape:
            nav_shape = (image_count,)
        self._meta = DataSetMeta(
            shape=Shape(tuple(nav_shape) + self._sig_override,
                        sig_dims=len(self._sig_override)),
            raw_dtype=np.dtype(np.float32),
            sync_offset=self._sync_offset,
            image_count=image_count,
        )
        return self

    def get_partitions(self) -> Iterator[EMPADPartition]:
        for idx, (start, stop) in enumerate(self.get_partition_ranges()):
            yield EMPADPartition(
                self._path_raw, self.meta, start, stop - start,
                idx=idx, io_backend=self._io_backend,
            )

    @classmethod
    def detect_params(cls, path: str, executor=None):
        if path.lower().endswith(".xml"):
            try:
                path_raw, nav_shape = params_from_xml(path)
                if os.path.exists(path_raw):
                    return {"path": path}
            except Exception:
                return False
        if path.lower().endswith(".raw"):
            size = os.path.getsize(path)
            if size % (prod(RAW_FRAME_SIZE) * 4) == 0 and size > 0:
                return {"path": path}
        return False

    @classmethod
    def get_supported_extensions(cls) -> set:
        return {"xml", "raw"}
