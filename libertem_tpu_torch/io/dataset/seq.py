"""Norpix SEQ dataset (counterpart of ``libertem_tpu/io/dataset/seq.py``):
a little-endian header (magic u4 0xFEED, name 24s, version i4,
header_size i4, description 512s, width u4, height u4, bit_depth u4,
bit_depth_real u4, image_size_bytes u4, image_format u4,
allocated_frames u4, origin u4, true_image_size u4, ...); frames start
at 8192 (version >= 5) or 1024, each occupying true_image_size bytes.

Dark/gain sidecars (``<path>.dark.mrc``/``.gain.mrc`` or ``.npy``) and
the XML bad-pixel-map sidecar pair become the CorrectionSet of
``get_correction_data``; ``defusedxml`` is imported only when the XML
sidecars are there.
"""
from __future__ import annotations

import os
import struct
from typing import Iterator, Optional, Sequence

import numpy as np

from ...common.shape import Shape
from ..corrections import CorrectionSet
from .base import (
    DataSet,
    DataSetException,
    DataSetMeta,
    FileRecords,
    Partition,
    resolve_sig_override,
)

_HEADER_STRUCT = "<L24sll512sLLLLLLLLLdlLLLlllLlHH"
_FIELDS = (
    "magic", "name", "version", "header_size", "description",
    "width", "height", "bit_depth", "bit_depth_real",
    "image_size_bytes", "image_format", "allocated_frames",
    "origin", "true_image_size", "suggested_frame_rate",
    "description_format", "reference_frame", "fixed_size", "flags",
    "bayer_pattern", "time_offset_us", "extended_header_size",
    "compression_format", "reference_time_s", "reference_time_ms",
    "reference_time_us",
)


def read_seq_header(path: str) -> dict:
    size = struct.calcsize(_HEADER_STRUCT)
    with open(path, "rb") as f:
        raw = f.read(size)
    vals = struct.unpack(_HEADER_STRUCT, raw)
    h = dict(zip(_FIELDS, vals))
    if h["magic"] != 0xFEED:
        raise DataSetException(f"{path}: not a SEQ file")
    h["image_offset"] = 8192 if h["version"] >= 5 else 1024
    return h


# ---- StreamPix/DE XML bad-pixel-map sidecars ---------------------
# The acquisition software writes <stem>.seq.Config.Metadata.xml
# (several <BadPixelMap> variants, one per hardware binning) and a
# binary <stem>.seq.metadata geometry record; together they give the
# excluded-pixel mask of the CorrectionSet.  Each step is a function
# of its own, as in the JAX package; row/col index strings stay
# strings until rasterization.


def xml_map_sizes(bad_pixel_maps):
    """Per-map ``(Columns, Rows, Binning=1)`` triples, plus the same
    data transposed into ``[(cols...), (rows...), (binnings...)]``."""
    map_sizes = [
        (int(m.attrib["Columns"]), int(m.attrib["Rows"]),
         int(m.attrib.get("Binning", 1)))
        for m in bad_pixel_maps
    ]
    return list(zip(*map_sizes)), map_sizes


def xml_unbinned_map_maker(xy_map_sizes):
    """Candidate sizes per UNBINNED map (0 for binned ones), as
    (rows-derived, cols-derived); every known sidecar is square."""
    cols, rows, binnings = xy_map_sizes
    used_x = [r if b < 2 else 0 for r, b in zip(rows, binnings)]
    used_y = [c if b < 2 else 0 for c, b in zip(cols, binnings)]
    return used_x, used_y


def xml_binned_map_maker(xy_map_sizes):
    """Candidate sizes per BINNED map (0 for unbinned ones)."""
    cols, rows, binnings = xy_map_sizes
    used_x = [r if b > 1 else 0 for r, b in zip(rows, binnings)]
    used_y = [c if b > 1 else 0 for c, b in zip(cols, binnings)]
    return used_x, used_y


def xml_map_index_selector(used_y):
    """Index of the candidate map with the largest column count."""
    return used_y.index(max(used_y))


def xml_defect_coord_extractor(bad_pixel_map, map_index, map_sizes):
    """Defect lists of the chosen map.  Single-attribute ``Defect``
    nodes are full rows/columns (``Rows="a-b"`` ranges split into
    ``['a', 'b']``); two-attribute nodes are individual pixels as
    ``[col, row]``."""
    rows, cols, pixels = [], [], []
    for defect in bad_pixel_map.findall("Defect"):
        a = defect.attrib
        if len(a) == 1:
            if "Rows" in a:
                rows.append(a["Rows"].split("-"))
            if "Row" in a:
                rows.append([a["Row"]])
            if "Columns" in a:
                cols.append(a["Columns"].split("-"))
            if "Column" in a:
                cols.append([a["Column"]])
        else:
            pixels.append([a["Column"], a["Row"]])
    return {
        "rows": rows,
        "cols": cols,
        "pixels": pixels,
        "size": (map_sizes[map_index][0], map_sizes[map_index][1]),
    }


def xml_defect_data_extractor(root, metadata):
    """Pick the ``BadPixelMap`` matching the acquisition's
    ``HardwareBinning`` and extract its defect lists."""
    maps = root.findall(".//BadPixelMap")
    xy, map_sizes = xml_map_sizes(maps)
    if metadata["HardwareBinning"] < 2:
        _, used_y = xml_unbinned_map_maker(xy)
    else:
        _, used_y = xml_binned_map_maker(xy)
    idx = xml_map_index_selector(used_y)
    return xml_defect_coord_extractor(maps[idx], idx, map_sizes)


def array_cropping(arr, start_size, req_size, offsets):
    """Crop ``req_size`` at ``offsets`` out of ``arr`` by centre and
    half width (odd sizes truncate); requests that don't fit return
    ``arr`` unchanged."""
    if (offsets[0] + req_size[0] <= start_size[0]
            and offsets[1] + req_size[1] <= start_size[1]):
        hy, hx = int(req_size[0]) // 2, int(req_size[1]) // 2
        cy, cx = int(offsets[0]) + hy, int(offsets[1]) + hx
        return arr[cy - hy:cy + hy, cx - hx:cx + hx]
    return arr


def xml_generate_map_size(exc_rows, exc_cols, exc_pix, size,
                          metadata):
    """Rasterize the defect lists onto the full map, then crop to
    the acquired window (frame size and offsets halve when the
    acquisition is hardware-binned)."""
    req = (
        metadata["UnbinnedFrameSizeY"], metadata["UnbinnedFrameSizeX"]
    )
    offs = (metadata["OffsetY"], metadata["OffsetX"])
    if metadata["HardwareBinning"] > 1:
        req = (req[0] // 2, req[1] // 2)
        offs = (offs[0] // 2, offs[1] // 2)
    # ``size`` arrives as (Columns, Rows); the raster is row-major
    # (rows, cols), which holds on non-square maps too
    mask = np.zeros((size[1], size[0]), dtype=bool)
    for row in exc_rows:
        if len(row) == 1:
            mask[int(row[0])] = True
        else:
            mask[int(row[0]):int(row[1]) + 1] = True
    for col in exc_cols:
        if len(col) == 1:
            mask[:, int(col[0])] = True
        else:
            mask[:, int(col[0]):int(col[1]) + 1] = True
    for pix in exc_pix:
        mask[int(pix[1]), int(pix[0])] = True
    return np.array(
        array_cropping(mask, start_size=(size[1], size[0]),
                       req_size=req, offsets=offs),
        dtype=bool,
    )


def xml_processing(tree, metadata_dict):
    data = xml_defect_data_extractor(tree, metadata_dict)
    mask = xml_generate_map_size(
        data["rows"], data["cols"], data["pixels"], data["size"],
        metadata_dict,
    )
    # CorrectionSet takes the dense bool mask
    return mask


def _load_xml_from_string(xml, metadata):
    import defusedxml.ElementTree as ET

    return xml_processing(ET.fromstring(xml), metadata)


# keys and fixed offset of the binary <stem>.seq.metadata record
# (11 little-endian int32 and a bool at byte 282)
_DE_METADATA_KEYS = (
    "DEMetadataSize", "DEMetadataVersion", "UnbinnedFrameSizeX",
    "UnbinnedFrameSizeY", "OffsetX", "OffsetY", "HardwareBinning",
    "Bitmode", "FrameRate", "RotationMode", "FlipMode", "OkraMode",
)


def _load_excluded_from_sidecars(basename):
    """Excluded-pixel mask from the XML + binary metadata sidecar
    pair next to the data file, or None if either is missing."""
    xml_path = basename + ".seq.Config.Metadata.xml"
    meta_path = basename + ".seq.metadata"
    if not (os.path.exists(xml_path) and os.path.exists(meta_path)):
        return None
    import defusedxml.ElementTree as ET

    root = ET.parse(xml_path).getroot()
    with open(meta_path, "rb") as f:
        raw = f.read()
    metadata = dict(zip(
        _DE_METADATA_KEYS, struct.unpack_from("iiiiiiiiiii?", raw, 282)
    ))
    return xml_processing(root, metadata)


class SEQPartition(Partition):
    def __init__(self, path, header, *args, **kwargs):
        super().__init__(*args, **kwargs)
        h = header
        self._records = FileRecords(
            [(path, 0, self.meta.image_count, h["image_offset"])],
            h["true_image_size"], 0,
            h["width"] * h["height"] * max(1, h["bit_depth"] // 8),
            self.io_backend,
        )

    def _read_raw_frames(self, start, stop, out):
        flat = out.reshape(stop - start, -1).view(np.uint8)
        for rows, a, b in self._records.rows(start, stop):
            flat[a:b] = rows


class SEQDataSet(DataSet):
    """8- and 16-bit SEQ files; without ``nav_shape`` the nav is 1-D."""

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
        self._sig_shape = tuple(sig_shape) if sig_shape else None
        self._sync_offset = int(sync_offset)

    def initialize(self, executor=None) -> "SEQDataSet":
        h = read_seq_header(self._path)
        if h["bit_depth"] not in (8, 16):
            raise DataSetException(
                f"unsupported SEQ bit depth {h['bit_depth']} "
                "(packed 10/12-bit and color formats are not "
                "supported)"
            )
        sig = resolve_sig_override(self._sig_shape,
                                   (h["height"], h["width"]))
        self._h = h
        filesize = os.path.getsize(self._path)
        image_count = (
            (filesize - h["image_offset"]) // h["true_image_size"]
            if h["true_image_size"] else 0
        )
        bpx = max(1, h["bit_depth"] // 8)
        nav_shape = self._nav_shape or (image_count,)
        self._meta = DataSetMeta(
            shape=Shape(tuple(nav_shape) + sig, sig_dims=len(sig)),
            raw_dtype=np.dtype(f"<u{bpx}"),
            sync_offset=self._sync_offset,
            image_count=image_count,
        )
        return self

    def get_correction_data(self) -> CorrectionSet:
        """Dark/gain sidecars next to the data (``.dark.npy``,
        ``.gain.npy``, ``.dark.mrc``, ``.gain.mrc``) and the excluded
        pixels of the XML bad-pixel-map sidecar pair."""
        # '.seq.seq' and '.seq' both occur: the sidecar names build on
        # the bare stem
        name, ext = os.path.splitext(self._path)
        name2, ext2 = os.path.splitext(name)
        if ext.lower() == ".seq" and ext2.lower() == ".seq":
            basename = name2
        elif ext.lower() == ".seq":
            basename = name
        else:
            basename = self._path
        excluded = _load_excluded_from_sidecars(basename)
        dark = gain = None
        base = self._path
        for stem in (base, os.path.splitext(base)[0]):
            d_npy = stem + ".dark.npy"
            g_npy = stem + ".gain.npy"
            if dark is None and os.path.exists(d_npy):
                dark = np.load(d_npy)
            if gain is None and os.path.exists(g_npy):
                gain = np.load(g_npy)
            if dark is None and os.path.exists(stem + ".dark.mrc"):
                dark = _first_mrc_frame(stem + ".dark.mrc")
            if gain is None and os.path.exists(stem + ".gain.mrc"):
                gain = _first_mrc_frame(stem + ".gain.mrc")
        return CorrectionSet(dark=dark, gain=gain,
                             excluded_pixels=excluded)

    def get_partitions(self) -> Iterator[SEQPartition]:
        for idx, (start, stop) in enumerate(self.get_partition_ranges()):
            yield SEQPartition(
                self._path, self._h, self.meta, start, stop - start,
                idx=idx, io_backend=self._io_backend,
            )

    @classmethod
    def detect_params(cls, path: str, executor=None):
        if not path.lower().endswith(".seq"):
            return False
        try:
            read_seq_header(path)
        except Exception:
            return False
        return {"path": path}

    @classmethod
    def get_supported_extensions(cls) -> set:
        return {"seq"}


def _first_mrc_frame(path: str) -> np.ndarray:
    from .mrc import MRCDataSet
    ds = MRCDataSet(path).initialize()
    return next(ds.get_partitions()).read_dataset_frames(0, 1)[0]
