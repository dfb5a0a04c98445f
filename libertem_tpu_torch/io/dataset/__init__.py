"""The dataset formats by id, ``make`` (what ``Context.load`` builds)
and ``detect`` (counterpart of ``libertem_tpu/io/dataset/__init__.py``).

``filetypes`` maps a format id to ``"module:ClassName"`` (imported
when first asked for) or to a class a caller registered, in the JAX
package's order.  Every format of the JAX package is ported
(``NOT_PORTED`` is empty); a live acquisition is no format of the
registry (``io.dataset.live.LiveDataSet``).
"""
from __future__ import annotations

import importlib
import os
import pathlib
from typing import Optional

from .base import DataSet, DataSetException

_PKG = "libertem_tpu_torch.io.dataset"

filetypes = {
    "memory": f"{_PKG}.memory:MemoryDataSet",
    "raw": f"{_PKG}.raw:RawFileDataSet",
    "npy": f"{_PKG}.npy:NPYDataSet",
    "hdf5": f"{_PKG}.hdf5:H5DataSet",
    "mib": f"{_PKG}.mib:MIBDataSet",
    "empad": f"{_PKG}.empad:EMPADDataSet",
    "blo": f"{_PKG}.blo:BloDataSet",
    "mrc": f"{_PKG}.mrc:MRCDataSet",
    "seq": f"{_PKG}.seq:SEQDataSet",
    "tvips": f"{_PKG}.tvips:TVIPSDataSet",
    "raw_csr": f"{_PKG}.raw_csr:RawCSRDataSet",
    "dm": f"{_PKG}.dm:DMDataSet",
    "frms6": f"{_PKG}.frms6:FRMS6DataSet",
    "k2is": f"{_PKG}.k2is:K2ISDataSet",
    "ser": f"{_PKG}.ser:SERDataSet",
    "dask": f"{_PKG}.dask:DaskDataSet",
}

# format ids of the JAX package without a port yet, and why
NOT_PORTED: dict = {}


def register_dataset_cls(filetype: str, cls) -> None:
    """Register a DataSet under ``filetype``: the class itself, a
    ``module:ClassName`` spec or a dotted ``module.ClassName`` path.
    It takes part in ``Context.load`` and ``detect`` like the
    built-ins."""
    filetypes[filetype.lower()] = cls


def unregister_dataset_cls(filetype: str) -> None:
    del filetypes[filetype.lower()]


def get_dataset_cls(filetype) -> type:
    """The DataSet class of a format id (a class passes through)."""
    if not isinstance(filetype, str):
        return filetype
    key = filetype.lower()
    if key in NOT_PORTED and key not in filetypes:
        raise DataSetException(
            f"format {filetype!r} is not yet ported to "
            f"libertem_tpu_torch ({NOT_PORTED[key]})"
        )
    try:
        spec = filetypes[key]
    except KeyError:
        raise DataSetException(
            f"unknown filetype {filetype!r}; known: {sorted(filetypes)}"
        ) from None
    if not isinstance(spec, str):
        return spec
    if ":" in spec:
        module_name, cls_name = spec.split(":")
    else:
        module_name, _, cls_name = spec.rpartition(".")
    try:
        module = importlib.import_module(module_name)
    except ImportError as e:
        raise DataSetException(f"could not load dataset: {e}") from None
    return getattr(module, cls_name)


def build_extension_map() -> dict:
    """extension -> [format ids], in registration order."""
    ext_map: dict = {}
    for ft in filetypes:
        try:
            cls = get_dataset_cls(ft)
        except Exception:
            continue
        for ext in cls.get_supported_extensions():
            ext_map.setdefault(ext.lower(), []).append(ft)
    return ext_map


def get_search_order(path) -> list:
    """Format ids in detection order: those registered for the path's
    extension first, ``memory`` last."""
    search_order = list(filetypes)
    try:
        ext = pathlib.Path(path).suffix.strip().lstrip(".").lower()
        for ft in reversed(build_extension_map().get(ext, ())):
            search_order.remove(ft)
            search_order.insert(0, ft)
    except (TypeError, ValueError):
        pass
    if "memory" in search_order:
        search_order.remove("memory")
        search_order.append("memory")
    return search_order


def make(filetype: str, *args, **kwargs) -> DataSet:
    """The dataset of ``filetype`` (``"auto"``: detected from the path),
    not yet initialized."""
    if filetype == "auto":
        return _detected(*args, **kwargs)
    return get_dataset_cls(filetype)(*args, **kwargs)


# format id -> extensions, so that detect() ranks the probes without
# importing every format's module
_STATIC_EXTENSIONS = {
    "raw": {"raw", "bin"},
    "npy": {"npy"},
    "hdf5": {"h5", "hdf5", "hspy", "nxs", "emd"},
    "mib": {"mib", "hdr"},
    "empad": {"xml", "raw"},
    "blo": {"blo"},
    "mrc": {"mrc", "mrcs", "rec", "ali", "st"},
    "seq": {"seq"},
    "tvips": {"tvips"},
    "raw_csr": {"toml"},
    "dm": {"dm3", "dm4"},
    "frms6": {"frms6", "hdr"},
    "k2is": {"gtg", "bin"},
    "ser": {"ser"},
}


def detect(path: str) -> Optional[dict]:
    """``{"type": id, "parameters": {...}}`` of the first format whose
    ``detect_params`` takes the file, those of its extension first;
    None if none does."""
    ext = os.path.splitext(path)[1].lstrip(".").lower()
    order = sorted(
        filetypes,
        key=lambda ft: 0 if ext and ext in _STATIC_EXTENSIONS.get(ft, ())
        else 1,
    )
    for ft in order:
        if ft == "memory":
            continue
        try:
            cls = get_dataset_cls(ft)
        except Exception:
            continue
        try:
            params = cls.detect_params(path)
        except Exception:
            params = False
        if params:
            if isinstance(params, dict) and "parameters" in params:
                return {"type": ft, **params}
            return {"type": ft, "parameters": params}
    return None


def get_extensions() -> set:
    """Every supported file extension, lowercased."""
    exts: set = set()
    for ft in filetypes:
        try:
            cls = get_dataset_cls(ft)
        except Exception:
            continue
        exts |= {e.lower() for e in cls.get_supported_extensions()}
    return exts


def _detected(path: str, **kwargs) -> DataSet:
    detected = detect(path)
    if detected is None:
        raise DataSetException(
            f"could not determine DataSet type for file {path!r}"
        )
    params = dict(detected["parameters"])
    params.update(kwargs)
    return get_dataset_cls(detected["type"])(**params)


def detect_and_load(path: str, **kwargs) -> DataSet:
    """The detected format's dataset of ``path``, initialized; keyword
    arguments override the detected parameters."""
    return _detected(path, **kwargs).initialize()
