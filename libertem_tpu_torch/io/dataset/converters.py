"""The GUI's parameter schema of each dataset format (counterpart of
``libertem_tpu/io/dataset/converters.py``): a MessageConverter with a
JSON schema a format, which validates what the open form sends and
converts it to ``Context.load``'s keyword arguments.
"""
from __future__ import annotations

from ...common.messageconverter import MessageConverter

_SHAPE = {
    "type": "array",
    "items": {"type": "integer", "minimum": 1},
    "minItems": 1,
}


def _base_properties(type_const: str) -> dict:
    return {
        "type": {"const": type_const},
        "path": {"type": "string"},
        "nav_shape": _SHAPE,
        "sig_shape": _SHAPE,
        "sync_offset": {"type": "integer"},
    }


def _shape_tuples(data: dict) -> dict:
    out = dict(data)
    for key in ("nav_shape", "sig_shape"):
        if out.get(key) is not None:
            out[key] = tuple(out[key])
    out.pop("type", None)
    return out


# GUI-side knobs that validate but never reach the loader: 'name'
# labels the dataset in the GUI, 'enable_direct'/'io_backend' select
# read paths the RangeReader negotiates itself
_GUI_ONLY = {"type", "name", "enable_direct", "io_backend"}


class _PathConverter(MessageConverter):
    TYPE = "BASE"
    EXTRA: dict = {}
    REQUIRED = ["type", "path"]

    @property
    def SCHEMA(self):  # noqa: N802 (the JAX package's name)
        return {
            "type": "object",
            "properties": {
                **_base_properties(self.TYPE), **self.EXTRA,
                "name": {"type": "string"},
                "enable_direct": {"type": "boolean"},
                "io_backend": {"type": "string"},
            },
            "required": self.REQUIRED,
        }

    def convert_to_python(self, raw_data: dict) -> dict:
        # only the schema's declared properties
        props = set(self.SCHEMA["properties"]) - _GUI_ONLY
        return _shape_tuples({
            k: v for k, v in raw_data.items() if k in props
        })


class RawDatasetParams(_PathConverter):
    TYPE = "RAW"
    EXTRA = {"dtype": {"type": "string"}}
    REQUIRED = ["type", "path", "dtype", "nav_shape", "sig_shape"]

    def convert_to_python(self, raw_data: dict) -> dict:
        # RAW passes its shapes through unchanged (lists stay lists;
        # RawFileDataSet normalizes them), unlike the other formats'
        # tuples
        props = set(self.SCHEMA["properties"]) - _GUI_ONLY
        return {
            k: v for k, v in raw_data.items() if k in props
        }


class MemoryDatasetParams(MessageConverter):
    """GUI/test parameters of the in-memory dataset."""
    TYPE = "MEMORY"
    SCHEMA = {
        "type": "object",
        "properties": {
            "type": {"const": "MEMORY"},
            "tileshape": _SHAPE,
            "datashape": _SHAPE,
            "num_partitions": {"type": "number", "minimum": 1},
            "sig_dims": {"type": "number", "minimum": 1},
            "tiledelay": {"type": "number"},
            "nav_shape": _SHAPE,
            "sig_shape": _SHAPE,
            "sync_offset": {"type": "number"},
        },
        "required": ["type", "tileshape", "num_partitions"],
    }

    def convert_to_python(self, raw_data: dict) -> dict:
        data = {
            k: raw_data[k]
            for k in ("tileshape", "num_partitions", "sig_dims",
                      "tiledelay", "datashape", "sync_offset")
            if k in raw_data
        }
        return _shape_tuples({
            **data,
            **{k: raw_data[k] for k in ("nav_shape", "sig_shape")
               if k in raw_data},
        })


class NPYDatasetParams(_PathConverter):
    TYPE = "NPY"


class HDF5DatasetParams(_PathConverter):
    TYPE = "HDF5"
    EXTRA = {"ds_path": {"type": "string"}}


class MIBDatasetParams(_PathConverter):
    TYPE = "MIB"


class K2ISDatasetParams(_PathConverter):
    TYPE = "K2IS"


class EMPADDatasetParams(_PathConverter):
    TYPE = "EMPAD"


class BLODatasetParams(_PathConverter):
    TYPE = "BLO"


class MRCDatasetParams(_PathConverter):
    TYPE = "MRC"


class SEQDatasetParams(_PathConverter):
    TYPE = "SEQ"


class TVIPSDatasetParams(_PathConverter):
    TYPE = "TVIPS"


class SERDatasetParams(_PathConverter):
    TYPE = "SER"


class DMDatasetParams(_PathConverter):
    TYPE = "DM"


class FRMS6DatasetParams(_PathConverter):
    TYPE = "FRMS6"


class RawCSRDatasetParams(_PathConverter):
    TYPE = "RAW_CSR"


CONVERTERS = {
    c.TYPE: c for c in (
        MemoryDatasetParams,
        RawDatasetParams, NPYDatasetParams, HDF5DatasetParams,
        MIBDatasetParams, K2ISDatasetParams, EMPADDatasetParams,
        BLODatasetParams, MRCDatasetParams, SEQDatasetParams,
        TVIPSDatasetParams, SERDatasetParams, DMDatasetParams,
        FRMS6DatasetParams, RawCSRDatasetParams,
    )
}


# DataSet class name -> converter (for DataSet.get_msg_converter)
CLASS_CONVERTERS = {
    "MemoryDataSet": MemoryDatasetParams,
    "RawFileDataSet": RawDatasetParams,
    "NPYDataSet": NPYDatasetParams,
    "H5DataSet": HDF5DatasetParams,
    "MIBDataSet": MIBDatasetParams,
    "K2ISDataSet": K2ISDatasetParams,
    "EMPADDataSet": EMPADDatasetParams,
    "BloDataSet": BLODatasetParams,
    "MRCDataSet": MRCDatasetParams,
    "SEQDataSet": SEQDatasetParams,
    "TVIPSDataSet": TVIPSDatasetParams,
    "SERDataSet": SERDatasetParams,
    "DMDataSet": DMDatasetParams,
    "SingleDMDataSet": DMDatasetParams,
    "FRMS6DataSet": FRMS6DatasetParams,
    "RawCSRDataSet": RawCSRDatasetParams,
}


def get_converter(type_id: str):
    return CONVERTERS.get(type_id.upper())
