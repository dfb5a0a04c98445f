"""Version info (counterpart of ``libertem_tpu/versioning.py``): the
port's version and its backend's, torch and CUDA, never jax."""
from . import __version__


def get_version() -> str:
    return __version__


def get_backend_versions() -> dict:
    import numpy
    import torch
    return {
        "libertem_tpu_torch": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "numpy": numpy.__version__,
    }
