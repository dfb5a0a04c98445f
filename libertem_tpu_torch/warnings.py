"""Warning categories of the port (counterpart of
``libertem_tpu/warnings.py``)."""
import warnings


class UseDiscouragedWarning(FutureWarning):
    """Functionality that works but should be avoided."""


def emit_use_discouraged(msg: str):
    """Warn with :class:`UseDiscouragedWarning`, pointing at the caller
    of the function that calls this."""
    warnings.warn(msg, UseDiscouragedWarning, stacklevel=3)
