"""Warning categories of the port (counterpart of
``libertem_tpu/warnings.py``)."""


class UseDiscouragedWarning(FutureWarning):
    """Functionality that works but should be avoided."""
