"""Conversion helpers beside the core (counterpart of
``libertem_tpu/contrib/``)."""
