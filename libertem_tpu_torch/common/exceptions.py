"""Exception types of the port (its own copy of
``libertem_tpu/common/exceptions.py``)."""


class UDFException(Exception):
    """Raised when a UDF is malformed or misused."""


class UDFRunCancelled(Exception):
    """A running UDF job was cancelled."""


class JobCancelledError(Exception):
    """The executor cancelled a job."""


class ExecutorSpecException(Exception):
    """Invalid executor specification."""
