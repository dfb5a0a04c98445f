"""Host-neutral helpers: shapes, slices, buffers and the device rule.

Re-exports ``Shape``, ``Slice`` and ``SliceUsageError``, as the JAX
package's ``common`` does."""
from .shape import Shape
from .slice import Slice, SliceUsageError

__all__ = ["Shape", "Slice", "SliceUsageError"]
