"""Host-neutral helpers: shapes, slices, buffers and the device rule."""
