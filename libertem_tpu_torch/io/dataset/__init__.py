"""Dataset formats: in-memory arrays and raw binary files."""
