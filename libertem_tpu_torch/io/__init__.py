"""Tiling and datasets."""
