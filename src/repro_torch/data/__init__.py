"""Versioned training data on the port: a dataset version checked out of a
CVD through the single-version gather kernels."""
from .pipeline import VersionedDataset

__all__ = ["VersionedDataset"]
