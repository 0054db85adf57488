"""Sparse-optimizer storage: the Split-SGD halves and the forward slab of a store."""
