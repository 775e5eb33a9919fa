"""Columnar data: types, columns and batches on torch tensors."""
