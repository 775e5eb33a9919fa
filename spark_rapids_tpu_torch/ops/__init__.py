"""Relational operators over columnar batches."""
