"""Expressions evaluated eagerly over columnar batches."""
