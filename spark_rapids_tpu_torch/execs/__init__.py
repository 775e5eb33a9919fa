"""Streaming columnar operators."""
