"""Transformer building blocks (tensor-parallel world size 1)."""
