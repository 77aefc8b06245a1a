"""Batched rank / LF primitives on torch tensors."""
