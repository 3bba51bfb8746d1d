"""Bucket optimizers."""
