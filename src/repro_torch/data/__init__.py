"""Synthetic data and worker partitioning (numpy only)."""
