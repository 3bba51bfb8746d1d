"""paper-lm in plain PyTorch."""
