"""Step builders and the training driver."""
