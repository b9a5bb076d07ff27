"""Experiments: kernels that answer a question and sit off the prove path."""
