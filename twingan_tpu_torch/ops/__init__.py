"""Tensor ops of the port; each module names its JAX counterpart."""
