"""Training-side configuration and translation of the port."""
