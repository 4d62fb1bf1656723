"""Serving clients of the port."""
