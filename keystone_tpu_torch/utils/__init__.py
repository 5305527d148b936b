"""Utilities of the port (``checkpoint.py``)."""
