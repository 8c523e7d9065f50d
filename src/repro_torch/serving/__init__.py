"""Serving of the port: ``serve_loop`` (``Generator``, ``BatchServer``)."""
from . import serve_loop  # noqa: F401
