"""Serving of the port: ``serve_loop`` (``Generator``, ``BatchServer``) and
``stencil_serve`` (``SimServer``, shape-bucketed stencil jobs)."""
from . import serve_loop  # noqa: F401
from . import stencil_serve  # noqa: F401
from .stencil_serve import SimServer  # noqa: F401
