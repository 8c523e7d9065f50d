"""LM models of the port: ``layers`` (shared layers), ``griffin``
(RecurrentGemma decode) and ``api`` (family dispatch)."""
from . import api, griffin, layers  # noqa: F401
