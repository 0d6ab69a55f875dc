"""The port's version, answered by ``GET /serve/openai/version``."""

__version__ = "0.1.0"
