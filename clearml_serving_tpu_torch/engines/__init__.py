"""The port's engine registry: the CPU engines and ``llm``.

Counterpart of ``clearml_serving_tpu/engines/__init__.py``. The reference's
``jax`` and ``jax_grpc`` engines are not ported yet (``base.UNPORTED_ENGINES``).
"""

from .base import BaseEngineRequest, get_engine_cls, load_engine_modules, register_engine

# Import engine implementations so they self-register.
from . import cpu_engines  # noqa: F401
from ..llm import openai_api as _llm_engine  # noqa: F401

__all__ = [
    "BaseEngineRequest",
    "get_engine_cls",
    "load_engine_modules",
    "register_engine",
]
