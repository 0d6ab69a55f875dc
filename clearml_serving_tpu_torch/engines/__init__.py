"""The port's engine registry: the CPU engines, ``jax`` (model bundles and
imported graphs on torch), ``jax_grpc`` (the client of the engine server,
``engine_server/``) and ``llm``.

Counterpart of ``clearml_serving_tpu/engines/__init__.py``.
"""

from .base import BaseEngineRequest, get_engine_cls, load_engine_modules, register_engine

# Import engine implementations so they self-register.
from . import cpu_engines  # noqa: F401
from . import jax_engine  # noqa: F401
from . import grpc_client  # noqa: F401
from ..llm import openai_api as _llm_engine  # noqa: F401

__all__ = [
    "BaseEngineRequest",
    "get_engine_cls",
    "load_engine_modules",
    "register_engine",
]
