from .store import ServingService, StateStore, default_state_root
from .registry import ModelRecord, ModelRegistry

__all__ = [
    "ServingService",
    "StateStore",
    "default_state_root",
    "ModelRecord",
    "ModelRegistry",
]
