"""User pre/post-processing contract (duck-typed).

The port's copy of ``clearml_serving_tpu/preprocess/preprocess_template.py``.

This file documents — and is importable as a starting point for — the class a
user attaches to an endpoint with ``--preprocess``. Capability parity with the
reference contract (clearml_serving/preprocess/preprocess_template.py:6-168):
the serving runtime hot-loads this code per endpoint, instantiates ``Preprocess``
once per endpoint per process, and calls the hooks below around every request.

Thread-safety contract (same as the reference): a single instance may serve many
concurrent requests — keep per-request state in the ``state`` dict passed to the
hooks, never on ``self``.

Every method below is optional; async variants (``async def``) are honored for
engines that declare async phases (custom_async, llm).
"""

from typing import Any, Callable, Optional


class Preprocess(object):
    """Example/default implementation: identity passthrough."""

    serving_config = None  # set by the runtime before load()

    def __init__(self):
        # No arguments. Runs inside the serving process at endpoint load time.
        pass

    def load(self, local_file_name: str) -> Any:
        """Optionally load the model payload yourself. Return value replaces the
        engine's default model object (for the `custom` engines this is the only
        model-loading path; for `jax`/`llm` engines returning None keeps the
        engine's native loader). ``local_file_name`` is the local copy of the
        registered model file/directory."""
        return None

    def unload(self) -> None:
        """Called when the endpoint is removed or the process exits."""
        pass

    def preprocess(
        self,
        body: Any,
        state: dict,
        collect_custom_statistics_fn: Optional[Callable[[dict], None]],
    ) -> Any:
        """Raw request body -> model input. ``state`` is per-request scratch
        shared with postprocess. ``collect_custom_statistics_fn({"name": val})``
        feeds the statistics pipeline."""
        return body

    # def process(self, data, state, collect_custom_statistics_fn):
    #     """UNCOMMENT ONLY IF NEEDED. Overrides the engine's inference call —
    #     required for the `custom`/`custom_async` engines, optional elsewhere.
    #     NOTE: if present on a tensor engine (sklearn/jax/...), YOUR code is
    #     the inference; the engine's native predict/compiled path is skipped.
    #     """
    #     return data

    def postprocess(
        self,
        data: Any,
        state: dict,
        collect_custom_statistics_fn: Optional[Callable[[dict], None]],
    ) -> Any:
        """Model output -> response body."""
        return data

    # Injected by the runtime (do not implement):
    #   self.send_request(endpoint: str, version: Optional[str], data: Any) -> Any
    # POSTs to another endpoint on this serving service (pipeline composition).
