"""CPU engines: sklearn / xgboost / lightgbm / custom / custom_async.

The port's copy of ``clearml_serving_tpu/engines/cpu_engines.py``.

Capability parity with the reference's CPU engine set
(clearml_serving/serving/preprocess_service.py:449-616). These are
engine-agnostic Python paths carried over conceptually: joblib/booster loading +
``predict``, user-code-only ``custom``, and a fully-async ``custom_async``
variant whose injected ``send_request`` is awaitable.

xgboost / lightgbm are gated on import availability (not baked into every
image); constructing an endpoint for a missing engine raises a clear
EndpointModelError instead of an ImportError at call time.
"""

from __future__ import annotations

import asyncio
from typing import Any, Optional

from .base import BaseEngineRequest, EndpointModelError, register_engine


@register_engine("sklearn", modules=["joblib", "sklearn"])
class SklearnEngineRequest(BaseEngineRequest):
    def _native_load(self) -> Any:
        if not self._model_local_path:
            raise EndpointModelError(
                "sklearn endpoint {!r} has no model payload".format(
                    self.endpoint.serving_url
                )
            )
        import joblib

        return joblib.load(self._model_local_path)

    def process(self, data: Any, state: dict, collect_fn=None) -> Any:
        if self._preprocess is not None and hasattr(self._preprocess, "process"):
            return self._preprocess.process(data, state, collect_fn)
        return self._model.predict(data)


@register_engine("xgboost", modules=["xgboost"])
class XGBoostEngineRequest(BaseEngineRequest):
    def _native_load(self) -> Any:
        try:
            import xgboost  # noqa
        except ImportError:
            raise EndpointModelError(
                "xgboost is not installed in this serving image"
            ) from None
        if not self._model_local_path:
            raise EndpointModelError("xgboost endpoint has no model payload")
        booster = xgboost.Booster()
        booster.load_model(self._model_local_path)
        return booster

    def process(self, data: Any, state: dict, collect_fn=None) -> Any:
        if self._preprocess is not None and hasattr(self._preprocess, "process"):
            return self._preprocess.process(data, state, collect_fn)
        import xgboost

        return self._model.predict(xgboost.DMatrix(data))


@register_engine("lightgbm", modules=["lightgbm"])
class LightGBMEngineRequest(BaseEngineRequest):
    def _native_load(self) -> Any:
        try:
            import lightgbm  # noqa
        except ImportError:
            raise EndpointModelError(
                "lightgbm is not installed in this serving image"
            ) from None
        if not self._model_local_path:
            raise EndpointModelError("lightgbm endpoint has no model payload")
        return lightgbm.Booster(model_file=self._model_local_path)

    def process(self, data: Any, state: dict, collect_fn=None) -> Any:
        if self._preprocess is not None and hasattr(self._preprocess, "process"):
            return self._preprocess.process(data, state, collect_fn)
        return self._model.predict(data)


@register_engine("custom")
class CustomEngineRequest(BaseEngineRequest):
    """Inference entirely in user code: ``Preprocess.process`` is the model."""

    def process(self, data: Any, state: dict, collect_fn=None) -> Any:
        if self._preprocess is None or not hasattr(self._preprocess, "process"):
            raise EndpointModelError(
                "custom endpoint {!r} requires a Preprocess.process()".format(
                    self.endpoint.serving_url
                )
            )
        return self._preprocess.process(data, state, collect_fn)


@register_engine("custom_async")
class CustomAsyncEngineRequest(BaseEngineRequest):
    """All three phases async; injected ``send_request`` is awaitable
    (reference preprocess_service.py:520-616)."""

    is_preprocess_async = True
    is_process_async = True
    is_postprocess_async = True

    def _make_send_request(self):
        async def send_request(
            endpoint: str, version: Optional[str] = None, data: Any = None
        ):
            import aiohttp

            base = self.get_server_config().get("serving_base_url") or ""
            url = "/".join(p.strip("/") for p in (base, endpoint, version or "") if p)
            timeout = aiohttp.ClientTimeout(total=self.request_timeout())
            async with aiohttp.ClientSession(timeout=timeout) as session:
                async with session.post(url, json=data) as resp:
                    if resp.status != 200:
                        return None
                    return await resp.json()

        return send_request

    async def _maybe_await(self, value):
        if asyncio.iscoroutine(value):
            return await value
        return value

    async def preprocess(self, body: Any, state: dict, collect_fn=None) -> Any:
        if self._preprocess is not None and hasattr(self._preprocess, "preprocess"):
            return await self._maybe_await(
                self._preprocess.preprocess(body, state, collect_fn)
            )
        return body

    async def process(self, data: Any, state: dict, collect_fn=None) -> Any:
        if self._preprocess is None or not hasattr(self._preprocess, "process"):
            raise EndpointModelError(
                "custom_async endpoint {!r} requires a Preprocess.process()".format(
                    self.endpoint.serving_url
                )
            )
        return await self._maybe_await(self._preprocess.process(data, state, collect_fn))

    async def postprocess(self, data: Any, state: dict, collect_fn=None) -> Any:
        if self._preprocess is not None and hasattr(self._preprocess, "postprocess"):
            return await self._maybe_await(
                self._preprocess.postprocess(data, state, collect_fn)
            )
        return data
