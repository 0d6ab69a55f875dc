"""The port's processor-backed app over an engine a test built itself.

The tests carry the reference's weights into a port engine
(``convert_params``), then serve it the way the port serves an endpoint: a
``ModelRequestProcessor`` on a fresh state root whose lookup holds
``LLMEngineRequest.wrap(engine, ...)`` for the endpoint, behind
``build_app(processor)``. The app's cleanup stops the engine."""

import tempfile

from clearml_serving_tpu_torch.llm.openai_api import LLMEngineRequest
from clearml_serving_tpu_torch.serving.main import build_app
from clearml_serving_tpu_torch.serving.model_request_processor import ModelRequestProcessor


def port_processor(engine, tokenizer, url, state_root=None, **engine_cfg):
    """A port processor serving ``engine`` as the ``llm`` endpoint ``url``;
    ``engine_cfg`` holds the endpoint's aux knobs (``warmup``,
    ``default_priority``, ``chat``)."""
    root = state_root or tempfile.mkdtemp(prefix="tpuserve-port-state-")
    mrp = ModelRequestProcessor(state_root=str(root), force_create=True, name="port",
                                device="cpu")
    proc = LLMEngineRequest.wrap(engine, tokenizer, url, engine_cfg=engine_cfg)
    mrp.add_endpoint(proc.endpoint)
    mrp.serialize()
    mrp.deserialize(skip_sync=True)
    mrp._engine_processor_lookup[url] = proc
    return mrp


def port_app(engine, tokenizer, url, **engine_cfg):
    """``build_app`` over ``port_processor``."""
    return build_app(port_processor(engine, tokenizer, url, **engine_cfg))
