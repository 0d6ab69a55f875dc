"""The engine server of the ``jax_grpc`` topology, on torch.

Counterpart of ``clearml_serving_tpu/engine_server/``: ``protocol`` (the
wire), ``batcher`` (the dynamic batcher), ``repo`` (the reconciler and the
served models) and ``server`` (the gRPC service, its metrics and
``tpu-serving-torch-engine``). The router's client is
``engines/grpc_client.py``.
"""
