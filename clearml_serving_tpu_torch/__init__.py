"""PyTorch/CUDA port of clearml_serving_tpu for one NVIDIA H100.

A package of its own beside the JAX package, which stays the reference the
port is held against. It imports ``torch``, never ``jax``, and nothing of
``clearml_serving_tpu``: what it needs from there it carries as its own
copy. Module names mirror the reference's (``ops/``, ``models/``, ``llm/``,
``serving/``) so every counterpart is easy to find. Each Pallas kernel of the
reference on a ported path becomes a hand-written Hopper kernel under
``csrc/``, built with ``nvcc`` at first use.

Entry points take ``device`` (default ``"cuda"``) and raise where CUDA is
missing unless the caller asks for ``"cpu"``.
"""
