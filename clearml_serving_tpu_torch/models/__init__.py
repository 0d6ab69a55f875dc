"""Model architecture registry of the port.

Counterpart of ``clearml_serving_tpu/models/__init__.py``. Each architecture
module registers ``build(config) -> bundle``, a namespace with:

- ``config``: the resolved config;
- ``init(generator)``: random parameters on the generator's device, in the
  reference's layout (the layout a bundle file holds);
- ``convert_params(tree, device)``: a tree in the reference's layout (the
  JAX package's parameters pulled to numpy, or a bundle file's tensors) ->
  this module's tree on ``device``;
- ``apply(params, *inputs)`` over the converted tree (not for ``llama``,
  which the LLM engine runs through ``Llama``; for ``whisper`` it is the
  teacher-forced decoder, and the audio routes run ``llm/audio.py``).

Model payloads on disk are bundles: a directory with ``model_config.json``
(``{"arch": ..., "config": {...}}``) and ``params.msgpack``
(``utils/flax_msgpack.py``), read by ``engines/jax_engine.py``.
"""

from types import SimpleNamespace
from typing import Any, Callable, Dict

_BUILDERS: Dict[str, Callable[[dict], Any]] = {}


def register_model(name: str):
    def _decorator(fn):
        _BUILDERS[name] = fn
        return fn

    return _decorator


def build_model(arch: str, config: dict) -> SimpleNamespace:
    try:
        builder = _BUILDERS[arch]
    except KeyError:
        raise ValueError(
            "unknown model arch {!r}; registered: {}".format(arch, sorted(_BUILDERS))
        ) from None
    return builder(config or {})


def registered_archs():
    return sorted(_BUILDERS)


from . import mlp  # noqa: E402,F401
from . import cnn  # noqa: E402,F401
from . import bert  # noqa: E402,F401
from . import llama  # noqa: E402,F401
from . import whisper  # noqa: E402,F401
