"""Tensor-infer wire protocol for router <-> engine-server gRPC.

The port's copy of ``clearml_serving_tpu/engine_server/protocol.py``, byte
for byte on the wire: a client of either package talks to a server of the
other. Named, typed, dense tensors in and out, addressed by model name and
version, encoded with ``msgpack`` (``use_bin_type=True``) over gRPC generic
methods; numpy buffers ride as raw bytes.

Methods (full method names on the wire):
    /tpuserve.Engine/Infer   InferRequest -> InferResponse
    /tpuserve.Engine/Status  {} -> {models: {name: {...}}, devices: [...]}
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import msgpack
import numpy as np

INFER_METHOD = "/tpuserve.Engine/Infer"
STATUS_METHOD = "/tpuserve.Engine/Status"


def encode_tensor(name: str, array: np.ndarray) -> Dict[str, Any]:
    array = np.ascontiguousarray(array)
    return {
        "name": name,
        "dtype": array.dtype.str,  # endianness-qualified, e.g. '<f4'
        "shape": list(array.shape),
        "data": array.tobytes(),
    }


def decode_tensor(t: Dict[str, Any]) -> Tuple[str, np.ndarray]:
    array = np.frombuffer(t["data"], dtype=np.dtype(t["dtype"])).reshape(t["shape"])
    return t["name"], array


def encode_infer_request(
    model: str,
    inputs: Dict[str, np.ndarray],
    version: Optional[str] = None,
    output_names: Optional[List[str]] = None,
) -> bytes:
    return msgpack.packb(
        {
            "model": model,
            "version": version or "",
            "inputs": [encode_tensor(k, v) for k, v in inputs.items()],
            "outputs": list(output_names or []),
        },
        use_bin_type=True,
    )


def decode_infer_request(data: bytes) -> Dict[str, Any]:
    req = msgpack.unpackb(data, raw=False)
    req["inputs"] = dict(decode_tensor(t) for t in req.get("inputs", []))
    return req


def encode_infer_response(outputs: Dict[str, np.ndarray]) -> bytes:
    return msgpack.packb(
        {"outputs": [encode_tensor(k, v) for k, v in outputs.items()]},
        use_bin_type=True,
    )


def decode_infer_response(data: bytes) -> Dict[str, np.ndarray]:
    resp = msgpack.unpackb(data, raw=False)
    return dict(decode_tensor(t) for t in resp.get("outputs", []))


def encode_obj(obj: Any) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def decode_obj(data: bytes) -> Any:
    return msgpack.unpackb(data, raw=False)
