"""The bundle file format on both packages: ``utils/flax_msgpack.py`` and
``engines/jax_engine.py`` (``save_bundle``, ``load_bundle``'s dispatch).

- Round trips both ways: the JAX package's ``save_bundle`` read by the
  port, and the port's ``save_bundle`` read by the JAX package's
  ``load_bundle``; trees equal leaf for leaf (f32, bf16, int8 and int32
  leaves, 0-d scalars, nested lists and dicts), and the port writes flax's
  bytes exactly.
- Chunked leaves, with ``MAX_CHUNK_SIZE`` made small on both sides.
- ``load_bundle``'s dispatch order and its ``EndpointModelError`` texts,
  against the reference's on the same payloads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from clearml_serving_tpu.engines import jax_engine as ref_engine
from clearml_serving_tpu.engines.base import EndpointModelError as RefModelError
from clearml_serving_tpu_torch.engines import jax_engine
from clearml_serving_tpu_torch.engines.base import EndpointModelError
from clearml_serving_tpu_torch.serving.endpoints import ModelEndpoint
from clearml_serving_tpu_torch.utils import flax_msgpack


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "dense": {"w": rng.standard_normal((6, 5)).astype(np.float32),
                  "b": rng.standard_normal(5).astype(np.float32)},
        "bf16": np.asarray(jnp.asarray(rng.standard_normal((3, 7)), jnp.bfloat16)),
        "q": {"_q8": rng.integers(-128, 127, (4, 8), dtype=np.int8),
              "ids": rng.integers(-2 ** 31, 2 ** 31 - 1, (9,), dtype=np.int32)},
        "scalar": np.asarray(np.float32(2.5)),
        "layers": [
            {"w": rng.standard_normal((2, 2)).astype(np.float32), "n": np.asarray(3, np.int32)},
            [np.arange(300, dtype=np.int64), {"deep": np.zeros((0, 4), np.float32)}],
        ],
        "meta": {"name": "tiny", "dims": [1, -7, 300, -70000, 2 ** 40], "ratio": 0.125,
                 "on": True, "off": False, "none": None},
    }


def _leaves_equal(got, want, path="$"):
    """Port tree (tensors) against a flax tree (numpy), leaf for leaf."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            _leaves_equal(got[k], want[k], "{}.{}".format(path, k))
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _leaves_equal(g, w, "{}[{}]".format(path, i))
    elif isinstance(want, (np.ndarray, np.generic)):
        w = np.asarray(want)
        assert isinstance(got, torch.Tensor), (path, type(got))
        assert tuple(got.shape) == w.shape, (path, got.shape, w.shape)
        if w.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                          w.view(np.uint16), err_msg=path)
        else:
            assert str(got.dtype).replace("torch.", "") == w.dtype.name, (path, got.dtype)
            np.testing.assert_array_equal(got.numpy(), w, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def test_the_port_writes_flax_bytes():
    tree = _tree()
    assert flax_msgpack.dumps(tree) == serialization.msgpack_serialize(tree)


def test_reference_bundle_read_by_the_port(tmp_path):
    tree = _tree(1)
    del tree["meta"]  # save_bundle's np.asarray would turn strings into str arrays
    ref_engine.save_bundle(tmp_path, "mlp", {"in_dim": 6}, tree)
    got = flax_msgpack.read(tmp_path / "params.msgpack")
    _leaves_equal(got, jax.tree.map(np.asarray, tree))
    _leaves_equal(flax_msgpack.loads((tmp_path / "params.msgpack").read_bytes()),
                  jax.tree.map(np.asarray, tree))


def test_port_bundle_read_by_the_reference(tmp_path):
    tree = _tree(2)
    ported = flax_msgpack.loads(flax_msgpack.dumps(tree))
    n = jax_engine.save_bundle(tmp_path, "mlp", {"in_dim": 6}, ported)
    data = (tmp_path / "params.msgpack").read_bytes()
    assert n == len(data)
    back = serialization.msgpack_restore(bytearray(data))
    _leaves_equal(ported, back)
    _leaves_equal(flax_msgpack.loads(data), back)
    # the reference's load_bundle builds and restores it
    bundle, params = ref_engine.load_bundle(
        _mlp_bundle(tmp_path / "mlp", jax_engine.save_bundle))
    assert bundle.config["hidden"] == [8]


def _mlp_bundle(path, save):
    cfg = {"in_dim": 4, "hidden": [8], "out_dim": 3}
    rng = np.random.default_rng(3)
    params = {"layers": [
        {"w": rng.standard_normal((4, 8)).astype(np.float32), "b": np.zeros(8, np.float32)},
        {"w": rng.standard_normal((8, 3)).astype(np.float32), "b": np.zeros(3, np.float32)}]}
    save(path, "mlp", cfg, params)
    return path


@pytest.mark.parametrize("chunk", [16, 64, 512])
def test_chunked_leaves_both_ways(tmp_path, monkeypatch, chunk):
    """Leaves over MAX_CHUNK_SIZE bytes in maps are chunked (flax's format),
    arrays inside lists are not; both sides read each other's chunks."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", chunk)
    rng = np.random.default_rng(4)
    tree = {"embed": rng.standard_normal((33, 7)).astype(np.float32),
            "lm": np.asarray(jnp.asarray(rng.standard_normal((5, 41)), jnp.bfloat16)),
            "small": np.ones(2, np.float32),
            "layers": [{"w": rng.standard_normal((20, 3)).astype(np.float32)}]}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    assert flax_msgpack.dumps(tree) == data
    (tmp_path / "p.msgpack").write_bytes(data)
    _leaves_equal(flax_msgpack.read(tmp_path / "p.msgpack"), jax.tree.map(np.asarray, tree))
    flax_msgpack.write(tmp_path / "q.msgpack", flax_msgpack.loads(data))
    back = serialization.msgpack_restore(bytearray((tmp_path / "q.msgpack").read_bytes()))
    _leaves_equal(flax_msgpack.loads(data), back)


def test_leaves_are_views_of_the_file_on_the_cpu(tmp_path):
    """No second host copy: CPU leaves are views of one mapped file, their
    addresses as far apart as their bytes in it."""
    _mlp_bundle(tmp_path, ref_engine.save_bundle)
    data = (tmp_path / "params.msgpack").read_bytes()
    tree = flax_msgpack.read(tmp_path / "params.msgpack")
    w0, w1 = tree["layers"][0]["w"], tree["layers"][1]["w"]
    at0, at1 = data.find(w0.numpy().tobytes()), data.find(w1.numpy().tobytes())
    assert at0 > 0 and at1 > at0
    assert w1.data_ptr() - w0.data_ptr() == at1 - at0


# -- load_bundle's dispatch -----------------------------------------------------


def _write_onnx(path):
    from clearml_serving_tpu.engines.importers.torchscript_import import (
        export_torch_to_onnx_bytes,
    )

    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(4, 3))
    path.write_bytes(export_torch_to_onnx_bytes(m, [[1, 4]]))
    return m


def _both_load(path, endpoint=None):
    """(reference outcome, port outcome): the bundle's arch or the error."""
    def run(load, err, **kw):
        try:
            bundle, _ = load(path, endpoint=endpoint, **kw)
            return bundle.config.get("arch", "mlp" if "hidden" in bundle.config else "?")
        except err as ex:
            return "error: " + str(ex).replace(str(path), "<path>")

    return (run(ref_engine.load_bundle, RefModelError),
            run(jax_engine.load_bundle, EndpointModelError, device="cpu"))


def test_native_bundle_wins_over_a_stray_onnx(tmp_path):
    _mlp_bundle(tmp_path, jax_engine.save_bundle)
    _write_onnx(tmp_path / "stray.onnx")
    ref, port = _both_load(tmp_path)
    assert ref == port == "mlp"


def test_onnx_then_graphdef_then_torchscript(tmp_path):
    from test_torch_graphdef_import import mlp_graphdef

    onnx_dir, gd_dir, ts_dir = tmp_path / "o", tmp_path / "g", tmp_path / "t"
    for d in (onnx_dir, gd_dir, ts_dir):
        d.mkdir()
    _write_onnx(onnx_dir / "model.onnx")
    (onnx_dir / "model.graphdef").write_bytes(mlp_graphdef(np.random.RandomState(0))[0])
    (gd_dir / "model.pb").write_bytes(mlp_graphdef(np.random.RandomState(0))[0])
    torch.jit.script(torch.nn.Sequential(torch.nn.Linear(4, 3))).save(str(gd_dir / "m.pt"))
    torch.jit.script(torch.nn.Sequential(torch.nn.Linear(4, 3))).save(str(ts_dir / "m.pt"))
    endpoint = ModelEndpoint(engine_type="jax", serving_url="x", input_size=[4],
                             input_type="float32")
    assert _both_load(onnx_dir) == ("onnx", "onnx")
    assert _both_load(gd_dir) == ("graphdef", "graphdef")
    assert _both_load(ts_dir, endpoint) == ("torchscript", "torchscript")
    assert _both_load(ts_dir / "m.pt", endpoint) == ("torchscript", "torchscript")


def test_torchscript_needs_the_endpoint_spec(tmp_path):
    torch.jit.script(torch.nn.Sequential(torch.nn.Linear(4, 3))).save(str(tmp_path / "m.pt"))
    ref, port = _both_load(tmp_path / "m.pt")
    assert ref == port
    assert port.startswith("error: TorchScript model <path> needs the endpoint's input_size")
    endpoint = ModelEndpoint(engine_type="jax", serving_url="x")
    ref, port = _both_load(tmp_path, endpoint)
    assert ref == port and port.startswith("error: TorchScript model <path>/m.pt needs")


def test_single_file_resolves_to_its_directory_and_overrides_merge(tmp_path):
    _mlp_bundle(tmp_path, ref_engine.save_bundle)
    bundle, params = jax_engine.load_bundle(tmp_path / "params.msgpack", device="cpu",
                                            config_overrides={"dtype": "float32", "extra": 1})
    assert bundle.config["extra"] == 1 and bundle.config["hidden"] == [8]
    assert _both_load(tmp_path / "params.msgpack") == ("mlp", "mlp")


def test_missing_model_config_raises_as_the_reference(tmp_path):
    (tmp_path / "params.msgpack").write_bytes(b"\x80")
    ref, port = _both_load(tmp_path)
    assert ref == port == "error: not a jax model bundle (missing model_config.json): <path>"
