"""The ONNX and TorchScript importers on torch
(engines/importers/onnx_import.py, torchscript_import.py) against the JAX
package's, on the same files: every scenario of the reference's
tests/test_onnx_import.py. Graphs are written in process with torch's
classic exporter, as the reference's tests write them; the port's output
holds against the JAX importer's (and torch's own module) at 1e-4. A
TorchScript file served by the port (the scripted module itself) holds
against the reference's ONNX route on the same ``.pt`` at 1e-4."""

import asyncio

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

from clearml_serving_tpu.engines.importers.onnx_import import load_onnx_bundle as ref_load
from clearml_serving_tpu.engines.importers.torchscript_import import (
    export_torch_to_onnx_bytes,
    load_torchscript_bundle as ref_load_ts,
)
from clearml_serving_tpu.serving.endpoints import ModelEndpoint as JaxEndpoint
from clearml_serving_tpu.serving.model_request_processor import (
    ModelRequestProcessor as JaxProcessor,
)
from clearml_serving_tpu_torch.engines.importers.onnx_import import load_onnx_bundle
from clearml_serving_tpu_torch.engines.importers.onnx_proto import tensor_to_numpy
from clearml_serving_tpu_torch.engines.importers.torchscript_import import (
    load_torchscript_bundle,
)
from clearml_serving_tpu_torch.serving.endpoints import ModelEndpoint
from clearml_serving_tpu_torch.serving.model_request_processor import ModelRequestProcessor

TOL = 1e-4


def _export(module, shapes, path, dtypes=None):
    module.eval()
    path.write_bytes(export_torch_to_onnx_bytes(module, shapes, dtypes))
    return path


def _check(module, args, tmp_path, dtypes=None, tol=TOL):
    """The port's and the JAX importer's outputs on one exported file, and
    torch's own module, within ``tol``."""
    f = _export(module, [list(a.shape) for a in args], tmp_path / "m.onnx", dtypes)
    bundle, params = load_onnx_bundle(f, device="cpu")
    got = bundle.apply(params, *args).numpy()
    rb, rp = ref_load(f)
    want = np.asarray(jax.jit(rb.apply)(rp, *[a.numpy() for a in args]))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    with torch.no_grad():
        np.testing.assert_allclose(got, module(*args).numpy(), rtol=tol, atol=tol)
    return bundle, params


def test_mlp_onnx_equals_the_reference(tmp_path):
    torch.manual_seed(0)
    m = nn.Sequential(nn.Linear(8, 32), nn.ReLU(), nn.Linear(32, 16), nn.Tanh(), nn.Linear(16, 3))
    _check(m, (torch.randn(5, 8),), tmp_path)


class _CNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = nn.Conv2d(1, 8, 3, padding=1)
        self.c2 = nn.Conv2d(8, 16, 3, stride=2)
        self.fc = nn.Linear(16 * 6 * 6, 10)

    def forward(self, x):
        x = torch.relu(self.c1(x))
        x = torch.max_pool2d(torch.relu(self.c2(x)), 2, ceil_mode=False)
        x = torch.flatten(x, 1)
        return torch.log_softmax(self.fc(x), dim=-1)


def test_cnn_onnx_equals_the_reference(tmp_path):
    torch.manual_seed(1)
    _check(_CNN(), (torch.randn(2, 1, 28, 28),), tmp_path)


def test_cnn_onnx_dynamic_batch(tmp_path):
    """The exported graph serves batch sizes other than the example's."""
    torch.manual_seed(2)
    m = nn.Sequential(nn.Conv2d(1, 4, 3), nn.ReLU(), nn.Flatten(), nn.Linear(4 * 26 * 26, 5))
    f = _export(m, [[1, 1, 28, 28]], tmp_path / "m.onnx")
    bundle, params = load_onnx_bundle(f, device="cpu")
    rb, rp = ref_load(f)
    for batch in (1, 3, 7):
        x = torch.randn(batch, 1, 28, 28)
        got = bundle.apply(params, x).numpy()
        np.testing.assert_allclose(got, np.asarray(jax.jit(rb.apply)(rp, x.numpy())),
                                   rtol=TOL, atol=TOL)


def test_hf_bert_onnx_equals_the_reference(tmp_path):
    """A real transformers BERT encoder (random weights): LayerNorm
    decomposition, Erf-GELU, Softmax, attention-mask Where chains, Gather
    embeddings, Slice/Concat shape metaprograms."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BertConfig(
        vocab_size=128, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64, max_position_embeddings=64,
    )
    torch.manual_seed(3)

    class Wrapped(nn.Module):
        def __init__(self):
            super().__init__()
            self.bert = transformers.BertModel(cfg)

        def forward(self, input_ids, attention_mask):
            return self.bert(input_ids=input_ids, attention_mask=attention_mask
                             ).last_hidden_state

    ids = torch.randint(0, 128, (2, 12))
    mask = torch.ones(2, 12, dtype=torch.int64)
    mask[1, 7:] = 0
    _check(Wrapped(), (ids, mask), tmp_path, dtypes=["int64", "int64"])


def test_torchscript_served_as_the_module_equals_the_reference_onnx_route(tmp_path):
    torch.manual_seed(4)
    m = nn.Sequential(nn.Linear(6, 12), nn.ReLU(), nn.Linear(12, 4))
    m.eval()
    pt = tmp_path / "model.pt"
    torch.jit.script(m).save(str(pt))
    bundle, params = load_torchscript_bundle(pt, [[1, 6]], device="cpu")
    assert bundle.config["arch"] == "torchscript" and params == {}
    x = torch.randn(3, 6)
    rb, rp = ref_load_ts(pt, [[1, 6]])
    want = np.asarray(jax.jit(rb.apply)(rp, x.numpy()))
    np.testing.assert_allclose(bundle.apply(params, x).numpy(), want, rtol=TOL, atol=TOL)


def _processors(tmp_path, path, framework, preprocess_code=None, **spec):
    """(reference, port) processors serving ``path`` as the jax endpoint."""
    out = []
    for name, cls, ep_cls, kw in (("ref", JaxProcessor, JaxEndpoint, {}),
                                  ("port", ModelRequestProcessor, ModelEndpoint,
                                   {"device": "cpu"})):
        mrp = cls(state_root=str(tmp_path / name), force_create=True, name="imp", **kw)
        rec = mrp.registry.register("model", path=path, framework=framework)
        mrp.add_endpoint(ep_cls(engine_type="jax", model_id=rec.id, **spec),
                         preprocess_code=preprocess_code)
        mrp.serialize()
        mrp.deserialize(skip_sync=True)
        out.append(mrp)
    return out


def test_onnx_served_through_the_router_equals_the_reference(tmp_path):
    torch.manual_seed(5)
    m = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
    f = _export(m, [[1, 4]], tmp_path / "model.onnx")
    ref, port = _processors(tmp_path, f, "onnx", serving_url="onnx_ep", input_name="x",
                            input_type="float32", input_size=[4])
    x = np.random.rand(2, 4).astype(np.float32)
    want = asyncio.run(ref.process_request("onnx_ep", None, {"x": x.tolist()}))
    got = asyncio.run(port.process_request("onnx_ep", None, {"x": x.tolist()}))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL)
    with torch.no_grad():
        np.testing.assert_allclose(np.asarray(got), m(torch.from_numpy(x)).numpy(),
                                   rtol=TOL, atol=TOL)


def test_unsupported_op_fails_loudly_with_the_reference_words(tmp_path):
    class Weird(nn.Module):
        def forward(self, x):
            return torch.det(x)  # Det: not in the supported set

    f = _export(Weird(), [[1, 3, 3]], tmp_path / "weird.onnx")
    with pytest.raises(ValueError, match="unsupported op") as port:
        load_onnx_bundle(f, device="cpu")
    with pytest.raises(ValueError) as ref:
        ref_load(f)
    assert str(port.value) == str(ref.value)


def test_input_arity_checked_with_the_reference_words(tmp_path):
    torch.manual_seed(6)
    f = _export(nn.Sequential(nn.Linear(4, 2)), [[1, 4]], tmp_path / "m.onnx")
    bundle, params = load_onnx_bundle(f, device="cpu")
    rb, rp = ref_load(f)
    with pytest.raises(ValueError) as port:
        bundle.apply(params)
    with pytest.raises(ValueError) as ref:
        rb.apply(rp)
    assert str(port.value) == str(ref.value)


def test_pytorch_example_end_to_end_equals_the_reference(tmp_path):
    """examples/pytorch: train's Net -> TorchScript -> register -> serve with
    the example's Preprocess on both processors."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("pt_train", "examples/pytorch/train_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    torch.manual_seed(0)
    model = mod.Net()
    model.eval()
    pt = tmp_path / "pytorch-mnist.pt"
    torch.jit.script(model).save(str(pt))
    ref, port = _processors(tmp_path, pt, "pytorch", serving_url="test_model_pytorch",
                            input_name="input_0", input_type="float32",
                            input_size=[1, 28, 28],
                            preprocess_code="examples/pytorch/preprocess.py")
    image = np.zeros((28, 28), np.float32)
    image[3:11, 8:20] = 1.0
    body = {"image": image.tolist()}
    got = asyncio.run(port.process_request("test_model_pytorch", None, body))
    want = asyncio.run(ref.process_request("test_model_pytorch", None, body))
    assert got == want and set(got) == {"digit"}
    with torch.no_grad():
        assert got["digit"] == int(model(torch.from_numpy(image)[None, None]).argmax(-1)[0])


def test_maxpool_ceil_mode_equals_the_reference(tmp_path):
    torch.manual_seed(6)

    class M(nn.Module):
        def forward(self, x):
            return torch.max_pool2d(x, 2, ceil_mode=True)

    _check(M(), (torch.randn(1, 3, 27, 27),), tmp_path)


def test_fp16_int32_data_bit_reinterpretation():
    """FLOAT16 typed storage holds uint16 bit patterns in int32_data; a
    numeric cast would turn fp16 1.0 (0x3C00=15360) into 15360.0."""
    arr = tensor_to_numpy({"dims": [2], "data_type": 10, "int32_data": [15360, 16384]})
    assert arr.dtype == np.float16
    np.testing.assert_array_equal(arr.astype(np.float32), [1.0, 2.0])


@pytest.mark.parametrize("case", ["avg_pool_pads", "slice_steps", "pad_reflect", "reduce_prod"])
def test_more_ops_equal_the_reference(tmp_path, case):
    """Ops the reference's scenarios do not reach: average pooling with pads
    outside the count, negative-step slices, reflect/edge padding,
    multi-axis products, gathers with negative indices."""
    import torch.nn.functional as F

    class M(nn.Module):
        def forward(self, x):
            if case == "avg_pool_pads":
                return F.avg_pool2d(x, 3, 2, padding=1, ceil_mode=True, count_include_pad=False)
            if case == "slice_steps":
                return x.flip(2)[:, :, ::2, 1:-1].flip(-1) + x[:, :, -1:, 1:-1].sum(2, keepdim=True)
            if case == "pad_reflect":
                return F.pad(x, (2, 1, 1, 2), mode="reflect") + 1
            return x.prod(3).prod(2) + x[:, :, [-1, 0]].mean()

    torch.manual_seed(7)
    _check(M(), (torch.rand(2, 3, 9, 8) + 0.5,), tmp_path)
