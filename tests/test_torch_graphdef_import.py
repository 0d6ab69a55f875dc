"""The GraphDef importer on torch (engines/importers/graphdef_import.py)
against the JAX package's, on the same frozen graphs: every scenario of
the reference's tests/test_graphdef_import.py. No TensorFlow here: graphs
are written by the port's minimal protobuf writer (graphdef_write.py), the
bytes TF would serialize, and both importers read the same file. Outputs
hold against the JAX importer's and against numpy at 1e-4."""

import asyncio

import jax
import numpy as np
import pytest
import torch

from clearml_serving_tpu.engines.importers.graphdef_import import (
    load_graphdef_bundle as ref_load,
)
from clearml_serving_tpu_torch.engines.importers.graphdef_import import (
    load_graphdef_bundle,
    parse_graphdef,
)
from clearml_serving_tpu_torch.engines.importers.graphdef_write import (
    attr,
    attr_f,
    attr_i,
    attr_ilist,
    attr_s,
    attr_shape,
    attr_tensor,
    attr_type,
    cnn_graphdef,
    const,
    graphdef,
    len_field,
    node,
    varint_field,
)

TOL = 1e-4


def mlp_graphdef(rng):
    w1 = rng.randn(4, 32).astype(np.float32)
    b1 = rng.randn(32).astype(np.float32)
    w2 = rng.randn(32, 3).astype(np.float32)
    b2 = rng.randn(3).astype(np.float32)
    gd = graphdef(
        node("x", "Placeholder", (), attr_type("dtype", 1), attr_shape("shape", [-1, 4])),
        const("w1", w1), const("b1", b1), const("w2", w2), const("b2", b2),
        node("mm1", "MatMul", ("x", "w1")),
        node("h1", "BiasAdd", ("mm1", "b1")),
        node("relu", "Relu", ("h1",)),
        node("mm2", "MatMul", ("relu", "w2")),
        node("logits", "BiasAdd", ("mm2", "b2")),
        node("probs", "Softmax", ("logits",)),
    )
    return gd, (w1, b1, w2, b2)


def _mlp_ref(x, w1, b1, w2, b2):
    h = np.maximum(x @ w1 + b1, 0)
    logits = h @ w2 + b2
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _run_both(path, *xs):
    """(port output, reference output) on the same file and inputs."""
    bundle, params = load_graphdef_bundle(path, device="cpu")
    got = bundle.apply(params, *[torch.from_numpy(x) for x in xs])
    rb, rp = ref_load(path)
    want = np.asarray(jax.jit(rb.apply)(rp, *xs))
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    return got, bundle, params


def test_mlp_graph_matches_numpy_and_the_reference(tmp_path):
    rng = np.random.RandomState(0)
    gd, weights = mlp_graphdef(rng)
    f = tmp_path / "model.graphdef"
    f.write_bytes(gd)
    x = rng.randn(5, 4).astype(np.float32)
    got, bundle, params = _run_both(f, x)
    assert bundle.input_names == ["x"]
    assert bundle.output_names == ["probs"]
    assert bundle.config["input_shapes"]["x"] == [-1, 4]
    np.testing.assert_allclose(got, _mlp_ref(x, *weights), rtol=TOL, atol=TOL)
    # the big weights became device params; small consts stayed host-side
    assert set(params) == {"w1", "w2"}


def test_cnn_graph_matches_the_reference(tmp_path):
    """Conv2D(SAME) -> BiasAdd -> Relu -> MaxPool -> Mean -> MatMul."""
    rng = np.random.RandomState(1)
    w = rng.randn(3, 3, 2, 4).astype(np.float32)   # HWIO
    b = rng.randn(4).astype(np.float32)
    wd = rng.randn(4, 3).astype(np.float32)
    gd = graphdef(
        node("img", "Placeholder", (), attr_type("dtype", 1),
             attr_shape("shape", [-1, 8, 8, 2])),
        const("w", w), const("b", b), const("wd", wd),
        const("axes", np.asarray([1, 2], np.int32)),
        node("conv", "Conv2D", ("img", "w"), attr_s("padding", "SAME"),
             attr_ilist("strides", [1, 1, 1, 1]), attr_s("data_format", "NHWC")),
        node("biased", "BiasAdd", ("conv", "b")),
        node("act", "Relu", ("biased",)),
        node("pool", "MaxPool", ("act",), attr_s("padding", "VALID"),
             attr_ilist("ksize", [1, 2, 2, 1]), attr_ilist("strides", [1, 2, 2, 1])),
        node("gap", "Mean", ("pool", "axes"), attr_i("keep_dims", 0)),
        node("out", "MatMul", ("gap", "wd")),
    )
    f = tmp_path / "model.pb"
    f.write_bytes(gd)
    x = rng.randn(2, 8, 8, 2).astype(np.float32)
    got, _b, _p = _run_both(f, x)
    xp = np.pad(x, [(0, 0), (1, 1), (1, 1), (0, 0)])
    ref_conv = np.zeros((2, 8, 8, 4), np.float32)
    for i in range(8):
        for j in range(8):
            ref_conv[:, i, j, :] = np.einsum("bhwc,hwco->bo", xp[:, i:i + 3, j:j + 3, :], w)
    act = np.maximum(ref_conv + b, 0)
    pool = act.reshape(2, 4, 2, 4, 2, 4).max(axis=(2, 4))
    np.testing.assert_allclose(got, pool.mean(axis=(1, 2)) @ wd, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("padding,stride", [("SAME", 2), ("VALID", 1), ("SAME", 1)])
def test_strided_and_padded_convs_and_pools_equal_the_reference(tmp_path, padding, stride):
    """TF's SAME padding puts the odd pixel high: odd sizes and strides."""
    rng = np.random.RandomState(7)
    gd = graphdef(
        node("img", "Placeholder", (), attr_type("dtype", 1),
             attr_shape("shape", [-1, 13, 11, 3])),
        const("w", rng.randn(3, 2, 3, 5).astype(np.float32)),
        const("dw", rng.randn(3, 3, 5, 2).astype(np.float32)),
        node("conv", "Conv2D", ("img", "w"), attr_s("padding", padding),
             attr_ilist("strides", [1, stride, stride, 1])),
        node("dconv", "DepthwiseConv2dNative", ("conv", "dw"), attr_s("padding", padding),
             attr_ilist("strides", [1, 1, 1, 1])),
        node("mx", "MaxPool", ("dconv",), attr_s("padding", padding),
             attr_ilist("ksize", [1, 3, 3, 1]), attr_ilist("strides", [1, 2, 2, 1])),
        node("av", "AvgPool", ("mx",), attr_s("padding", padding),
             attr_ilist("ksize", [1, 2, 2, 1]), attr_ilist("strides", [1, 1, 1, 1])),
    )
    f = tmp_path / "model.graphdef"
    f.write_bytes(gd)
    _run_both(f, rng.randn(2, 13, 11, 3).astype(np.float32))


def test_savedmodel_wrapper_and_multi_output(tmp_path):
    """TF1 SavedModel wrapper parses, FusedBatchNorm's :0 output resolves."""
    rng = np.random.RandomState(2)
    scale = rng.rand(4).astype(np.float32) + 0.5
    offset = rng.randn(4).astype(np.float32)
    mean = rng.randn(4).astype(np.float32)
    var = rng.rand(4).astype(np.float32) + 0.5
    gd = graphdef(
        node("x", "Placeholder", (), attr_type("dtype", 1),
             attr_shape("shape", [-1, 2, 2, 4])),
        const("scale", scale), const("offset", offset), const("mean", mean),
        const("var", var),
        node("bn", "FusedBatchNormV3", ("x", "scale", "offset", "mean", "var"),
             attr_f("epsilon", 1e-3)),
        node("y", "Relu", ("bn:0",)),
    )
    saved = len_field(2, len_field(2, gd))
    f = tmp_path / "saved_model.pb"
    f.write_bytes(saved)
    assert [n["name"] for n in parse_graphdef(f.read_bytes())][0] == "x"
    x = rng.randn(3, 2, 2, 4).astype(np.float32)
    got, _b, _p = _run_both(f, x)
    ref = np.maximum((x - mean) / np.sqrt(var + 1e-3) * scale + offset, 0)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_unsupported_op_reports_the_reference_recipe(tmp_path):
    gd = graphdef(
        node("x", "Placeholder", (), attr_type("dtype", 1)),
        node("w", "WeirdCustomOp", ("x",)),
    )
    f = tmp_path / "model.graphdef"
    f.write_bytes(gd)
    bundle, params = load_graphdef_bundle(f, device="cpu")
    with pytest.raises(ValueError) as port:
        bundle.apply(params, torch.zeros((1, 2)))
    rb, rp = ref_load(f)
    with pytest.raises(ValueError) as ref:
        rb.apply(rp, np.zeros((1, 2), np.float32))
    assert str(port.value) == str(ref.value) and "tf2onnx" in str(port.value)


def test_served_through_the_jax_engine(tmp_path):
    """A .graphdef model registers and serves like any other import format."""
    from clearml_serving_tpu_torch.serving.endpoints import ModelEndpoint
    from clearml_serving_tpu_torch.serving.model_request_processor import (
        ModelRequestProcessor,
    )

    rng = np.random.RandomState(3)
    gd, weights = mlp_graphdef(rng)
    f = tmp_path / "model.graphdef"
    f.write_bytes(gd)
    mrp = ModelRequestProcessor(state_root=str(tmp_path / "state"), force_create=True,
                                name="gd", device="cpu")
    rec = mrp.registry.register("tf mlp", path=f, framework="tensorflow")
    mrp.add_endpoint(ModelEndpoint(
        engine_type="jax", serving_url="tf_mlp", model_id=rec.id,
        input_size=[[4]], input_type=["float32"], input_name=["x"],
        output_size=[[3]], output_type=["float32"], output_name=["probs"]))
    mrp.serialize()
    mrp.deserialize(skip_sync=True)
    x = rng.randn(2, 4).astype(np.float32)
    out = asyncio.run(mrp.process_request("tf_mlp", None, {"x": x.tolist()}))
    np.testing.assert_allclose(np.asarray(out), _mlp_ref(x, *weights), rtol=TOL, atol=TOL)


def test_real_savedmodel_leads_with_schema_version(tmp_path):
    rng = np.random.RandomState(4)
    gd, weights = mlp_graphdef(rng)
    f = tmp_path / "saved_model.pb"
    f.write_bytes(varint_field(1, 1) + len_field(2, len_field(2, gd)))
    x = rng.randn(2, 4).astype(np.float32)
    got, _b, _p = _run_both(f, x)
    np.testing.assert_allclose(got, _mlp_ref(x, *weights), rtol=TOL, atol=TOL)


def test_dead_nodes_do_not_break_import(tmp_path):
    """Saver/init leftovers outside the output's ancestry neither fail the
    load nor become outputs."""
    rng = np.random.RandomState(5)
    gd, weights = mlp_graphdef(rng)
    extras = graphdef(
        node("save/Const", "Const", (), attr_tensor("value", np.asarray([7], np.int32))),
        node("save/SaveV2", "SaveV2", ("save/Const",)),
        node("labels", "Const", (),
             attr("value", len_field(8, varint_field(1, 7) + len_field(8, b"cat")))),
    )
    f = tmp_path / "model.graphdef"
    f.write_bytes(gd + extras)
    x = rng.randn(2, 4).astype(np.float32)
    got, bundle, _p = _run_both(f, x)
    assert bundle.output_names == ["probs"]
    np.testing.assert_allclose(got, _mlp_ref(x, *weights), rtol=TOL, atol=TOL)


def test_input_arity_validated_with_the_reference_words(tmp_path):
    gd, _ = mlp_graphdef(np.random.RandomState(6))
    f = tmp_path / "model.graphdef"
    f.write_bytes(gd)
    bundle, params = load_graphdef_bundle(f, device="cpu")
    with pytest.raises(ValueError, match="expects 1 inputs") as port:
        bundle.apply(params)
    rb, rp = ref_load(f)
    with pytest.raises(ValueError) as ref:
        rb.apply(rp)
    assert str(port.value) == str(ref.value)


def test_cnn_bundle_written_as_a_graphdef_equals_the_cnn_model(tmp_path):
    """graphdef_write.cnn_graphdef: the cnn bundle's network as TF holds it,
    against the port's cnn model and the JAX importer."""
    from clearml_serving_tpu_torch import models

    bundle = models.build_model("cnn", {})
    tree = bundle.init(torch.Generator().manual_seed(0))
    np_tree = {"conv": [{k: v.numpy() for k, v in layer.items()} for layer in tree["conv"]],
               "dense": [{k: v.numpy() for k, v in layer.items()} for layer in tree["dense"]]}
    f = tmp_path / "cnn.graphdef"
    f.write_bytes(cnn_graphdef(np_tree))
    x = np.random.RandomState(8).rand(3, 28, 28).astype(np.float32)
    got, _b, _p = _run_both(f, x)
    want = bundle.apply(bundle.convert_params(np_tree, "cpu"), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
