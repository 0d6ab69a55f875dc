"""The ``jax`` engine type's models on torch (models/mlp.py, cnn.py,
bert.py) against the JAX package's, on the same weights and inputs.

Each reference tree comes from the JAX ``init`` with every bias and norm
leaf perturbed first (the reference initializes them to constants, so a
dropped leaf would pass otherwise), carried over by the model's
``convert_params``. Tolerances: MLP f32 atol = rtol = 1e-5; CNN (28x28x1,
channels [32, 64]) and ``bert-tiny`` f32 1e-4; ``bert-tiny`` in bf16
against the JAX model in bf16 2e-2. Through the engine (a bundle written by
the JAX package's ``save_bundle``, both packages' ``JaxEngineRequest``):
the MLP at each of the reference's default buckets, and BERT rows padded
to their bucket with an all-zero mask, whose NaN stays in the padded rows.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from clearml_serving_tpu import models as jax_models
from clearml_serving_tpu.engines import jax_engine as ref_engine
from clearml_serving_tpu.serving.endpoints import ModelEndpoint as JaxEndpoint
from clearml_serving_tpu_torch import models
from clearml_serving_tpu_torch.engines import jax_engine
from clearml_serving_tpu_torch.serving.endpoints import ModelEndpoint

CNN = {"in_hw": [28, 28], "in_ch": 1, "channels": [32, 64], "dense": 128, "out_dim": 10}
BERT_TINY = {"preset": "bert-tiny", "dtype": "float32"}


def _perturbed(tree, seed=0):
    """Seeded values on the constant-initialized leaves: biases (``b``,
    ``b*``) and the norms' ``scale``/``bias``."""
    rng = np.random.default_rng(seed)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        a = np.asarray(node)
        if key.startswith("b") or key in ("scale", "bias"):
            return (a.astype(np.float32) + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return walk(jax.tree.map(np.asarray, tree))


def _reference(arch, cfg, seed=0):
    bundle = jax_models.build_model(arch, cfg)
    return bundle, _perturbed(bundle.init(jax.random.PRNGKey(seed)), seed)


def _port(arch, cfg, np_tree):
    bundle = models.build_model(arch, cfg)
    return bundle, bundle.convert_params(np_tree, device="cpu")


def test_registry_refuses_unknown_and_unported_archs():
    """Every arch of the reference's registry builds (whisper since the
    audio routes came); an unknown one is refused."""
    assert {"mlp", "cnn", "bert", "llama", "whisper"} <= set(models.registered_archs())
    with pytest.raises(ValueError, match="unknown model arch 'nope'"):
        models.build_model("nope", {})
    whisper = models.build_model("whisper", {"preset": "whisper-test"})
    assert whisper.config["d_model"] == 32 and whisper.config["dtype"] == "float32"


def test_mlp_equals_the_reference():
    rng = np.random.default_rng(1)
    jb, tree = _reference("mlp", {})
    pb, params = _port("mlp", {}, tree)
    x = rng.standard_normal((7, 4)).astype(np.float64)   # cast to the config's dtype
    want = np.asarray(jb.apply(tree, x))
    got = pb.apply(params, torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(3, 28, 28), (2, 28, 28, 1)])
def test_cnn_equals_the_reference(shape):
    rng = np.random.default_rng(2)
    jb, tree = _reference("cnn", CNN, seed=2)
    pb, params = _port("cnn", CNN, tree)
    x = rng.random(shape).astype(np.float32)
    want = np.asarray(jb.apply(tree, x))
    got = pb.apply(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the kernels were laid out once: OIHW, and dense rows in NCHW order
    assert tuple(params["conv"][0]["k"].shape) == (32, 1, 3, 3)


def _bert_inputs(rng, b=3, s=16, vocab=512):
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 9:] = 0
    return ids, mask


def test_bert_tiny_f32_equals_the_reference():
    rng = np.random.default_rng(3)
    jb, tree = _reference("bert", BERT_TINY, seed=3)
    pb, params = _port("bert", BERT_TINY, tree)
    ids, mask = _bert_inputs(rng)
    want = np.asarray(jb.apply(tree, ids, mask))
    got = pb.apply(params, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    hidden = pb.hidden(params, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(hidden, np.asarray(jb.hidden(tree, ids, mask)), rtol=1e-4,
                               atol=1e-4)
    assert pb.config["num_labels"] == 9 and pb.config["norm_eps"] == 1e-12


def test_bert_tiny_bf16_equals_the_reference_in_bf16():
    rng = np.random.default_rng(4)
    jb, tree = _reference("bert", {"preset": "bert-tiny"}, seed=4)
    pb, params = _port("bert", {"preset": "bert-tiny"}, tree)
    assert params["word_embed"].dtype == torch.bfloat16
    ids, mask = _bert_inputs(rng)
    want = np.asarray(jb.apply(tree, ids, mask))
    got = pb.apply(params, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def _engine(cls, endpoint_cls, path, **endpoint):
    """An engine request over the bundle at ``path`` (a registry of one)."""
    registry = SimpleNamespace(get=lambda _id: SimpleNamespace(get_local_copy=lambda: str(path)))
    ep = endpoint_cls(engine_type="jax", serving_url="m", model_id="m", **endpoint)
    kw = {"device": "cpu"} if cls is jax_engine.JaxEngineRequest else {}
    return cls(ep, registry=registry, **kw)


def test_mlp_engine_at_every_default_bucket(tmp_path):
    _jb, tree = _reference("mlp", {}, seed=5)
    ref_engine.save_bundle(tmp_path, "mlp", {}, tree)
    ref = _engine(ref_engine.JaxEngineRequest, JaxEndpoint, tmp_path, input_type="float32")
    port = _engine(jax_engine.JaxEngineRequest, ModelEndpoint, tmp_path, input_type="float32")
    assert port._buckets == [1, 2, 4, 8, 16, 32, 64, 128]
    rng = np.random.default_rng(5)
    for bucket in port._buckets:
        for batch in sorted({bucket, max(1, bucket - 1)}):
            x = rng.standard_normal((batch, 4)).astype(np.float32)
            got = port.process(x.tolist(), {})
            want = ref.process(x.tolist(), {})
            assert got.shape == want.shape == (batch, 3)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            assert port.postprocess(got, {}) == got.tolist()
    health = port.engine.health()
    assert health["eager_runs"] == 15 and health["graph_captures"] == 0


def test_bert_padded_rows_keep_their_nan_and_the_real_rows_are_unchanged(tmp_path):
    _jb, tree = _reference("bert", BERT_TINY, seed=6)
    ref_engine.save_bundle(tmp_path, "bert", BERT_TINY, tree)
    port = _engine(jax_engine.JaxEngineRequest, ModelEndpoint, tmp_path,
                   input_name=["input_ids", "attention_mask"], input_type=["int32", "int32"])
    ref = _engine(ref_engine.JaxEngineRequest, JaxEndpoint, tmp_path,
                  input_name=["input_ids", "attention_mask"], input_type=["int32", "int32"])
    rng = np.random.default_rng(6)
    ids, mask = _bert_inputs(rng)              # 3 rows -> bucket 4, one row padded
    body = {"input_ids": ids.tolist(), "attention_mask": mask.tolist()}
    got = port.process(body, {})
    assert got.shape == (3, 16, 9) and not np.isnan(got).any()
    np.testing.assert_allclose(got, ref.process(body, {}), rtol=1e-4, atol=1e-4)
    # the whole bucket: the padded row (all-zero mask) is NaN, alone
    padded = [np.pad(ids, [(0, 1), (0, 0)]), np.pad(mask, [(0, 1), (0, 0)])]
    full = port.engine.run(padded)
    assert np.isnan(full[3]).all() and not np.isnan(full[:3]).any()
    # the real rows are the rows computed alone
    pb, params = _port("bert", BERT_TINY, tree)
    alone = pb.apply(params, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(full[:3], alone, rtol=1e-6, atol=1e-6)
