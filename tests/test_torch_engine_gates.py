"""The kernels' gates as a CUDA engine checks them at construction
(``clearml_serving_tpu_torch/ops/gates.py``), called directly with shape
facts: every fact outside a gate raises ``ValueError`` in the wrapper's own
words, the facts of the configurations the card serves pass, and a CPU
engine (the plain versions, no gates) builds and serves a configuration
outside them, with the same greedy streams as one inside."""

import asyncio

import jax
import numpy as np
import pytest
import torch

from clearml_serving_tpu import models
from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore
from clearml_serving_tpu_torch.models.llama import PRESETS, Llama, convert_params, init_params
from clearml_serving_tpu_torch.ops.gates import check_engine_gates
from clearml_serving_tpu_torch.ops.quant import int4_groups, quantize_llama_params


# published widths (each model's config.json) of the families the paged
# path serves beside Llama-3, and of one it does not
FAMILY_WIDTHS = {
    "qwen2.5-7b": dict(vocab_size=152064, dim=3584, n_layers=28, n_heads=28, n_kv_heads=4,
                       ffn_dim=18944),
    "gemma-7b": dict(vocab_size=256000, dim=3072, n_layers=28, n_heads=16, n_kv_heads=16,
                     head_dim=256, ffn_dim=24576, tie_embeddings=True),
    "gemma-2b": dict(vocab_size=256000, dim=2048, n_layers=18, n_heads=8, n_kv_heads=1,
                     head_dim=256, ffn_dim=16384, tie_embeddings=True),
    "phi-3-mini": dict(vocab_size=32064, dim=3072, n_layers=32, n_heads=32, n_kv_heads=32,
                       ffn_dim=8192),
}


def _facts(preset, **over):
    """The gate facts of a preset's (or a family's) engine: 16-token bf16
    pages, the ragged scheduler with a tree of spec_k 4, int4 projections in
    128-row groups (no lm_head when tied)."""
    cfg = PRESETS.get(preset) or FAMILY_WIDTHS[preset]
    d = cfg.get("head_dim") or cfg["dim"] // cfg["n_heads"]
    shapes = {"wq": (cfg["dim"], cfg["n_heads"] * d),
              "wk": (cfg["dim"], cfg["n_kv_heads"] * d),
              "wv": (cfg["dim"], cfg["n_kv_heads"] * d),
              "wo": (cfg["n_heads"] * d, cfg["dim"]),
              "w_gate": (cfg["dim"], cfg["ffn_dim"]), "w_up": (cfg["dim"], cfg["ffn_dim"]),
              "w_down": (cfg["ffn_dim"], cfg["dim"])}
    weights = [("layers.{}.{}".format(i, name), k, n, int4_groups(k))
               for i in range(cfg["n_layers"]) for name, (k, n) in shapes.items()]
    if not cfg.get("tie_embeddings"):
        weights.append(("lm_head", cfg["dim"], cfg["vocab_size"], int4_groups(cfg["dim"])))
    facts = dict(page_size=16, n_kv_heads=cfg["n_kv_heads"], head_dim=d,
                 group=cfg["n_heads"] // cfg["n_kv_heads"], dtype=torch.bfloat16,
                 kv_dtype=torch.bfloat16, ragged=True, tree_width=5, int4_weights=weights)
    facts.update(over)
    return facts


# the small model the card tests and chip_smoke.py serve (D = 64 and 128)
CARD_SMALL = dict(page_size=16, n_kv_heads=2, head_dim=64, group=2, dtype=torch.bfloat16,
                  kv_dtype=torch.bfloat16, ragged=True, tree_width=5)


@pytest.mark.parametrize("over", [
    {}, {"kv_dtype": torch.int8, "page_size": 32}, {"kv_dtype": torch.int8},
    {"ragged": False, "tree_width": None}, {"tree_width": 64},
], ids=["bf16_pages", "int8_pages_32", "int8_pages_16", "two_dispatch", "tree_width_64"])
def test_llama3_8b_facts_pass(over):
    check_engine_gates(**_facts("llama3-8b", **over))


@pytest.mark.parametrize("over", [{}, {"head_dim": 128, "group": 8, "page_size": 32}],
                         ids=["d64", "d128_g8_p32"])
def test_card_small_model_facts_pass(over):
    check_engine_gates(**dict(CARD_SMALL, **over))


@pytest.mark.parametrize("over", [
    {}, {"kv_dtype": torch.int8, "page_size": 32}, {"ragged": False, "tree_width": None},
], ids=["bf16_pages", "int8_pages_32", "two_dispatch"])
@pytest.mark.parametrize("family", ["qwen2.5-7b", "gemma-7b", "gemma-2b"])
def test_paged_family_facts_pass(family, over):
    """Qwen2.5-7B (G = 7, its int4 wk/wv N = 512 and w_gate N = 18944 at K =
    3584), Gemma-7B (head_dim 256, G = 1) and Gemma-2B (head_dim 256,
    G = 8) pass every kernel's gates."""
    check_engine_gates(**_facts(family, **over))


@pytest.mark.parametrize("ragged", [False, True], ids=["two_dispatch", "ragged"])
def test_head_dim_96_is_refused_by_name(ragged):
    """Phi-3-mini's head_dim 96 stays outside the attention kernels (the
    reference runs it through XLA, not its Pallas kernel)."""
    facts = _facts("phi-3-mini", ragged=ragged, tree_width=5 if ragged else None)
    with pytest.raises(ValueError, match=r"^paged_attention gate head_dim: .*\(64, 128, 256\)"):
        check_engine_gates(**facts)


def test_llama_tiny_facts_pass_every_gate_but_head_dim():
    """llama-tiny (D = 16) is a CPU preset: its head dim is outside the
    attention kernels' 64/128/256, every other fact passes."""
    facts = _facts("llama-tiny")
    assert facts["head_dim"] == 16
    with pytest.raises(ValueError, match="^paged_attention gate head_dim: "):
        check_engine_gates(**facts)
    check_engine_gates(**dict(facts, head_dim=64))


@pytest.mark.parametrize("over,gate", [
    ({"page_size": 8}, "paged_attention gate page_size"),
    ({"page_size": 64}, "paged_attention gate page_size"),
    ({"head_dim": 96}, "paged_attention gate head_dim"),
    ({"group": 9}, "paged_attention gate group"),
    ({"dtype": torch.float32, "kv_dtype": torch.float32}, "paged_attention gate q.dtype"),
    ({"dtype": torch.float16, "kv_dtype": torch.float16}, "paged_attention gate q.dtype"),
    ({"kv_dtype": torch.float32}, "paged_attention gate pool.dtype"),
    ({"tree_width": 65}, "ragged_paged_attention gate tree_anc"),
    ({"int4_weights": [("layers.0.wk", 4096, 1000, 32)]}, "fused_int4_matmul gate N"),
    ({"int4_weights": [("layers.0.wk", 4096, 1024, 512)]}, "fused_int4_matmul gate group"),
    ({"int4_weights": [("layers.0.wk", 4096, 1024, 3)]}, "fused_int4_matmul gate groups"),
    ({"int4_weights": [("layers.0.wk", 4095, 1024, 1)]}, "fused_int4_matmul gate K"),
], ids=["page_8", "page_64", "head_dim_96", "group_9", "float32_model", "float16_model",
        "float32_pool", "tree_width_65", "int4_n", "int4_group_8", "int4_groups", "int4_odd_k"])
def test_out_of_gate_facts_raise_naming_the_gate(over, gate):
    with pytest.raises(ValueError, match="^" + gate + ": "):
        check_engine_gates(**_facts("llama3-8b", **over))


def test_int4_error_names_the_weight():
    weights = _facts("llama3-8b")["int4_weights"] + [("layers.7.w_down", 14336, 4104, 112)]
    with pytest.raises(ValueError, match=r"gate N: .*\(weight layers\.7\.w_down\)"):
        check_engine_gates(**_facts("llama3-8b", int4_weights=weights))


def test_int4_weight_shapes_of_a_quantized_model_pass():
    cfg = {"vocab_size": 512, "dim": 256, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
           "head_dim": 64, "ffn_dim": 512}
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    model = Llama(cfg, quantize_llama_params(params, bits=4))
    shapes = model.int4_weight_shapes()
    assert len(shapes) == 7 * 2 + 1
    assert ("layers.1.w_down", 512, 256, 4) in shapes and ("lm_head", 256, 512, 2) in shapes
    check_engine_gates(**dict(CARD_SMALL, int4_weights=shapes))


@pytest.fixture(scope="module")
def tiny_np():
    bundle = models.build_model("llama", {"preset": "llama-tiny", "dtype": "float32"})
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))


def test_cpu_engine_outside_the_gates_builds_and_serves(tiny_np):
    """page_size 8, float32, D = 16: outside every CUDA gate named above,
    served by the plain versions, with the greedy streams of 16-token
    pages."""
    def serve(page_size):
        model = Llama({"preset": "llama-tiny", "dtype": "float32"},
                      convert_params(tiny_np, device="cpu"))
        engine = LLMEngineCore(model, max_batch=2, max_seq_len=128, prefill_buckets=[32, 64],
                               eos_token_id=257, decode_steps=4, page_size=page_size)

        async def run():
            async def one(n):
                return [t async for t in engine.generate(GenRequest(
                    prompt_ids=list(range(3, 3 + n)), max_new_tokens=12))]
            return await asyncio.gather(one(5), one(21))

        streams = asyncio.run(run())
        pool = engine.paged_cache.pool
        assert pool.free_pages == pool.num_pages - 1
        return streams

    small = serve(8)
    assert all(len(s) >= 1 for s in small)
    assert small == serve(16)
