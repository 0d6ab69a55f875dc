"""BERT encoder for token classification.

Counterpart of ``clearml_serving_tpu/models/bert.py``, function for function
(``PRESETS``, ``init``, ``hidden``, ``apply``) and leaf for leaf, so a
reference tree carries over unchanged. What a port must keep:

- ``_layer_norm`` computes in f32 with the population variance (eps 1e-12
  in both presets) and casts back;
- ``jax.nn.gelu`` is the tanh approximation by default, so the FFN uses
  ``approximate="tanh"``;
- the attention scores are f32 products of the model-dtype q and k
  (``preferred_element_type=f32``), softmaxed in f32 and cast back;
- the mask bias is ``-inf`` on masked keys: a row padded to its bucket has
  an all-zero mask, so its softmax is NaN, which stays in that row (the
  engine slices it off) and never reaches another row;
- token ids are clamped into the vocabulary, as JAX's gathers clamp;
- the default dtype is bfloat16, with 9 labels.

``hidden`` is the encoder surface the embedding routes build on.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from . import register_model
from .params import torch_dtype, tree_to

PRESETS: Dict[str, Dict[str, Any]] = {
    "bert-base": dict(
        vocab_size=30522, dim=768, n_layers=12, n_heads=12, ffn_dim=3072,
        max_seq_len=512, type_vocab_size=2, norm_eps=1e-12,
    ),
    "bert-tiny": dict(
        vocab_size=512, dim=64, n_layers=2, n_heads=2, ffn_dim=128,
        max_seq_len=128, type_vocab_size=2, norm_eps=1e-12,
    ),
}


def _layer_norm(x, scale, bias, eps):
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def convert_params(np_tree, device="cuda"):
    """The reference's tree on ``device`` (same leaves and layout)."""
    return tree_to(np_tree, device)


@register_model("bert")
def build(config: dict) -> SimpleNamespace:
    cfg = dict(PRESETS.get(config.get("preset", ""), {}))
    cfg.update({k: v for k, v in config.items() if k != "preset"})
    cfg.setdefault("dtype", "bfloat16")
    cfg.setdefault("num_labels", 9)  # CoNLL-2003 NER default

    vocab = int(cfg["vocab_size"])
    dim = int(cfg["dim"])
    n_layers = int(cfg["n_layers"])
    n_heads = int(cfg["n_heads"])
    ffn_dim = int(cfg["ffn_dim"])
    max_len = int(cfg["max_seq_len"])
    eps = float(cfg["norm_eps"])
    num_labels = int(cfg["num_labels"])
    dtype = torch_dtype(cfg["dtype"])
    head_dim = dim // n_heads

    def init(generator: torch.Generator) -> Dict[str, Any]:
        dev = generator.device

        def dense(shape, fan_in):
            w = torch.randn(shape, generator=generator, device=dev) * fan_in ** -0.5
            return w.to(dtype)

        def ones(n):
            return torch.ones(n, dtype=dtype, device=dev)

        def zeros(n):
            return torch.zeros(n, dtype=dtype, device=dev)

        params: Dict[str, Any] = {
            "word_embed": dense((vocab, dim), dim),
            "pos_embed": dense((max_len, dim), dim),
            "type_embed": dense((int(cfg["type_vocab_size"]), dim), dim),
            "embed_norm": {"scale": ones(dim), "bias": zeros(dim)},
            "layers": [],
            "classifier": {"w": dense((dim, num_labels), dim), "b": zeros(num_labels)},
        }
        for _ in range(n_layers):
            params["layers"].append({
                "wqkv": dense((dim, 3 * dim), dim), "bqkv": zeros(3 * dim),
                "wo": dense((dim, dim), dim), "bo": zeros(dim),
                "attn_norm": {"scale": ones(dim), "bias": zeros(dim)},
                "w1": dense((dim, ffn_dim), dim), "b1": zeros(ffn_dim),
                "w2": dense((ffn_dim, dim), ffn_dim), "b2": zeros(dim),
                "ffn_norm": {"scale": ones(dim), "bias": zeros(dim)},
            })
        return params

    def hidden(params, input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """input_ids [B, S]; attention_mask [B, S] (1 = keep) -> the final
        layer's hidden states [B, S, dim] (pre-classifier)."""
        b, s = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((b, s), dtype=torch.int32, device=input_ids.device)
        ids = input_ids.long()
        ids = torch.where(ids < 0, ids + vocab, ids).clamp(0, vocab - 1)
        x = (params["word_embed"][ids] + params["pos_embed"][:s][None]
             + params["type_embed"][0])
        x = _layer_norm(x, params["embed_norm"]["scale"], params["embed_norm"]["bias"], eps)
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, float("-inf"))
        for layer in params["layers"]:
            qkv = x @ layer["wqkv"] + layer["bqkv"]
            q, k, v = qkv.split(dim, dim=-1)
            q = q.reshape(b, s, n_heads, head_dim)
            k = k.reshape(b, s, n_heads, head_dim)
            v = v.reshape(b, s, n_heads, head_dim)
            scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * (head_dim ** -0.5)
            probs = torch.softmax(scores + bias, dim=-1).to(v.dtype)
            attn = torch.einsum("bhst,bthd->bshd", probs, v).reshape(b, s, dim)
            x = _layer_norm(x + attn @ layer["wo"] + layer["bo"],
                            layer["attn_norm"]["scale"], layer["attn_norm"]["bias"], eps)
            h = F.gelu(x @ layer["w1"] + layer["b1"], approximate="tanh")
            x = _layer_norm(x + h @ layer["w2"] + layer["b2"],
                            layer["ffn_norm"]["scale"], layer["ffn_norm"]["bias"], eps)
        return x

    def apply(params, input_ids: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-token label logits [B, S, num_labels] (token classification)."""
        x = hidden(params, input_ids, attention_mask)
        logits = x @ params["classifier"]["w"] + params["classifier"]["b"]
        return logits.float()

    return SimpleNamespace(init=init, apply=apply, hidden=hidden, config=cfg,
                           convert_params=convert_params)
