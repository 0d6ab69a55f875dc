"""Llama-3-family decoder in PyTorch: the prefill and paged-decode paths.

Counterpart of ``clearml_serving_tpu/models/llama.py``. The math follows the
reference function by function (``_rms_norm``, ``_rope``, ``_qkv``,
``_attend``, ``_ffn_dense``, ``_logits``, ``_block``, ``_kv_store``,
``prefill``, ``decode_paged``), and so does the parameter layout: weights
are ``[in, out]`` so ``x @ w`` reads the same on both sides, and
``convert_params`` carries a JAX parameter tree (as numpy arrays) over
unchanged.

This slice serves dense SiLU-GLU Llama models with GQA, an untied
``lm_head`` and no biases. LoRA, MoE, soft-capping, Gemma-family deltas and
RoPE scaling raise here; they arrive with later slices of the port.

``decode_paged`` writes the new token's K/V into the pools in place
(``index_put_``), where the JAX function returns rebound pool arrays.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.paged_attention import paged_attention

# Named configs: full Llama-3-8B plus scaled-down variants for tests/benches
# (copied from the reference's PRESETS).
PRESETS: Dict[str, Dict[str, Any]] = {
    "llama3-8b": dict(
        vocab_size=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        ffn_dim=14336, rope_theta=500000.0, norm_eps=1e-5, max_seq_len=8192,
    ),
    "llama3-1b": dict(  # llama-3.2-1B-shaped
        vocab_size=128256, dim=2048, n_layers=16, n_heads=32, n_kv_heads=8,
        ffn_dim=8192, rope_theta=500000.0, norm_eps=1e-5, max_seq_len=8192,
    ),
    "llama-tiny": dict(  # CI-sized
        vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=128, rope_theta=10000.0, norm_eps=1e-5, max_seq_len=256,
    ),
}

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "ffn_norm",
              "w_gate", "w_up", "w_down")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

# config knobs of the reference that this slice does not serve yet, with the
# value that means "off"
_UNSUPPORTED = {
    "lora_rank": 0, "n_experts": 0, "attn_logit_softcap": 0.0,
    "final_logit_softcap": 0.0, "attn_bias": False, "sliding_window": 0,
    "alt_window": False, "post_block_norms": False, "norm_offset": False,
    "embed_scale": 0.0, "tie_embeddings": False,
}


def resolve_config(config: dict) -> dict:
    cfg = dict(PRESETS.get(config.get("preset", ""), {}))
    cfg.update({k: v for k, v in config.items() if k != "preset"})
    cfg.setdefault("dtype", "bfloat16")
    cfg.setdefault("tie_embeddings", False)
    cfg.setdefault("rope_theta", 10000.0)
    cfg.setdefault("norm_eps", 1e-5)
    cfg.setdefault("max_seq_len", 4096)
    return cfg


def check_config(cfg: dict) -> None:
    """Raise for every knob this slice of the port does not serve."""
    for key, off in _UNSUPPORTED.items():
        if cfg.get(key) and cfg.get(key) != off:
            raise NotImplementedError(
                "llama config {}={!r} is not ported yet (dense llama only in "
                "this slice)".format(key, cfg[key])
            )
    act = str(cfg.get("hidden_act", "silu"))
    if act != "silu":
        raise NotImplementedError("hidden_act {!r} is not ported yet".format(act))
    kv_quant = str(cfg.get("kv_quant") or "")
    if kv_quant not in ("", "int8"):
        raise ValueError("kv_quant must be 'int8' (got {!r})".format(kv_quant))
    if str(cfg["dtype"]) not in _DTYPES:
        raise ValueError("unsupported dtype {!r}".format(cfg["dtype"]))
    if int(cfg["n_heads"]) % int(cfg["n_kv_heads"]):
        raise ValueError("n_heads must be divisible by n_kv_heads")
    rope_freqs(int(cfg.get("head_dim") or cfg["dim"] // cfg["n_heads"]),
               float(cfg["rope_theta"]), cfg.get("rope_scaling") or None)


def torch_dtype(cfg: dict) -> torch.dtype:
    return _DTYPES[str(cfg["dtype"])]


def rms_norm(x, weight, eps):
    """f32 accumulation regardless of the activation dtype."""
    x32 = x.float()
    norm = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (norm * weight.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, rope_scaling: Optional[dict],
               device=None) -> torch.Tensor:
    if rope_scaling:
        rope_type = rope_scaling.get("rope_type") or rope_scaling.get("type")
        raise NotImplementedError(
            "rope_scaling type {!r} is not ported yet: scaled RoPE (llama3, "
            "linear, yarn, longrope) lands with the secondary-paths slice of "
            "the port".format(rope_type)
        )
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope(positions: torch.Tensor, head_dim: int, theta: float,
         rope_scaling: Optional[dict] = None):
    """cos/sin tables for the given positions: [..., head_dim // 2]."""
    freqs = rope_freqs(head_dim, theta, rope_scaling, positions.device)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x: [B, S, H, D]; cos/sin: [B, S, D/2], broadcast over heads."""
    x1, x2 = x.chunk(2, dim=-1)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def kv_store(x, kv_quant: str, dtype: torch.dtype):
    """[..., D] -> (stored, scale | None): per-vector symmetric int8 when
    ``kv_quant`` is set, else a cast to the model dtype."""
    if not kv_quant:
        return x.to(dtype), None
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.float()


class LlamaLayer(nn.Module):
    """One decoder block's weights, ``[in, out]`` like the reference."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        missing = [k for k in LAYER_KEYS if k not in params]
        extra = sorted(set(params) - set(LAYER_KEYS))
        if missing or extra:
            raise ValueError(
                "layer params: missing {} / unsupported {} (dense llama only)"
                .format(missing, extra)
            )
        for key in LAYER_KEYS:
            setattr(self, key, nn.Parameter(params[key], requires_grad=False))


class Llama(nn.Module):
    """Llama decoder over a parameter tree from ``init_params`` or
    ``convert_params``; runs on the device that holds the parameters."""

    def __init__(self, config: dict, params: Dict[str, Any]):
        super().__init__()
        cfg = resolve_config(config)
        check_config(cfg)
        self.config = cfg
        self.vocab_size = int(cfg["vocab_size"])
        self.dim = int(cfg["dim"])
        self.n_layers = int(cfg["n_layers"])
        self.n_heads = int(cfg["n_heads"])
        self.n_kv_heads = int(cfg["n_kv_heads"])
        self.head_dim = int(cfg.get("head_dim") or self.dim // self.n_heads)
        self.group = self.n_heads // self.n_kv_heads
        self.eps = float(cfg["norm_eps"])
        self.theta = float(cfg["rope_theta"])
        self.dtype = torch_dtype(cfg)
        self.kv_quant = str(cfg.get("kv_quant") or "")
        self.query_scale = float(cfg.get("query_scale") or self.head_dim ** -0.5)
        for key in ("embed", "final_norm", "lm_head"):
            if key not in params:
                raise ValueError("params need {!r}".format(key))
        if len(params["layers"]) != self.n_layers:
            raise ValueError("params hold {} layers, config says {}".format(
                len(params["layers"]), self.n_layers))
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.final_norm = nn.Parameter(params["final_norm"], requires_grad=False)
        self.lm_head = nn.Parameter(params["lm_head"], requires_grad=False)
        self.layers = nn.ModuleList(LlamaLayer(p) for p in params["layers"])
        expect = {
            "embed": (self.vocab_size, self.dim),
            "lm_head": (self.dim, self.vocab_size),
            "wq": (self.dim, self.n_heads * self.head_dim),
            "wk": (self.dim, self.n_kv_heads * self.head_dim),
            "wo": (self.n_heads * self.head_dim, self.dim),
            "w_gate": (self.dim, int(cfg["ffn_dim"])),
        }
        for key, shape in expect.items():
            t = getattr(self, key) if hasattr(self, key) else getattr(self.layers[0], key)
            if tuple(t.shape) != shape:
                raise ValueError("{} has shape {}, config says {}".format(
                    key, tuple(t.shape), shape))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- shared layer math (the reference's build() closures) ---------------

    def _qkv(self, layer, x, cos, sin):
        b, s, _ = x.shape
        q = (x @ layer.wq).reshape(b, s, self.n_heads, self.head_dim)
        k = (x @ layer.wk).reshape(b, s, self.n_kv_heads, self.head_dim)
        v = (x @ layer.wv).reshape(b, s, self.n_kv_heads, self.head_dim)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def _attend(self, q, k, v, mask):
        """q: [B,S,Hq,D]; k,v: [B,T,Hkv,D]; mask: [B,1,S,T] additive."""
        b, s, _, _ = q.shape
        qg = q.reshape(b, s, self.n_kv_heads, self.group, self.head_dim)
        scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * self.query_scale
        scores = scores + mask[:, :, None, :, :]
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bkgst,btkd->bskgd", probs, v)
        return out.reshape(b, s, self.n_heads * self.head_dim)

    def _ffn(self, layer, x):
        return (F.silu(x @ layer.w_gate) * (x @ layer.w_up)) @ layer.w_down

    def _logits(self, x):
        x = rms_norm(x, self.final_norm, self.eps)
        return (x @ self.lm_head).float()

    def _block(self, layer, x, attn_fn):
        h = rms_norm(x, layer.attn_norm, self.eps)
        x = x + attn_fn(h) @ layer.wo
        h = rms_norm(x, layer.ffn_norm, self.eps)
        return x + self._ffn(layer, h)

    # -- entry points --------------------------------------------------------

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, seq_lens: torch.Tensor):
        """Right-padded tokens [B, S]; seq_lens [B]. Returns (last-token
        logits [B, vocab] f32, cache) where cache holds the stored K/V of
        every position, ``k``/``v`` [L, B, S, Hkv, D] (int8 under
        ``kv_quant``, with f32 ``k_scale``/``v_scale`` [L, B, S, Hkv])."""
        b, s = tokens.shape
        dev = tokens.device
        positions = torch.arange(s, device=dev).expand(b, s)
        valid = positions < seq_lens.to(dev).long()[:, None]          # [B, S]
        idx = torch.arange(s, device=dev)
        causal = idx[None, :] <= idx[:, None]                         # [S, T]
        visible = causal[None] & valid[:, None, :]                    # [B, S, T]
        mask = torch.zeros(visible.shape, dtype=torch.float32, device=dev)
        mask = mask.masked_fill(~visible, float("-inf"))[:, None]
        cos, sin = rope(positions, self.head_dim, self.theta)
        x = self.embed[tokens]
        new_k, new_v = [], []
        for layer in self.layers:
            def attn(h, layer=layer):
                q, k, v = self._qkv(layer, h, cos, sin)
                new_k.append(k)
                new_v.append(v)
                return self._attend(q, k, v, mask)

            x = self._block(layer, x, attn)
        last_pos = (seq_lens.to(dev).long() - 1).clamp(min=0)
        last_x = x[torch.arange(b, device=dev), last_pos][:, None]    # [B, 1, D]
        last = self._logits(last_x)[:, 0]
        k_q, k_s = kv_store(torch.stack(new_k), self.kv_quant, self.dtype)
        v_q, v_s = kv_store(torch.stack(new_v), self.kv_quant, self.dtype)
        cache = {"k": k_q, "v": v_q}
        if self.kv_quant:
            cache["k_scale"] = k_s
            cache["v_scale"] = v_s
        return last, cache

    @torch.no_grad()
    def decode_paged(self, tokens, k_pools, v_pools, page_table, lengths,
                     write_page, write_offset, *, k_scales=None, v_scales=None):
        """One decode step over paged KV.

        tokens [B]; pools [L, Hkv, N, P, D] (int8 under ``kv_quant``, with
        f32 scale pools [L, Hkv, N, P]); page_table [B, PP] int32; lengths
        [B] int32 = tokens present BEFORE this step; write_page/offset [B]
        = where the new token's K/V goes. Scatters the new K/V (and scales)
        into the pools in place, attends through ``paged_attention`` over
        ``lengths + 1`` tokens, and returns logits [B, vocab] f32."""
        if self.kv_quant and k_scales is None:
            raise ValueError("kv_quant decode_paged needs k_scales/v_scales")
        b = tokens.shape[0]
        cos, sin = rope(lengths[:, None], self.head_dim, self.theta)
        x = self.embed[tokens][:, None]                               # [B, 1, dim]
        wp = write_page.long()
        wo = write_offset.long()
        attend_len = lengths + 1
        # the kernel scales scores by head_dim**-0.5 itself; a family
        # query_scale folds into q before it
        q_prescale = self.query_scale * (self.head_dim ** 0.5)
        for li, layer in enumerate(self.layers):
            def attn(h, li=li, layer=layer):
                q, k, v = self._qkv(layer, h, cos, sin)               # q [B,1,H,D]
                k_q, k_s = kv_store(k, self.kv_quant, self.dtype)     # [B,1,Hkv(,D)]
                v_q, v_s = kv_store(v, self.kv_quant, self.dtype)
                k_pool, v_pool = k_pools[li], v_pools[li]
                # (:, page, offset) with adjacent index tensors takes [Hkv, B, D]
                k_pool[:, wp, wo] = k_q[:, 0].transpose(0, 1).to(k_pool.dtype)
                v_pool[:, wp, wo] = v_q[:, 0].transpose(0, 1).to(v_pool.dtype)
                scale_kw = {}
                if self.kv_quant:
                    k_scales[li][:, wp, wo] = k_s[:, 0].transpose(0, 1)
                    v_scales[li][:, wp, wo] = v_s[:, 0].transpose(0, 1)
                    scale_kw = {"k_scale": k_scales[li], "v_scale": v_scales[li]}
                qg = q[:, 0].reshape(b, self.n_kv_heads, self.group, self.head_dim)
                if q_prescale != 1.0:
                    qg = qg * torch.tensor(q_prescale, dtype=qg.dtype, device=qg.device)
                out = paged_attention(qg.contiguous(), k_pool, v_pool, page_table,
                                      attend_len, **scale_kw)         # [B,Hkv,G,D]
                return out.reshape(b, 1, self.n_heads * self.head_dim).to(x.dtype)

            x = self._block(layer, x, attn)
        return self._logits(x)[:, 0]


def init_params(config: dict, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Random full-width parameters made on ``device`` from ``generator``:
    normal weights scaled by ``fan_in**-0.5`` and unit norms, like the
    reference's ``init`` (whose JAX random bits this does not reproduce)."""
    cfg = resolve_config(config)
    check_config(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    dim, vocab, ffn = int(cfg["dim"]), int(cfg["vocab_size"]), int(cfg["ffn_dim"])
    n_heads, n_kv = int(cfg["n_heads"]), int(cfg["n_kv_heads"])
    hd = int(cfg.get("head_dim") or dim // n_heads)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return (w * fan_in ** -0.5).to(dtype)

    def ones():
        return torch.ones(dim, dtype=dtype, device=dev)

    params: Dict[str, Any] = {
        "embed": dense((vocab, dim), dim),
        "final_norm": ones(),
        "lm_head": dense((dim, vocab), dim),
        "layers": [],
    }
    for _ in range(int(cfg["n_layers"])):
        params["layers"].append({
            "attn_norm": ones(),
            "wq": dense((dim, n_heads * hd), dim),
            "wk": dense((dim, n_kv * hd), dim),
            "wv": dense((dim, n_kv * hd), dim),
            "wo": dense((n_heads * hd, dim), n_heads * hd),
            "ffn_norm": ones(),
            "w_gate": dense((dim, ffn), dim),
            "w_up": dense((dim, ffn), dim),
            "w_down": dense((ffn, dim), ffn),
        })
    return params


def _to_tensor(a, device) -> torch.Tensor:
    if isinstance(a, dict):
        raise NotImplementedError(
            "quantized weight leaves ({}) are not ported yet; weight_quant "
            "arrives with the fused_int4_matmul slice".format(sorted(a))
        )
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def convert_params(np_tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The weight carrier: a reference parameter tree (``build(cfg).init``
    pulled to numpy, per-layer list or ``scan_layers`` stacked dict) ->
    this module's tree on ``device``, layout and dtype kept."""
    dev = resolve_device(device)
    extra = sorted(set(np_tree) - {"embed", "final_norm", "lm_head", "layers"})
    if extra:
        raise NotImplementedError("unsupported parameter keys {}".format(extra))
    layers = np_tree["layers"]
    if isinstance(layers, dict):  # scan_layers: leaves stacked [L, ...]
        n = len(next(iter(layers.values())))
        layers = [{k: v[i] for k, v in layers.items()} for i in range(n)]
    out: Dict[str, Any] = {
        key: _to_tensor(np_tree[key], dev) for key in ("embed", "final_norm", "lm_head")
        if key in np_tree
    }
    out["layers"] = [{k: _to_tensor(v, dev) for k, v in layer.items()} for layer in layers]
    return out

