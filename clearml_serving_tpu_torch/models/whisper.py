"""Whisper-family speech-to-text encoder-decoder (the audio routes' model).

Counterpart of ``clearml_serving_tpu/models/whisper.py``, function for
function (``PRESETS``, ``init``, ``encode``, ``init_cache``, ``decode``,
``decoder_forward``, ``cross_attention_alignment``, ``apply``) and leaf for
leaf, so a reference tree (or a bundle file) carries over through
``convert_params``. What a port must keep:

- the convolutions: the reference's are NWC/WIO with padding (1, 1) and
  stride 1, then 2; its ``[3, in, out]`` weights become ``F.conv1d``'s
  ``[out, in, 3]`` in ``convert_params``, and 3000 mel frames give 1500
  positions;
- ``k`` has no bias (the Whisper quirk);
- exact GELU, and LayerNorm in f32 (eps 1e-5, population variance), cast
  back;
- the encoder positions are a stored leaf (``enc_pos``), carried over, not
  recomputed;
- attention as the reference writes it: explicit f32 scores of the
  model-dtype q and k (``preferred_element_type=f32``), scaled, softmaxed in
  f32, cast back to v's dtype; the LM head is tied to ``embed`` and its
  logits are f32;
- JAX clamps out-of-range indices, torch does not: ``decode`` clamps the
  ``dec_pos`` gather and the self-K/V write to their last row (a serving
  loop that reaches its budget steps past the cache's end; on the card an
  unclamped index is a device-side assert), while its mask keeps the
  unclamped position, as the reference's does; token ids are clamped into
  the vocabulary;
- cross-attention in ``decode`` attends over every encoder position,
  padding included; only ``cross_attention_alignment`` masks positions at
  or past ``n_frames``, before its softmax, and returns the probabilities
  themselves.

``decode`` updates ``cache`` in place (the K/V row at ``length``, and
``length``) and returns it beside the logits, so a CUDA graph can replay it
over static buffers; ``init_cache(..., out=cache)`` refills a cache in
place. The cache is laid out for the step's reads, not as the reference's
``[L, B, T, H, Dh]``: K and V heads-major (``[L, B, H, T, Dh]``), K kept in
f32 (the exact upcast of the model-dtype K the reference multiplies in
f32), so a step's scores and its probabilities-by-V are batched products
over the cache as it lies, with no per-step upcast or permuted copy of the
1500 cross positions. A converted bundle's ``mel_filters`` leaf is not a weight: it stays
a host array in ``convert_params``, and ``llm/audio.py`` strips it.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import register_model
from .params import torch_dtype, tree_to

PRESETS: Dict[str, Dict[str, Any]] = {
    "whisper-tiny": dict(
        vocab_size=51865, d_model=384, n_audio_layers=4, n_text_layers=4,
        n_heads=6, ffn_dim=1536, n_mels=80, max_source_positions=1500,
        max_target_positions=448,
    ),
    "whisper-test": dict(  # CI-sized
        vocab_size=400, d_model=32, n_audio_layers=2, n_text_layers=2,
        n_heads=2, ffn_dim=64, n_mels=16, max_source_positions=64,
        max_target_positions=32,
    ),
}


def _layer_norm(x, p, eps=1e-5):
    """The reference's f32 LayerNorm (population variance, the scale and
    offset applied in f32, cast back): ``F.layer_norm`` accumulates and
    applies its weights in f32 for bf16 inputs too, in one kernel."""
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps)


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal encoder positions (float32)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def convert_params(np_tree, device="cuda"):
    """The reference's tree on ``device``: every leaf as it is, but the
    convolutions' ``[k, in, out]`` weights as ``[out, in, k]``; a
    ``mel_filters`` leaf stays on the host as float32 numpy."""
    tree = dict(np_tree)
    filters = tree.pop("mel_filters", None)
    out = tree_to(tree, device)
    for name in ("conv1", "conv2"):
        out[name]["w"] = out[name]["w"].permute(2, 1, 0).contiguous()
    if filters is not None:
        if isinstance(filters, torch.Tensor):
            filters = filters.float().cpu().numpy()
        out["mel_filters"] = np.asarray(filters, np.float32)
    return out


@register_model("whisper")
def build(config: dict) -> SimpleNamespace:
    cfg = dict(PRESETS.get(config.get("preset", ""), {}))
    cfg.update({k: v for k, v in config.items() if k != "preset"})
    cfg.setdefault("dtype", "float32")

    vocab = int(cfg["vocab_size"])
    d = int(cfg["d_model"])
    n_audio = int(cfg["n_audio_layers"])
    n_text = int(cfg["n_text_layers"])
    n_heads = int(cfg["n_heads"])
    ffn = int(cfg["ffn_dim"])
    n_mels = int(cfg["n_mels"])
    src_pos = int(cfg["max_source_positions"])
    tgt_pos = int(cfg["max_target_positions"])
    dtype = torch_dtype(cfg["dtype"])
    head_dim = d // n_heads

    def init(generator: torch.Generator) -> Dict[str, Any]:
        """Random parameters in the reference's layout (the bundle's)."""
        dev = generator.device

        def normal(shape, scale):
            return (torch.randn(shape, generator=generator, device=dev) * scale).to(dtype)

        def dense(shape, fan_in, bias=True):
            out = {"w": normal(shape, fan_in ** -0.5)}
            if bias:
                out["b"] = torch.zeros(shape[-1], dtype=dtype, device=dev)
            return out

        def ln():
            return {"scale": torch.ones(d, dtype=dtype, device=dev),
                    "bias": torch.zeros(d, dtype=dtype, device=dev)}

        def attn():
            # the whisper quirk: k_proj carries no bias
            return {"q": dense((d, d), d), "k": dense((d, d), d, bias=False),
                    "v": dense((d, d), d), "o": dense((d, d), d)}

        params: Dict[str, Any] = {
            "conv1": {"w": normal((3, n_mels, d), (3 * n_mels) ** -0.5),
                      "b": torch.zeros(d, dtype=dtype, device=dev)},
            "conv2": {"w": normal((3, d, d), (3 * d) ** -0.5),
                      "b": torch.zeros(d, dtype=dtype, device=dev)},
            "enc_pos": torch.from_numpy(_sinusoids(src_pos, d)).to(dev, dtype),
            "enc_final_norm": ln(),
            "embed": normal((vocab, d), 0.02),
            "dec_pos": normal((tgt_pos, d), 0.02),
            "dec_final_norm": ln(),
            "enc_layers": [],
            "dec_layers": [],
        }
        for _ in range(n_audio):
            params["enc_layers"].append({
                "attn_norm": ln(), "attn": attn(), "ffn_norm": ln(),
                "fc1": dense((d, ffn), d), "fc2": dense((ffn, d), ffn)})
        for _ in range(n_text):
            params["dec_layers"].append({
                "attn_norm": ln(), "attn": attn(), "cross_norm": ln(), "cross": attn(),
                "ffn_norm": ln(), "fc1": dense((d, ffn), d), "fc2": dense((ffn, d), ffn)})
        return params

    def _proj(p, x):
        if "b" not in p:
            return x @ p["w"]
        # the bias in the product's epilogue: one kernel
        out = torch.addmm(p["b"], x.reshape(-1, x.shape[-1]), p["w"])
        return out.reshape(*x.shape[:-1], out.shape[-1])

    def _heads(x, b, s):
        return x.reshape(b, s, n_heads, head_dim)

    def _scores(q, k):
        """f32 products of the model-dtype q [B,S,H,Dh] and k [B,T,H,Dh],
        scaled: [B,H,S,T]."""
        return torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * (head_dim ** -0.5)

    def _mha(q, k, v, mask=None):
        """q [B,S,H,Dh]; k/v [B,T,H,Dh]; mask additive [B,1,S,T] or None."""
        scores = _scores(q, k)
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bhst,bthd->bshd", probs, v)

    def _self_attn(p, x, mask):
        b, s, _ = x.shape
        q = _heads(_proj(p["q"], x), b, s)
        k = _heads(_proj(p["k"], x), b, s)
        v = _heads(_proj(p["v"], x), b, s)
        return _proj(p["o"], _mha(q, k, v, mask).reshape(b, s, d))

    def _ffn_block(layer, x):
        return _proj(layer["fc2"], F.gelu(_proj(layer["fc1"], x)))

    def _embed(params, tokens):
        return params["embed"][tokens.long().clamp(0, vocab - 1)]

    def _attend_cached(q, k, v, mask=None):
        """One query per row against the cache: q [B,1,H,Dh] (model dtype),
        k [B,H,T,Dh] f32, v [B,H,T,Dh]; the reference's ``_mha`` (f32 scores,
        scaled, masked, softmaxed, cast to v's dtype) -> [B,1,H,Dh]."""
        scores = torch.matmul(q.float().transpose(1, 2), k.transpose(-1, -2)) * (head_dim ** -0.5)
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.matmul(probs, v).transpose(1, 2)

    def _causal(s, device):
        causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=device))
        return torch.where(causal, 0.0, float("-inf"))[None, None]

    # -- encoder --------------------------------------------------------------

    def encode(params, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, n_mels, T] -> encoder states [B, T//2, d]."""
        x = mel.to(dtype)
        x = F.gelu(F.conv1d(x, params["conv1"]["w"], params["conv1"]["b"], padding=1))
        x = F.gelu(F.conv1d(x, params["conv2"]["w"], params["conv2"]["b"], stride=2,
                            padding=1))
        x = x.transpose(1, 2)                                     # [B, T//2, d]
        x = x + params["enc_pos"][: x.shape[1]].to(x.dtype)[None]
        for layer in params["enc_layers"]:
            x = x + _self_attn(layer["attn"], _layer_norm(x, layer["attn_norm"]), None)
            x = x + _ffn_block(layer, _layer_norm(x, layer["ffn_norm"]))
        return _layer_norm(x, params["enc_final_norm"])

    # -- decoder (cached serving path) ----------------------------------------

    def init_cache(params, enc_out: torch.Tensor, max_len: int,
                   out: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Per-utterance decode state: empty self-attn K/V and the cross K/V
        computed once from the encoder states, heads-major, K in f32
        (``k``, ``v``: [L, B, H, max_len, Dh]; ``cross_k``, ``cross_v``:
        [L, B, H, T, Dh]; ``length`` [B]). With ``out`` (a cache of the same
        shapes) it is refilled in place and returned."""
        b, t, _ = enc_out.shape
        if out is None:
            dev = enc_out.device
            out = {
                "k": torch.empty((n_text, b, n_heads, max_len, head_dim), device=dev),
                "v": torch.empty((n_text, b, n_heads, max_len, head_dim), dtype=dtype,
                                 device=dev),
                "cross_k": torch.empty((n_text, b, n_heads, t, head_dim), device=dev),
                "cross_v": torch.empty((n_text, b, n_heads, t, head_dim), dtype=dtype,
                                       device=dev),
                "length": torch.empty((b,), dtype=torch.int32, device=dev),
            }
        out["k"].zero_()
        out["v"].zero_()
        out["length"].zero_()
        for i, layer in enumerate(params["dec_layers"]):
            out["cross_k"][i].copy_(
                _heads(_proj(layer["cross"]["k"], enc_out), b, t).transpose(1, 2))
            out["cross_v"][i].copy_(
                _heads(_proj(layer["cross"]["v"], enc_out), b, t).transpose(1, 2))
        return out

    def decode(params, tokens: torch.Tensor, cache) -> Tuple[torch.Tensor, Dict]:
        """One token per sequence: tokens [B] -> (logits [B, vocab] f32,
        cache), the cache updated in place."""
        b = tokens.shape[0]
        max_len = cache["k"].shape[3]
        pos = cache["length"].long()                              # [B]
        x = (_embed(params, tokens)[:, None]
             + params["dec_pos"][pos.clamp(max=tgt_pos - 1)][:, None])
        visible = torch.arange(max_len, device=pos.device)[None] <= pos[:, None]
        mask = torch.where(visible, 0.0, float("-inf"))[:, None, None]
        rows = torch.arange(b, device=pos.device)
        write = pos.clamp(max=max_len - 1)
        for i, layer in enumerate(params["dec_layers"]):
            h = _layer_norm(x, layer["attn_norm"])
            q = _heads(_proj(layer["attn"]["q"], h), b, 1)
            cache["k"][i][rows, :, write] = _proj(layer["attn"]["k"], h)[:, 0].reshape(
                b, n_heads, head_dim).float()
            cache["v"][i][rows, :, write] = _proj(layer["attn"]["v"], h)[:, 0].reshape(
                b, n_heads, head_dim)
            attn = _attend_cached(q, cache["k"][i], cache["v"][i], mask).reshape(b, 1, d)
            x = x + _proj(layer["attn"]["o"], attn)
            h = _layer_norm(x, layer["cross_norm"])
            qc = _heads(_proj(layer["cross"]["q"], h), b, 1)
            cross = _attend_cached(qc, cache["cross_k"][i], cache["cross_v"][i]).reshape(b, 1, d)
            x = x + _proj(layer["cross"]["o"], cross)
            x = x + _ffn_block(layer, _layer_norm(x, layer["ffn_norm"]))
        x = _layer_norm(x, params["dec_final_norm"])
        logits = (x[:, 0] @ params["embed"].T).float()
        cache["length"] += 1
        return logits, cache

    def cross_attention_alignment(params, tokens: torch.Tensor, enc_out: torch.Tensor,
                                  heads: tuple, n_frames=None) -> torch.Tensor:
        """Teacher-forced decoder pass returning the cross-attention
        probabilities of the selected alignment heads: tokens [B, S] ->
        [N, B, S, T] float32, N = len(heads), ``heads`` (layer, head)
        pairs. ``n_frames`` (an int or a 0-d tensor): the encoder positions
        of the real audio; the alignment softmax masks the positions past
        it before normalizing, while the decoder's own residual stream keeps
        the full-window attention the serving decode uses."""
        b, s = tokens.shape
        x = _embed(params, tokens) + params["dec_pos"][:s][None]
        mask = _causal(s, tokens.device)
        t = enc_out.shape[1]
        frame_ok = None
        if n_frames is not None:
            frame_ok = (torch.arange(t, device=enc_out.device) < n_frames)[None, None, None, :]
        by_layer: Dict[int, list] = {}
        for li, hi in heads:
            by_layer.setdefault(int(li), []).append(int(hi))
        picked = []
        for i, layer in enumerate(params["dec_layers"]):
            x = x + _self_attn(layer["attn"], _layer_norm(x, layer["attn_norm"]), mask)
            h = _layer_norm(x, layer["cross_norm"])
            qc = _heads(_proj(layer["cross"]["q"], h), b, s)
            kc = _heads(_proj(layer["cross"]["k"], enc_out), b, t)
            vc = _heads(_proj(layer["cross"]["v"], enc_out), b, t)
            scores = _scores(qc, kc)                              # [B, H, S, T]
            probs = torch.softmax(scores, dim=-1)
            if by_layer.get(i):
                a_scores = scores
                if frame_ok is not None:
                    a_scores = torch.where(frame_ok, scores, float("-inf"))
                a_probs = torch.softmax(a_scores, dim=-1)
                for hi in by_layer[i]:
                    picked.append(a_probs[:, hi])
            cross = torch.einsum("bhst,bthd->bshd", probs.to(vc.dtype), vc).reshape(b, s, d)
            x = x + _proj(layer["cross"]["o"], cross)
            x = x + _ffn_block(layer, _layer_norm(x, layer["ffn_norm"]))
        return torch.stack(picked)                               # [N, B, S, T]

    def decoder_forward(params, tokens: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
        """Full teacher-forced decoder pass: tokens [B, S] -> logits
        [B, S, vocab] f32."""
        b, s = tokens.shape
        x = _embed(params, tokens) + params["dec_pos"][:s][None]
        mask = _causal(s, tokens.device)
        t = enc_out.shape[1]
        for layer in params["dec_layers"]:
            x = x + _self_attn(layer["attn"], _layer_norm(x, layer["attn_norm"]), mask)
            h = _layer_norm(x, layer["cross_norm"])
            qc = _heads(_proj(layer["cross"]["q"], h), b, s)
            kc = _heads(_proj(layer["cross"]["k"], enc_out), b, t)
            vc = _heads(_proj(layer["cross"]["v"], enc_out), b, t)
            x = x + _proj(layer["cross"]["o"], _mha(qc, kc, vc).reshape(b, s, d))
            x = x + _ffn_block(layer, _layer_norm(x, layer["ffn_norm"]))
        x = _layer_norm(x, params["dec_final_norm"])
        return (x @ params["embed"].T).float()

    return SimpleNamespace(
        init=init,
        encode=encode,
        init_cache=init_cache,
        decode=decode,
        decoder_forward=decoder_forward,
        cross_attention_alignment=cross_attention_alignment,
        apply=decoder_forward,
        convert_params=convert_params,
        config=cfg,
        n_heads=n_heads,
        head_dim=head_dim,
    )
