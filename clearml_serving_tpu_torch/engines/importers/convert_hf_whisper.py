"""HF Whisper checkpoint -> whisper bundle.

The port's counterpart of
``clearml_serving_tpu/engines/importers/convert_hf_whisper.py``: maps
``transformers.WhisperForConditionalGeneration`` state dicts onto
``models/whisper.py``'s tree (the reference's layout, so the bundle is the
reference's), and captures everything serving needs beside the weights:

- the mel filterbank (from the checkpoint's WhisperFeatureExtractor, saved
  into the bundle so serving never re-derives slaney filters);
- the decoder prompt ids (<|startoftranscript|> [lang] <|transcribe|> /
  <|translate|> <|notimestamps|>) for both audio tasks, and the timestamp
  vocabulary;
- eot/eos ids, and the checkpoint's alignment heads where it ships them.

``convert`` imports ``transformers`` inside the function (the machine with
the card has none) and writes the bundle with the port's ``save_bundle``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


def convert_state_dict(sd: Dict[str, Any], cfg: dict) -> Dict[str, Any]:
    """torch state dict (or numpy mapping) -> whisper param tree."""

    def t(name):  # tensor by HF name -> numpy
        v = sd[name]
        return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)

    def lin(prefix, bias=True):
        out = {"w": t(prefix + ".weight").T}  # torch [out,in] -> [in,out]
        if bias:
            out["b"] = t(prefix + ".bias")
        return out

    def ln(prefix):
        return {"scale": t(prefix + ".weight"), "bias": t(prefix + ".bias")}

    def attn(prefix):
        return {
            "q": lin(prefix + ".q_proj"),
            "k": lin(prefix + ".k_proj", bias=False),  # whisper: k has no bias
            "v": lin(prefix + ".v_proj"),
            "o": lin(prefix + ".out_proj"),
        }

    enc = "model.encoder." if "model.encoder.conv1.weight" in sd else "encoder."
    dec = "model.decoder." if "model.decoder.embed_tokens.weight" in sd else "decoder."

    params: Dict[str, Any] = {
        # torch conv1d weight [out, in, k] -> lax NWC/WIO [k, in, out]
        "conv1": {
            "w": t(enc + "conv1.weight").transpose(2, 1, 0),
            "b": t(enc + "conv1.bias"),
        },
        "conv2": {
            "w": t(enc + "conv2.weight").transpose(2, 1, 0),
            "b": t(enc + "conv2.bias"),
        },
        "enc_pos": t(enc + "embed_positions.weight"),
        "enc_final_norm": ln(enc + "layer_norm"),
        "embed": t(dec + "embed_tokens.weight"),
        "dec_pos": t(dec + "embed_positions.weight"),
        "dec_final_norm": ln(dec + "layer_norm"),
        "enc_layers": [],
        "dec_layers": [],
    }
    for i in range(int(cfg["n_audio_layers"])):
        p = "{}layers.{}.".format(enc, i)
        params["enc_layers"].append(
            {
                "attn_norm": ln(p + "self_attn_layer_norm"),
                "attn": attn(p + "self_attn"),
                "ffn_norm": ln(p + "final_layer_norm"),
                "fc1": lin(p + "fc1"),
                "fc2": lin(p + "fc2"),
            }
        )
    for i in range(int(cfg["n_text_layers"])):
        p = "{}layers.{}.".format(dec, i)
        params["dec_layers"].append(
            {
                "attn_norm": ln(p + "self_attn_layer_norm"),
                "attn": attn(p + "self_attn"),
                "cross_norm": ln(p + "encoder_attn_layer_norm"),
                "cross": attn(p + "encoder_attn"),
                "ffn_norm": ln(p + "final_layer_norm"),
                "fc1": lin(p + "fc1"),
                "fc2": lin(p + "fc2"),
            }
        )
    return params


def config_from_hf(hf_config) -> dict:
    return dict(
        vocab_size=int(hf_config.vocab_size),
        d_model=int(hf_config.d_model),
        n_audio_layers=int(hf_config.encoder_layers),
        n_text_layers=int(hf_config.decoder_layers),
        n_heads=int(hf_config.encoder_attention_heads),
        ffn_dim=int(hf_config.encoder_ffn_dim),
        n_mels=int(hf_config.num_mel_bins),
        max_source_positions=int(hf_config.max_source_positions),
        max_target_positions=int(hf_config.max_target_positions),
    )


def prompt_ids_from_tokenizer(tok, language: Optional[str] = None) -> dict:
    """Decoder prompt + stop ids for both audio tasks."""

    def tid(token):
        i = tok.convert_tokens_to_ids(token)
        return int(i) if i is not None and i >= 0 else None

    sot = tid("<|startoftranscript|>")
    notimestamps = tid("<|notimestamps|>")
    lang = tid("<|{}|>".format(language)) if language else None
    out = {"eos_token_id": int(tok.eos_token_id)}
    if notimestamps is not None:
        # timestamp vocabulary starts right after <|notimestamps|>; each id
        # encodes (id - begin) * 0.02 s — enables verbose_json segments
        out["notimestamps_token_id"] = notimestamps
        out["timestamp_begin"] = notimestamps + 1
        out["time_precision"] = 0.02
    for task in ("transcribe", "translate"):
        task_id = tid("<|{}|>".format(task))
        ids = [x for x in (sot, lang, task_id, notimestamps) if x is not None]
        out["{}_prompt_ids".format(task)] = ids
    return out


def convert(model_dir: str, out_dir: str, language: Optional[str] = None) -> None:
    """Local HF Whisper checkpoint dir -> servable whisper bundle dir."""
    import shutil
    from pathlib import Path

    import transformers

    from ..jax_engine import save_bundle

    hf = transformers.WhisperForConditionalGeneration.from_pretrained(
        model_dir, local_files_only=True
    )
    cfg = config_from_hf(hf.config)
    params = convert_state_dict(hf.state_dict(), cfg)

    fe = transformers.WhisperFeatureExtractor.from_pretrained(
        model_dir, local_files_only=True
    )
    # mel filters ride the param tree: serving never re-derives slaney banks
    params["mel_filters"] = np.asarray(fe.mel_filters, np.float32)
    cfg["sampling_rate"] = int(fe.sampling_rate)
    cfg["hop_length"] = int(fe.hop_length)
    cfg["n_fft"] = int(fe.n_fft)
    cfg["chunk_length"] = int(fe.chunk_length)

    tok = transformers.WhisperTokenizer.from_pretrained(model_dir, local_files_only=True)
    cfg.update(prompt_ids_from_tokenizer(tok, language=language))

    # curated word-alignment heads (openai ships them per released model;
    # HF stores them on generation_config). Without them the word-timestamp
    # DTW falls back to the noisier top-half-of-decoder heuristic
    # (llm/audio.py _alignment_heads).
    gen_cfg = getattr(hf, "generation_config", None)
    heads = getattr(gen_cfg, "alignment_heads", None)
    if heads:
        cfg["alignment_heads"] = [[int(l), int(h)] for l, h in heads]

    save_bundle(out_dir, "whisper", cfg, params)
    for f in Path(model_dir).glob("*token*"):
        shutil.copy(f, Path(out_dir) / f.name)
    for name in ("vocab.json", "merges.txt", "normalizer.json"):
        src = Path(model_dir) / name
        if src.exists():
            shutil.copy(src, Path(out_dir) / name)
    print("whisper bundle written to {}".format(out_dir))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("model_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--language", default=None)
    convert(**vars(ap.parse_args()))
