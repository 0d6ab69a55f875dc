"""Audio frontend of the speech routes: WAV decode and Whisper's log-mel.

The port's own copy of ``clearml_serving_tpu/ops/audio.py``, numpy only, so
the features the port's encoder sees are the reference's bit for bit:

- ``decode_wav``: PCM8/16/32 through the stdlib ``wave`` module, IEEE-float
  32/64 (format 3 and WAVE_FORMAT_EXTENSIBLE) through
  ``_parse_riff_float_wav``; channels averaged, any rate resampled linearly;
- ``mel_filter_bank``: the slaney filters from ``transformers.audio_utils``
  where that imports, else the minimal slaney implementation below (the
  machine with the card has no ``transformers``: it takes the fallback, so a
  comparison across machines passes the same filters to both sides; the two
  branches are close, not equal);
- ``log_mel_spectrogram``: WhisperFeatureExtractor's numerics.

The frontend stays on the host, as in the reference: the card sees only the
fixed-shape mel batch. A converted bundle carries the checkpoint's own
filters (``engines/importers/convert_hf_whisper.py``); ``mel_filter_bank``
serves weightless demo bundles.
"""

from __future__ import annotations

import io
from typing import Optional, Tuple

import numpy as np


def _parse_riff_float_wav(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Minimal RIFF parser for IEEE-float WAVs (format 3, or EXTENSIBLE with
    a float subformat) — the stdlib ``wave`` module rejects them before any
    sample-width heuristic can run. Returns (samples, n_channels, rate)."""
    import struct

    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    payload = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif chunk_id == b"data":
            payload = body
        pos += 8 + size + (size & 1)
    if fmt is None or payload is None:
        raise ValueError("WAV missing fmt/data chunks")
    audio_format, n_channels, rate, _, _, bits = fmt
    if audio_format == 0xFFFE and len(data) >= 2:  # WAVE_FORMAT_EXTENSIBLE
        # subformat GUID's leading u16 carries the real format code
        idx = data.find(b"fmt ")
        sub = struct.unpack_from("<H", data, idx + 8 + 24)[0] if idx >= 0 else 0
        audio_format = sub
    if audio_format != 3:
        raise ValueError("unsupported WAV format code {}".format(audio_format))
    dtype = np.float32 if bits == 32 else np.float64 if bits == 64 else None
    if dtype is None:
        raise ValueError("unsupported float WAV bit depth {}".format(bits))
    samples = np.frombuffer(payload, dtype).astype(np.float32)
    return samples, int(n_channels), int(rate)


def decode_wav(data: bytes, target_rate: int = 16000) -> np.ndarray:
    """WAV bytes -> mono float32 PCM in [-1, 1] at target_rate.

    Accepts PCM8/16/32 (stdlib wave) and IEEE-float32/64 WAVs (RIFF
    fallback — soundfile/librosa's default export), any channel count
    (averaged), any rate (linear resample)."""
    import wave

    try:
        with wave.open(io.BytesIO(data)) as wav:
            n_channels = wav.getnchannels()
            width = wav.getsampwidth()
            rate = wav.getframerate()
            raw = wav.readframes(wav.getnframes())
            comp = wav.getcomptype()
    except wave.Error as ex:
        try:  # stdlib wave rejects IEEE-float (format 3) outright
            pcm, n_channels, rate = _parse_riff_float_wav(data)
        except ValueError:
            raise ValueError("not a valid WAV file: {}".format(ex))
        width = comp = None
    if comp is not None and comp not in ("NONE",):
        raise ValueError("compressed WAV ({}) is not supported".format(comp))
    if width == 2:
        pcm = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        pcm = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        pcm = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width is not None:
        raise ValueError("unsupported WAV sample width {}".format(width))
    if n_channels > 1:
        pcm = pcm.reshape(-1, n_channels).mean(axis=1)
    if rate != target_rate and len(pcm):
        n_out = int(round(len(pcm) * target_rate / rate))
        pcm = np.interp(
            np.linspace(0.0, len(pcm) - 1, n_out), np.arange(len(pcm)), pcm
        ).astype(np.float32)
    return pcm.astype(np.float32)


def mel_filter_bank(n_mels: int, n_fft: int = 400, sampling_rate: int = 16000) -> np.ndarray:
    """[n_freq, n_mels] slaney-scale filterbank (Whisper's convention).
    Fallback only — converted bundles carry the checkpoint's own filters."""
    try:
        from transformers.audio_utils import mel_filter_bank as hf_bank

        return np.asarray(
            hf_bank(
                num_frequency_bins=1 + n_fft // 2,
                num_mel_filters=n_mels,
                min_frequency=0.0,
                max_frequency=sampling_rate / 2.0,
                sampling_rate=sampling_rate,
                norm="slaney",
                mel_scale="slaney",
            ),
            np.float32,
        )
    except Exception:
        # minimal slaney implementation (triangular filters, area-normalized)
        def hz_to_mel(f):
            f = np.asarray(f, np.float64)
            mel = 3.0 * f / 200.0
            log_region = f >= 1000.0
            mel = np.where(
                log_region, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) * (27.0 / np.log(6.4)), mel
            )
            return mel

        def mel_to_hz(m):
            m = np.asarray(m, np.float64)
            f = 200.0 * m / 3.0
            log_region = m >= 15.0
            return np.where(log_region, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), f)

        n_freq = 1 + n_fft // 2
        freqs = np.linspace(0, sampling_rate / 2.0, n_freq)
        mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sampling_rate / 2.0), n_mels + 2))
        bank = np.zeros((n_freq, n_mels), np.float64)
        for i in range(n_mels):
            lo, ctr, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
            up = (freqs - lo) / max(ctr - lo, 1e-10)
            down = (hi - freqs) / max(hi - ctr, 1e-10)
            bank[:, i] = np.maximum(0.0, np.minimum(up, down)) * (2.0 / (hi - lo))
        return bank.astype(np.float32)


def log_mel_spectrogram(
    pcm: np.ndarray,
    mel_filters: np.ndarray,
    *,
    n_fft: int = 400,
    hop_length: int = 160,
    n_samples: Optional[int] = None,
) -> np.ndarray:
    """float32 PCM -> Whisper log-mel [n_mels, n_frames].

    Matches transformers' WhisperFeatureExtractor numerics: pad/trim to
    n_samples, centered reflect-padded STFT with a periodic Hann window,
    power spectrum, mel projection, log10 clamp to (max - 8), (x + 4) / 4.
    """
    pcm = np.asarray(pcm, np.float32).reshape(-1)
    if n_samples is not None:
        if len(pcm) < n_samples:
            pcm = np.pad(pcm, (0, n_samples - len(pcm)))
        else:
            pcm = pcm[:n_samples]
    window = np.hanning(n_fft + 1)[:-1].astype(np.float64)  # periodic hann
    half = n_fft // 2
    padded = np.pad(pcm.astype(np.float64), (half, half), mode="reflect")
    n_frames = 1 + (len(padded) - n_fft) // hop_length
    idx = np.arange(n_fft)[None] + hop_length * np.arange(n_frames)[:, None]
    frames = padded[idx] * window[None]
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2                # [F, n_freq]
    spec = spec[:-1]                                               # whisper drops the final frame
    filters = np.asarray(mel_filters, np.float64)
    if filters.shape[0] != spec.shape[1]:
        filters = filters.T                                        # accept [n_mels, n_freq]
    mel = spec @ filters                                           # [F, n_mels]
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return (((log_spec + 4.0) / 4.0).T).astype(np.float32)         # [n_mels, F]
