"""The port's audio frontend (``ops/audio.py``) against the reference's
(``clearml_serving_tpu/ops/audio.py``): both are numpy on the host, so the
same bytes give the same arrays, bit for bit.

- ``decode_wav``: PCM8, PCM16 and PCM32, IEEE float32 and float64 RIFF,
  WAVE_FORMAT_EXTENSIBLE (PCM and float), stereo, resampled, and the
  refusals (not a WAV, compressed, an unsupported width or format);
- ``mel_filter_bank``: the ``transformers.audio_utils`` branch this image
  takes, and the slaney fallback (the import made to fail, as on the
  machine with the card), each against the reference's same branch;
- ``log_mel_spectrogram``: padded, trimmed and exact windows over both
  filter layouts; against ``WhisperFeatureExtractor`` where
  ``transformers`` imports.
"""

import io
import struct
import sys
import wave

import numpy as np
import pytest

from clearml_serving_tpu.ops import audio as ref_audio
from clearml_serving_tpu_torch.ops import audio as port_audio


def _pcm_wav(samples: np.ndarray, rate: int, width: int, channels: int = 1) -> bytes:
    """``samples`` in [-1, 1], [frames, channels] or [frames], through the
    stdlib writer at ``width`` bytes a sample."""
    x = np.asarray(samples, np.float64).reshape(-1, channels)
    if width == 1:
        raw = np.clip(np.round(x * 127 + 128), 0, 255).astype(np.uint8)
    elif width == 2:
        raw = np.round(x * 32767).astype("<i2")
    else:
        raw = np.round(x * 2147483647).astype("<i4")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(raw.tobytes())
    return buf.getvalue()


def _riff(fmt_body: bytes, payload: bytes) -> bytes:
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt_body) + 8 + len(payload)) + b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
            + b"data" + struct.pack("<I", len(payload)) + payload)


def _float_wav(samples: np.ndarray, rate: int, bits: int, channels: int = 1,
               extensible: bool = False, code: int = 3) -> bytes:
    dtype = np.float32 if bits == 32 else np.float64
    payload = np.asarray(samples, dtype).tobytes()
    block = channels * bits // 8
    if not extensible:
        return _riff(struct.pack("<HHIIHH", code, channels, rate, rate * block, block, bits),
                     payload)
    guid = struct.pack("<H", code) + b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
    body = struct.pack("<HHIIHHHHI", 0xFFFE, channels, rate, rate * block, block, bits, 22,
                       bits, 0) + guid
    return _riff(body, payload)


def _tone(seconds: float, rate: int, channels: int = 1, seed: int = 0) -> np.ndarray:
    t = np.arange(int(seconds * rate)) / rate
    sig = 0.4 * np.sin(2 * np.pi * 330 * t) + 0.05 * np.random.default_rng(seed).standard_normal(
        len(t))
    if channels == 1:
        return sig.astype(np.float32)
    return np.stack([sig, 0.5 * sig], axis=1).astype(np.float32)


WAVS = {
    "pcm8": lambda: _pcm_wav(_tone(0.5, 16000), 16000, 1),
    "pcm16": lambda: _pcm_wav(_tone(0.5, 16000), 16000, 2),
    "pcm32": lambda: _pcm_wav(_tone(0.5, 16000), 16000, 4),
    "pcm16_stereo_8k": lambda: _pcm_wav(_tone(0.7, 8000, 2), 8000, 2, channels=2),
    "pcm16_44k1": lambda: _pcm_wav(_tone(0.3, 44100), 44100, 2),
    "float32": lambda: _float_wav(_tone(0.5, 16000), 16000, 32),
    "float64": lambda: _float_wav(_tone(0.5, 16000), 16000, 64),
    "float32_stereo_22k": lambda: _float_wav(_tone(0.4, 22050, 2), 22050, 32, channels=2),
    "float32_extensible": lambda: _float_wav(_tone(0.5, 16000), 16000, 32, extensible=True),
    "float64_extensible_stereo": lambda: _float_wav(_tone(0.5, 24000, 2), 24000, 64, channels=2,
                                                    extensible=True),
    "pcm16_extensible": lambda: _float_wav(
        (np.round(_tone(0.5, 16000) * 32767) / 32767), 16000, 32, extensible=True, code=1),
    "empty": lambda: _pcm_wav(np.zeros(0, np.float32), 16000, 2),
}


@pytest.mark.parametrize("name", sorted(WAVS))
def test_decode_wav_equals_the_reference(name):
    data = WAVS[name]()
    try:
        want = ref_audio.decode_wav(data, target_rate=16000)
    except ValueError as ex:
        with pytest.raises(ValueError) as got:
            port_audio.decode_wav(data, target_rate=16000)
        assert str(got.value) == str(ex)
        return
    got = port_audio.decode_wav(data, target_rate=16000)
    assert got.dtype == np.float32 == want.dtype
    np.testing.assert_array_equal(got, want)
    if name.startswith("float32") and "stereo" not in name and "22k" not in name:
        np.testing.assert_allclose(got, _tone(0.5, 16000), rtol=1e-6)
    if name == "pcm16_stereo_8k":
        assert got.shape == (int(round(0.7 * 8000 * 2)),)   # resampled to 16 kHz


@pytest.mark.parametrize("data", [
    b"not a wav at all",
    _riff(struct.pack("<HHIIHH", 3, 1, 16000, 16000 * 2, 2, 16), b"\x00" * 8),   # 16-bit float
    _riff(struct.pack("<HHIIHH", 6, 1, 8000, 8000, 1, 8), b"\x00" * 8),          # a-law
    b"RIFF\x04\x00\x00\x00WAVE",                                                  # no chunks
], ids=["garbage", "float16", "alaw", "no_chunks"])
def test_bad_uploads_are_refused_with_the_reference_words(data):
    with pytest.raises(ValueError) as want:
        ref_audio.decode_wav(data)
    with pytest.raises(ValueError) as got:
        port_audio.decode_wav(data)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n_mels", [16, 80, 128])
def test_mel_filter_bank_hf_branch_equals_the_reference(n_mels):
    pytest.importorskip("transformers.audio_utils")
    got = port_audio.mel_filter_bank(n_mels, 400, 16000)
    np.testing.assert_array_equal(got, ref_audio.mel_filter_bank(n_mels, 400, 16000))
    assert got.shape == (201, n_mels) and got.dtype == np.float32


@pytest.mark.parametrize("n_mels", [16, 80, 128])
def test_mel_filter_bank_fallback_equals_the_reference(n_mels, monkeypatch):
    """The branch the card's machine takes (no ``transformers``): the import
    made to fail on both sides."""
    monkeypatch.setitem(sys.modules, "transformers.audio_utils", None)
    got = port_audio.mel_filter_bank(n_mels, 400, 16000)
    want = ref_audio.mel_filter_bank(n_mels, 400, 16000)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (201, n_mels) and got.dtype == np.float32
    monkeypatch.undo()
    if n_mels == 16 and _has_transformers():
        # the two branches are close (the reference's own test, at 16
        # mels), not equal: a comparison across the machines passes the
        # same filters to both sides
        np.testing.assert_allclose(got, port_audio.mel_filter_bank(n_mels, 400, 16000),
                                   rtol=1e-4, atol=1e-5)


def _has_transformers() -> bool:
    try:
        import transformers.audio_utils  # noqa: F401
    except ImportError:
        return False
    return True


@pytest.mark.parametrize("seconds", [0.3, 1.0, 2.5])
@pytest.mark.parametrize("layout", ["freq_mels", "mels_freq"])
def test_log_mel_equals_the_reference(seconds, layout, monkeypatch):
    """Padded (0.3 s), exact (1 s) and trimmed (2.5 s) against a 1 s window,
    the filters as ``[n_freq, n_mels]`` or transposed."""
    monkeypatch.setitem(sys.modules, "transformers.audio_utils", None)
    filters = port_audio.mel_filter_bank(16, 400, 16000)
    if layout == "mels_freq":
        filters = filters.T
    pcm = _tone(seconds, 16000, seed=2)
    got = port_audio.log_mel_spectrogram(pcm, filters, n_samples=16000)
    want = ref_audio.log_mel_spectrogram(pcm, filters, n_samples=16000)
    assert got.shape == want.shape == (16, 100) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_audio.log_mel_spectrogram(pcm, filters),
                                  ref_audio.log_mel_spectrogram(pcm, filters))


def test_log_mel_matches_the_feature_extractor():
    transformers = pytest.importorskip("transformers")
    fe = transformers.WhisperFeatureExtractor(
        feature_size=16, sampling_rate=16000, hop_length=160, chunk_length=2, n_fft=400)
    pcm = (np.random.RandomState(3).rand(20000).astype(np.float32) - 0.5) * 0.2
    theirs = fe(pcm, sampling_rate=16000, return_tensors="np").input_features[0]
    ours = port_audio.log_mel_spectrogram(pcm, np.asarray(fe.mel_filters), n_fft=400,
                                          hop_length=160, n_samples=fe.n_samples)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-4)
