"""VGGish's log-mel frontend: waveform -> 0.96 s log-mel examples.

Port of ``video_features_tpu/ops/audio.py`` (reference
models/vggish/vggish_src/mel_features.py + vggish_input.py):

  - the host frontend, a numpy copy: stride-tricks framing with no zero
    padding, the *periodic* Hann window, the rFFT magnitude STFT at the next
    power of two of the 400-sample window, the HTK mel filterbank (64 bins
    over 125-7500 Hz, DC row zeroed), ``log(mel + 0.01)``, and 96-frame
    examples with no overlap; ``scipy.signal.resample_poly`` (imported where
    it runs) in place of the reference's ``resampy``; 16-bit PCM WAV through
    the stdlib ``wave`` with the reference's ``/ 32768.0``;
  - the device frontend :func:`logmel_examples`, a torch function of the
    same math on (B, 15600) waveform chunks (:func:`chunk_waveform`): the
    framing gather, the window, ``torch.fft.rfft`` (cuFFT on the card),
    ``abs``, the float32 mel matmul and the log. Chunking reproduces
    whole-waveform processing: example i covers log-mel frames [96i,
    96i + 96), whose STFTs read samples [15360i, 15360i + 15600).
"""
from __future__ import annotations

import wave as wave_module
from fractions import Fraction
from typing import Tuple

import numpy as np
import torch

SAMPLE_RATE = 16000
STFT_WINDOW_LENGTH_SECONDS = 0.025
STFT_HOP_LENGTH_SECONDS = 0.010
NUM_MEL_BINS = 64
MEL_MIN_HZ = 125.0
MEL_MAX_HZ = 7500.0
LOG_OFFSET = 0.01
EXAMPLE_WINDOW_SECONDS = 0.96
EXAMPLE_HOP_SECONDS = 0.96

_MEL_BREAK_FREQUENCY_HERTZ = 700.0
_MEL_HIGH_FREQUENCY_Q = 1127.0

EXAMPLE_CHUNK_SAMPLES = 95 * 160 + 400  # 15600
EXAMPLE_HOP_SAMPLES = 96 * 160          # 15360
_WINDOW = 400
_HOP = 160
_FFT_LENGTH = 512
_EXAMPLE_FRAMES = 96


def frame(data: np.ndarray, window_length: int,
          hop_length: int) -> np.ndarray:
    """(num_samples, ...) -> (num_frames, window_length, ...) strided view;
    incomplete trailing frames are dropped (mel_features.py:21-45)."""
    num_samples = data.shape[0]
    num_frames = 1 + int(np.floor((num_samples - window_length) / hop_length))
    shape = (num_frames, window_length) + data.shape[1:]
    strides = (data.strides[0] * hop_length,) + data.strides
    return np.lib.stride_tricks.as_strided(data, shape=shape, strides=strides)


def periodic_hann(window_length: int) -> np.ndarray:
    """One full cycle of a period-N raised cosine (mel_features.py:48-68),
    not ``np.hanning``'s symmetric period-(N-1) window."""
    return 0.5 - 0.5 * np.cos(
        2 * np.pi / window_length * np.arange(window_length))


def stft_magnitude(signal: np.ndarray, fft_length: int, hop_length: int,
                   window_length: int) -> np.ndarray:
    frames = frame(signal, window_length, hop_length)
    return np.abs(np.fft.rfft(frames * periodic_hann(window_length),
                              int(fft_length)))


def hertz_to_mel(frequencies_hertz) -> np.ndarray:
    """HTK mel scale (mel_features.py:100-112)."""
    return _MEL_HIGH_FREQUENCY_Q * np.log(
        1.0 + (frequencies_hertz / _MEL_BREAK_FREQUENCY_HERTZ))


def spectrogram_to_mel_matrix(num_mel_bins: int = 20,
                              num_spectrogram_bins: int = 129,
                              audio_sample_rate: float = 8000,
                              lower_edge_hertz: float = 125.0,
                              upper_edge_hertz: float = 3800.0) -> np.ndarray:
    """(num_spectrogram_bins, num_mel_bins) triangular-in-mel filterbank,
    DC row zeroed (mel_features.py:114-189)."""
    nyquist_hertz = audio_sample_rate / 2.0
    if lower_edge_hertz < 0.0:
        raise ValueError(f"lower_edge_hertz {lower_edge_hertz} must be >= 0")
    if lower_edge_hertz >= upper_edge_hertz:
        raise ValueError(f"lower_edge_hertz {lower_edge_hertz} >= "
                         f"upper_edge_hertz {upper_edge_hertz}")
    if upper_edge_hertz > nyquist_hertz:
        raise ValueError(f"upper_edge_hertz {upper_edge_hertz} is greater "
                         f"than Nyquist {nyquist_hertz}")
    spectrogram_bins_mel = hertz_to_mel(
        np.linspace(0.0, nyquist_hertz, num_spectrogram_bins))
    band_edges_mel = np.linspace(hertz_to_mel(lower_edge_hertz),
                                 hertz_to_mel(upper_edge_hertz),
                                 num_mel_bins + 2)
    weights = np.empty((num_spectrogram_bins, num_mel_bins))
    for i in range(num_mel_bins):
        lower, center, upper = band_edges_mel[i:i + 3]
        lower_slope = (spectrogram_bins_mel - lower) / (center - lower)
        upper_slope = (upper - spectrogram_bins_mel) / (upper - center)
        weights[:, i] = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    weights[0, :] = 0.0
    return weights


def log_mel_spectrogram(data: np.ndarray,
                        audio_sample_rate: float = 8000,
                        log_offset: float = 0.0,
                        window_length_secs: float = 0.025,
                        hop_length_secs: float = 0.010,
                        **kwargs) -> np.ndarray:
    """(num_frames, num_mel_bins) log-mel magnitudes
    (mel_features.py:192-232)."""
    window_length_samples = int(round(audio_sample_rate * window_length_secs))
    hop_length_samples = int(round(audio_sample_rate * hop_length_secs))
    fft_length = 2 ** int(
        np.ceil(np.log(window_length_samples) / np.log(2.0)))
    spectrogram = stft_magnitude(data, fft_length, hop_length_samples,
                                 window_length_samples)
    mel = np.dot(spectrogram, spectrogram_to_mel_matrix(
        num_spectrogram_bins=spectrogram.shape[1],
        audio_sample_rate=audio_sample_rate, **kwargs))
    return np.log(mel + log_offset)


def resample(data: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Polyphase Kaiser resampling (in place of the reference's resampy
    call, vggish_input.py:49-50)."""
    from scipy.signal import resample_poly
    ratio = Fraction(int(dst_rate), int(src_rate))
    return resample_poly(data, ratio.numerator, ratio.denominator)


def _mono_16k(data: np.ndarray, sample_rate: int) -> np.ndarray:
    if data.ndim > 1:
        data = np.mean(data, axis=1)  # mono mix
    if sample_rate != SAMPLE_RATE:
        data = resample(data, sample_rate, SAMPLE_RATE)
    return data


def waveform_to_examples(data: np.ndarray, sample_rate: int) -> np.ndarray:
    """Waveform -> (num_examples, 96, 64, 1) float32 NHWC log-mel patches
    (vggish_input.py:26-77). Fewer than 400 samples (after resampling)
    raise from :func:`frame`; fewer than one example's 96 STFT frames give
    0 examples."""
    data = _mono_16k(data, sample_rate)
    log_mel = log_mel_spectrogram(
        data, audio_sample_rate=SAMPLE_RATE, log_offset=LOG_OFFSET,
        window_length_secs=STFT_WINDOW_LENGTH_SECONDS,
        hop_length_secs=STFT_HOP_LENGTH_SECONDS,
        num_mel_bins=NUM_MEL_BINS, lower_edge_hertz=MEL_MIN_HZ,
        upper_edge_hertz=MEL_MAX_HZ)
    features_sample_rate = 1.0 / STFT_HOP_LENGTH_SECONDS
    window = int(round(EXAMPLE_WINDOW_SECONDS * features_sample_rate))
    hop = int(round(EXAMPLE_HOP_SECONDS * features_sample_rate))
    examples = frame(log_mel, window_length=window, hop_length=hop)
    return np.ascontiguousarray(examples, dtype=np.float32)[..., None]


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """16-bit PCM WAV -> (samples in [-1, 1] float64, (n,) or (n, ch);
    rate), the reference's ``sf.read(dtype='int16') / 32768.0``
    (vggish_input.py:91-94); any other sample width raises."""
    with wave_module.open(path, "rb") as w:
        n_channels = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width != 2:
        raise ValueError(f"Bad sample type: {8 * width}-bit PCM in {path}; "
                         "expected 16-bit (vggish_input.py:92-93)")
    data = np.frombuffer(raw, dtype="<i2").astype(np.float64) / 32768.0
    if n_channels > 1:
        data = data.reshape(-1, n_channels)
    return data, rate


def chunk_waveform(data: np.ndarray, sample_rate: int) -> np.ndarray:
    """Mono-mix, resample to 16 kHz and slice into per-example chunks:
    (num_examples, 15600) float32, the host's part of the device frontend.
    Audio holding at least one example gives the example count of
    :func:`waveform_to_examples`; shorter audio gives (0, 15600) where the
    host frontend gives 0 examples or raises."""
    data = np.asarray(_mono_16k(data, sample_rate), dtype=np.float32)
    if len(data) < EXAMPLE_CHUNK_SAMPLES:
        return np.zeros((0, EXAMPLE_CHUNK_SAMPLES), dtype=np.float32)
    return np.ascontiguousarray(
        frame(data, EXAMPLE_CHUNK_SAMPLES, EXAMPLE_HOP_SAMPLES))


def mel_matrix() -> np.ndarray:
    """The (257, 64) filterbank of the 512-point rFFT at 16 kHz."""
    return spectrogram_to_mel_matrix(
        num_mel_bins=NUM_MEL_BINS, num_spectrogram_bins=_FFT_LENGTH // 2 + 1,
        audio_sample_rate=SAMPLE_RATE, lower_edge_hertz=MEL_MIN_HZ,
        upper_edge_hertz=MEL_MAX_HZ)


def logmel_examples(chunks: torch.Tensor) -> torch.Tensor:
    """(B, 15600) float32 waveform chunks -> (B, 96, 64, 1) float32 log-mel
    examples on the chunks' device (``logmel_examples_jnp`` of the JAX
    package): the framing gather, the periodic Hann window, the 512-point
    rFFT magnitude, the float32 mel matmul and ``log(mel + 0.01)``."""
    dev = chunks.device
    idx = (torch.arange(_EXAMPLE_FRAMES, device=dev)[:, None] * _HOP
           + torch.arange(_WINDOW, device=dev)[None, :])       # (96, 400)
    window = torch.from_numpy(periodic_hann(_WINDOW).astype(np.float32))
    frames = chunks.float()[:, idx] * window.to(dev)           # (B, 96, 400)
    mag = torch.fft.rfft(frames, n=_FFT_LENGTH).abs()          # (B, 96, 257)
    mel = mag @ torch.from_numpy(mel_matrix().astype(np.float32)).to(dev)
    return torch.log(mel + LOG_OFFSET)[..., None]
