"""Audio frontend tests: IO round-trips and mel numerical equivalence."""

import numpy as np
import pytest

from whisper_ipa.audio import (
    N_FRAMES,
    N_SAMPLES,
    SAMPLE_RATE,
    load_audio,
    log_mel_spectrogram,
    log_mel_spectrogram_jax,
    mel_filters,
    pad_or_trim,
    resample,
    write_wav,
)


def sine_audio(seconds=2.0, freq=440.0, sr=SAMPLE_RATE):
    t = np.arange(int(seconds * sr)) / sr
    return (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


class TestIO:
    def test_wav_roundtrip(self, tmp_path):
        audio = sine_audio(1.0)
        path = str(tmp_path / "a.wav")
        write_wav(path, audio)
        loaded = load_audio(path)
        assert loaded.shape == audio.shape
        assert np.max(np.abs(loaded - audio)) < 1e-3

    def test_resample_preserves_duration(self):
        audio = sine_audio(1.0, sr=44100)
        out = resample(audio, 44100, 16000)
        assert abs(len(out) - 16000) <= 1

    def test_load_resamples(self, tmp_path):
        audio = sine_audio(1.0, sr=8000)
        path = str(tmp_path / "b.wav")
        write_wav(path, audio, sr=8000)
        loaded = load_audio(path)
        assert abs(len(loaded) - SAMPLE_RATE) <= 1

    def test_pad_or_trim(self):
        short = np.ones(100, dtype=np.float32)
        assert pad_or_trim(short).shape == (N_SAMPLES,)
        long = np.ones(N_SAMPLES + 5, dtype=np.float32)
        assert pad_or_trim(long).shape == (N_SAMPLES,)
        assert pad_or_trim(short)[100:].sum() == 0.0


class TestMelFilters:
    @pytest.mark.parametrize("n_mels", [80, 128])
    def test_shape(self, n_mels):
        fb = mel_filters(n_mels)
        assert fb.shape == (n_mels, 201)

    def test_nonnegative_and_sparse(self):
        fb = mel_filters(80)
        assert fb.min() >= 0.0
        # each filter is a narrow triangle: most entries zero
        assert (fb > 0).sum() < fb.size * 0.2

    def test_every_filter_nonzero(self):
        fb = mel_filters(80)
        assert (fb.sum(axis=1) > 0).all()

    def test_slaney_normalization_decreasing_peaks(self):
        fb = mel_filters(80)
        peaks = fb.max(axis=1)
        # Slaney area-normalization: high-frequency (wider) filters have
        # lower peaks
        assert peaks[0] > peaks[-1]


class TestLogMel:
    def test_shape_30s(self):
        audio = pad_or_trim(sine_audio(2.0))
        mel = log_mel_spectrogram(audio, n_mels=80)
        assert mel.shape == (N_FRAMES, 80)

    def test_range_compressed(self):
        audio = pad_or_trim(sine_audio(2.0))
        mel = log_mel_spectrogram(audio)
        # (log10 + 4)/4 with 8-decade dynamic range => span <= 2
        assert mel.max() - mel.min() <= 2.0 + 1e-6

    def test_tone_concentrates_energy(self):
        # 440 Hz tone: energy in a low mel bin, not in the top bins
        audio = pad_or_trim(sine_audio(30.0, freq=440.0))
        mel = log_mel_spectrogram(audio)
        hot = mel[100].argmax()
        assert hot < 30

    @pytest.mark.parametrize("n_mels", [80, 128])
    def test_jax_matches_numpy(self, n_mels):
        audio = pad_or_trim(
            sine_audio(3.0, freq=220.0)
            + 0.1 * np.random.default_rng(0).standard_normal(3 * SAMPLE_RATE)
            .astype(np.float32)
        )
        ref = log_mel_spectrogram(audio, n_mels=n_mels)
        out = np.asarray(log_mel_spectrogram_jax(audio, n_mels=n_mels))
        assert out.shape == ref.shape
        assert np.max(np.abs(out - ref)) < 5e-4

    def test_jax_batched(self):
        rng = np.random.default_rng(1)
        batch = rng.standard_normal((2, N_SAMPLES)).astype(np.float32) * 0.1
        out = np.asarray(log_mel_spectrogram_jax(batch, n_mels=80))
        assert out.shape == (2, N_FRAMES, 80)
        single = np.asarray(log_mel_spectrogram_jax(batch[0], n_mels=80))
        assert np.max(np.abs(out[0] - single)) < 1e-5


class TestNativeDecoder:
    def test_native_matches_python(self, tmp_path):
        native = pytest.importorskip("whisper_ipa.audio.native")
        audio = sine_audio(0.5)
        path = str(tmp_path / "n.wav")
        write_wav(path, audio)
        out = native.decode_wav_file(path, 16000)
        assert out.shape == audio.shape
        assert np.max(np.abs(out - audio)) < 1e-3

    def test_native_resamples(self, tmp_path):
        native = pytest.importorskip("whisper_ipa.audio.native")
        audio = sine_audio(1.0, freq=220.0, sr=8000)
        path = str(tmp_path / "n8.wav")
        write_wav(path, audio, sr=8000)
        out = native.decode_wav_file(path, 16000)
        assert abs(len(out) - 16000) <= 2
        # tone frequency preserved: spectral peak at 220 Hz
        spec = np.abs(np.fft.rfft(out * np.hanning(len(out))))
        peak_hz = np.argmax(spec) * 16000 / len(out)
        assert abs(peak_hz - 220.0) < 5.0

    def test_native_downsample(self, tmp_path):
        native = pytest.importorskip("whisper_ipa.audio.native")
        audio = sine_audio(0.5, freq=440.0, sr=44100)
        path = str(tmp_path / "n44.wav")
        write_wav(path, audio, sr=44100)
        out = native.decode_wav_file(path, 16000)
        assert abs(len(out) - 8000) <= 3
        # compare against the pure-Python path (scipy polyphase) explicitly
        from whisper_ipa.audio.io import _decode_wav, resample as _rs

        data, orig_sr = _decode_wav(path)
        ref = _rs(data, orig_sr, 16000)
        n = min(len(out), len(ref))
        # same signal up to filter differences
        corr = np.corrcoef(out[:n], ref[:n])[0, 1]
        assert corr > 0.98

    def test_malformed_rejected(self):
        native = pytest.importorskip("whisper_ipa.audio.native")
        with pytest.raises(ValueError):
            native.decode_wav_bytes(b"not a wav at all")
