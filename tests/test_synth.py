"""Synthetic phoneme-controlled speech tests (Piper-experiment equivalent)."""

import numpy as np
import pytest

from whisper_ipa.data.synth import (
    SAMPLE_RATE,
    pronunciation_variants,
    synthesize_ipa,
    synthesize_phone,
    synthesize_phonemes,
)


class TestSynth:
    def test_basic_waveform(self):
        audio = synthesize_ipa("kæt")
        assert audio.dtype == np.float32
        assert len(audio) > 0
        assert np.max(np.abs(audio)) <= 1.0
        assert np.isfinite(audio).all()

    def test_long_vowel_longer(self):
        short = synthesize_phone("a")
        long = synthesize_phone("aː")
        assert len(long) > len(short) * 1.5

    def test_deterministic(self):
        a = synthesize_ipa("ʃip", seed=3)
        b = synthesize_ipa("ʃip", seed=3)
        np.testing.assert_array_equal(a, b)

    def test_fricative_vs_vowel_spectra_differ(self):
        """s-noise must concentrate energy higher than the vowel a."""
        s = synthesize_phone("s", duration=0.4)
        a = synthesize_phone("a", duration=0.4)

        def centroid(x):
            spec = np.abs(np.fft.rfft(x)) ** 2
            freqs = np.fft.rfftfreq(len(x), 1 / SAMPLE_RATE)
            return (freqs * spec).sum() / spec.sum()

        assert centroid(s) > centroid(a) + 1500

    def test_pronunciation_variants(self):
        orig, variant, phones, subs = pronunciation_variants(
            "bʌɾəɹ", {"ɾ": "t"}
        )
        assert phones != subs
        assert "t" in subs and "ɾ" not in subs
        assert len(orig) > 0 and len(variant) > 0
        # stop closure makes the variant quieter in the middle segment
        assert not np.array_equal(orig[: len(variant)], variant[: len(orig)])

    def test_empty(self):
        assert len(synthesize_phonemes([])) == 0

    def test_mel_pipeline_integration(self):
        """Synth audio flows through the mel frontend."""
        from whisper_ipa.audio import log_mel_spectrogram, pad_or_trim

        audio = pad_or_trim(synthesize_ipa("kæt siː ʃuː"))
        mel = log_mel_spectrogram(audio)
        assert mel.shape == (3000, 80)
        assert np.isfinite(mel).all()
