"""The full-loop capability test: train until the model transcribes.

Overfits a micro Whisper on ONE synthetic utterance and asserts greedy
decoding recovers the exact IPA string. This exercises every layer of the
framework together — formant synthesis, mel frontend, encoder, teacher-
forced loss with the EOT mask, AdamW, KV-cached greedy decode, tokenizer
round-trip — and fails if any of them is subtly wrong.
"""

from dataclasses import replace

import numpy as np
import pytest

import jax.numpy as jnp

from whisper_ipa.audio import log_mel_spectrogram
from whisper_ipa.config import CONFIGS
from whisper_ipa.data.synth import synthesize_ipa
from whisper_ipa.decode import DecodingOptions, decode
from whisper_ipa.models import init_params
from whisper_ipa.tokenizer import get_tokenizer
from whisper_ipa.train import create_train_state, train_step

CFG = replace(
    CONFIGS["test-tiny"],
    n_audio_state=64,
    n_audio_head=2,
    n_audio_layer=2,
    n_text_state=64,
    n_text_head=2,
    n_text_layer=2,
    n_audio_ctx=64,  # 1.28 s audio window
    n_text_ctx=32,
)
WINDOW_SAMPLES = CFG.n_audio_ctx * 2 * 160  # mel frames = 2*ctx, hop 160


@pytest.mark.slow
def test_overfit_one_utterance_then_transcribe():
    ipa = "kæt"
    tok = get_tokenizer(multilingual=True, language="en")

    audio = synthesize_ipa(ipa, seed=0)
    padded = np.zeros(WINDOW_SAMPLES, np.float32)
    padded[: len(audio)] = audio[:WINDOW_SAMPLES]
    mel = jnp.asarray(log_mel_spectrogram(padded, n_mels=CFG.n_mels))[None]

    seq = list(tok.sot_sequence_including_notimestamps)
    seq += tok.encode(ipa)
    seq.append(tok.eot)
    tokens = jnp.asarray([seq], jnp.int32)

    params = init_params(CFG, seed=0)
    # encoder UNFROZEN: random encoder features carry no information about
    # the audio otherwise; full fine-tune is the capability under test here
    state, tx = create_train_state(
        params, learning_rate=3e-3, freeze_encoder=False
    )

    eot = tok.eot
    losses = []
    decoded = None
    for step in range(400):
        state, loss = train_step(
            state, mel, tokens, CFG, tx, eot, freeze_encoder=False
        )
        if step % 50 == 49:
            losses.append(float(loss))
            result = decode(
                state.params,
                CFG,
                mel,
                DecodingOptions(
                    language="en",
                    without_timestamps=True,
                    sample_len=len(seq),
                ),
                tokenizer=tok,
            )[0]
            decoded = result.text.strip()
            if decoded == ipa and float(loss) < 0.1:
                break

    assert decoded == ipa, (
        f"model failed to learn the utterance: got {decoded!r}, "
        f"losses {losses}"
    )
    assert losses[-1] < 0.5, f"loss stayed high: {losses}"
