"""Medusa-style draft heads: exactness, training, persistence.

Exactness never depends on head quality (verification only accepts the
target's own greedy tokens), so the parity test uses fresh heads; the
training test closes the loop — heads trained on the model's OWN greedy
outputs must raise the measured acceptance rate.
"""

from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from whisper_ipa.config import CONFIGS
from whisper_ipa.decode import DecodingOptions, decode
from whisper_ipa.decode.speculative import speculative_decode
from whisper_ipa.models import init_params
from whisper_ipa.models.medusa import (
    init_medusa_params,
    load_medusa,
    medusa_losses,
    save_medusa,
    train_medusa_step,
)
from whisper_ipa.tokenizer import get_tokenizer

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)
OPTS = DecodingOptions(language="en", without_timestamps=True, sample_len=8)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, seed=0)


@pytest.fixture(scope="module")
def tok():
    return get_tokenizer(multilingual=True, language="en")


@pytest.fixture(scope="module")
def mel():
    rng = np.random.default_rng(0)
    return jnp.asarray(
        rng.standard_normal((2, 64, CFG.n_mels)).astype(np.float32)
    )


def test_medusa_exact_greedy_parity(params, tok, mel):
    mp = init_medusa_params(CFG, n_heads=3, seed=1)
    plain = decode(params, CFG, mel, OPTS, tokenizer=tok)
    spec, stats = speculative_decode(
        params, CFG, None, None, mel, OPTS,
        tokenizer=tok, medusa_params=mp, return_stats=True,
    )
    assert [r.tokens for r in spec] == [r.tokens for r in plain]
    assert stats.draft_k == 3
    assert stats.tokens_per_round >= 1.0


def test_medusa_training_improves_acceptance(params, tok, mel):
    """Heads trained on the model's own greedy outputs accept more."""
    import optax

    from whisper_ipa.models.whisper import decoder_hidden, encode

    mp = init_medusa_params(CFG, n_heads=2, seed=2)
    _, before = speculative_decode(
        params, CFG, None, None, mel, OPTS,
        tokenizer=tok, medusa_params=mp, return_stats=True,
    )

    # training data: the model's own greedy continuations (teacher-forced)
    plain = decode(params, CFG, mel, OPTS, tokenizer=tok)
    prefix = [tok.sot, tok.language_token("en"),
              tok.transcribe, tok.no_timestamps]
    rows = []
    for r in plain:
        rows.append(prefix + r.tokens + [tok.eot])
    width = max(len(r) for r in rows)
    tokens = jnp.asarray(
        [r + [tok.eot] * (width - len(r)) for r in rows], jnp.int32
    )
    feats = jax.jit(
        lambda p, m: encode(p, CFG, m)
    )(params, mel)
    hidden = jax.jit(
        lambda p, t, f: decoder_hidden(p, CFG, t, f)
    )(params, tokens, feats)

    tx = optax.adam(2e-2)
    opt_state = tx.init(mp)
    loss0 = None
    step = jax.jit(
        lambda mp, os, h, t: train_medusa_step(
            mp, os, tx, params, CFG, h, t, tok.eot
        )
    )
    for i in range(60):
        mp, opt_state, loss = step(mp, opt_state, hidden, tokens)
        if loss0 is None:
            loss0 = float(loss)
    assert float(loss) < loss0, (float(loss), loss0)

    out, after = speculative_decode(
        params, CFG, None, None, mel, OPTS,
        tokenizer=tok, medusa_params=mp, return_stats=True,
    )
    # exactness holds regardless of training
    assert [r.tokens for r in out] == [r.tokens for r in plain]
    assert after.tokens_per_round >= before.tokens_per_round


def test_medusa_save_load_roundtrip(tmp_path):
    mp = init_medusa_params(CFG, n_heads=2, seed=3)
    path = str(tmp_path / "medusa.safetensors")
    save_medusa(path, mp)
    got = load_medusa(path)
    for a, b in zip(mp["heads"], got["heads"]):
        for k in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(
                np.asarray(a[k]), np.asarray(b[k]), rtol=0, atol=0
            )


def test_train_medusa_cli_end_to_end(tmp_path):
    """Producer -> consumer loop: the training CLI writes heads that
    speculative_decode loads and uses with exact greedy parity."""
    import json
    import wave

    from whisper_ipa.cli.train_medusa import main as train_main

    entries = []
    for i in range(2):
        path = str(tmp_path / f"a{i}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            t = np.linspace(0, 1, 16000)
            w.writeframes(
                (np.sin(2 * np.pi * (200 + 80 * i) * t) * 8000)
                .astype(np.int16)
                .tobytes()
            )
        entries.append(
            {"audio_path": path, "ipa_transcription": ["kæt", "siː"][i]}
        )
    jp = str(tmp_path / "train.json")
    with open(jp, "w") as f:
        json.dump(entries, f, ensure_ascii=False)
    out = str(tmp_path / "heads.safetensors")
    train_main(
        ["--model", "test-tiny", "--train-data", jp, "--steps", "2",
         "--batch-size", "2", "--n-heads", "2", "--output", out,
         "--log-every", "1"]
    )
    mp = load_medusa(out)
    assert len(mp["heads"]) == 2


def test_valid_target_mask_includes_first_eot():
    """Regression (r3 advisor): the first EOT is a valid target — heads
    must learn to PREDICT end-of-sequence; only padding past it is
    masked out of the loss."""
    import jax.numpy as jnp

    from whisper_ipa.models.medusa import valid_target_mask

    eot = 99
    tokens = jnp.asarray(
        [
            [5, 7, eot, eot, eot],  # content, first EOT valid, pad masked
            [eot, eot, eot, eot, eot],  # empty: only the first EOT valid
            [1, 2, 3, 4, 5],  # no EOT: everything valid
        ],
        jnp.int32,
    )
    mask = valid_target_mask(tokens, eot)
    assert mask.tolist() == [
        [True, True, True, False, False],
        [True, False, False, False, False],
        [True, True, True, True, True],
    ]


def test_train_medusa_steps_per_call_equivalent(tmp_path):
    """--steps-per-call 2 draws the same batch sequence and runs the
    same step math as sequential: saved heads must match."""
    import json

    from whisper_ipa.audio import write_wav
    from whisper_ipa.cli.train_medusa import main as train_main
    from whisper_ipa.data.synth import synthesize_ipa

    entries = []
    for i, ipa in enumerate(["ka", "ti"]):
        path = str(tmp_path / f"b{i}.wav")
        write_wav(path, synthesize_ipa(ipa, seed=i))
        entries.append({"audio_path": path, "ipa_transcription": ipa})
    jp = str(tmp_path / "train.json")
    with open(jp, "w") as f:
        json.dump(entries, f, ensure_ascii=False)

    outs = {}
    for spc in (1, 2):
        out = str(tmp_path / f"heads{spc}.safetensors")
        train_main(
            ["--model", "test-tiny", "--train-data", jp, "--steps", "2",
             "--batch-size", "2", "--n-heads", "2", "--output", out,
             "--log-every", "1", "--steps-per-call", str(spc)]
        )
        outs[spc] = load_medusa(out)
    for h1, h2 in zip(outs[1]["heads"], outs[2]["heads"]):
        for k in h1:
            np.testing.assert_allclose(
                np.asarray(h1[k]), np.asarray(h2[k]), atol=2e-6,
                err_msg=f"head param {k} diverged under steps_per_call",
            )


def test_medusa_chunk_program_embeds_no_weight_constants(params):
    """The jitted train chunk must take the frozen base params as
    ARGUMENTS — closing over them embeds the whole model as constants in
    the lowered module (28.8 MB even at test-tiny scale, ~1 GB for
    whisper-small). Pin the contract by bounding the lowered program
    size."""
    import optax

    from whisper_ipa.models.whisper import decoder_hidden, encode

    medusa = init_medusa_params(CFG, n_heads=2, seed=0)
    tx = optax.adam(1e-3)
    opt_state = tx.init(medusa)
    eot = 99

    def chunk_steps(fp, mp, os_, mels, toks):
        def body(carry, xs):
            mp, os_ = carry
            mel_i, tok_i = xs
            h = decoder_hidden(
                fp, CFG, tok_i,
                encode(fp, CFG, mel_i, dtype=jnp.bfloat16),
                dtype=jnp.bfloat16,
            )
            mp, os_, loss = train_medusa_step(
                mp, os_, tx, fp, CFG, h, tok_i, eot
            )
            return (mp, os_), loss

        (mp, os_), losses = jax.lax.scan(body, (mp, os_), (mels, toks))
        return mp, os_, losses

    mels = jnp.zeros((2, 2, CFG.n_audio_ctx * 2, CFG.n_mels), jnp.bfloat16)
    toks = jnp.zeros((2, 2, 8), jnp.int32)
    lowered = jax.jit(chunk_steps).lower(
        params, medusa, opt_state, mels, toks
    )
    size = len(lowered.as_text())
    assert size < 2_000_000, (
        f"lowered medusa chunk program is {size / 1e6:.1f} MB — weight "
        "constants are being embedded again (pass params as jit args)"
    )
