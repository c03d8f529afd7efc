"""Speculative decoding tests.

The load-bearing invariant: at temperature 0, speculative_decode emits
EXACTLY the target model's own greedy tokens, for ANY draft model — the
draft only changes how many verification rounds are needed. Both ends of
the acceptance spectrum are exercised: an unrelated random draft (near-zero
acceptance) and the target model drafting for itself (full acceptance).
"""

from dataclasses import replace

import numpy as np
import pytest

import jax.numpy as jnp

from whisper_ipa.config import CONFIGS
from whisper_ipa.decode import DecodingOptions, decode
from whisper_ipa.decode.speculative import speculative_decode
from whisper_ipa.models import init_params
from whisper_ipa.tokenizer import get_tokenizer

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
N_MEL_FRAMES = CFG.n_audio_ctx * 2


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, seed=0)


@pytest.fixture(scope="module")
def draft_params():
    return init_params(CFG, seed=7)


@pytest.fixture(scope="module")
def mel():
    rng = np.random.default_rng(3)
    return jnp.asarray(
        rng.standard_normal((3, N_MEL_FRAMES, CFG.n_mels)).astype(np.float32)
    )


@pytest.fixture(scope="module")
def tok():
    return get_tokenizer(multilingual=True, language="en")


OPTIONS = DecodingOptions(
    language="en", without_timestamps=True, sample_len=12
)


class TestExactness:
    def test_matches_greedy_with_unrelated_draft(
        self, params, draft_params, mel, tok
    ):
        ref = decode(params, CFG, mel, OPTIONS, tokenizer=tok)
        out, stats = speculative_decode(
            params,
            CFG,
            draft_params,
            CFG,
            mel,
            OPTIONS,
            draft_k=3,
            tokenizer=tok,
            return_stats=True,
        )
        assert [r.tokens for r in out] == [r.tokens for r in ref]
        assert [r.text for r in out] == [r.text for r in ref]
        for a, b in zip(out, ref):
            assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=1e-3)
            assert a.no_speech_prob == pytest.approx(
                b.no_speech_prob, abs=1e-5
            )
        # a random unrelated draft still advances >= 1 token per round
        assert stats.tokens_per_round >= 1.0

    def test_self_draft_full_acceptance(self, params, mel, tok):
        ref = decode(params, CFG, mel, OPTIONS, tokenizer=tok)
        out, stats = speculative_decode(
            params,
            CFG,
            params,
            CFG,
            mel,
            OPTIONS,
            draft_k=3,
            tokenizer=tok,
            return_stats=True,
        )
        assert [r.tokens for r in out] == [r.tokens for r in ref]
        # drafting with the target itself accepts every proposal: each
        # round advances K+1 slots, so 12 sampled tokens need at most
        # ceil(12 / 4) = 3 rounds (early EOT can only reduce this)
        assert stats.rounds <= 3
        assert stats.tokens_per_round > 2.0

    def test_k1_and_large_k(self, params, draft_params, mel, tok):
        ref = decode(params, CFG, mel, OPTIONS, tokenizer=tok)
        for k in (1, 8):
            out = speculative_decode(
                params, CFG, draft_params, CFG, mel, OPTIONS,
                draft_k=k, tokenizer=tok,
            )
            assert [r.tokens for r in out] == [r.tokens for r in ref]


class TestValidation:
    def test_rejects_sampling(self, params, draft_params, mel):
        with pytest.raises(ValueError):
            speculative_decode(
                params, CFG, draft_params, CFG, mel,
                replace(OPTIONS, temperature=0.5),
            )

    def test_rejects_timestamps(self, params, draft_params, mel):
        with pytest.raises(ValueError):
            speculative_decode(
                params, CFG, draft_params, CFG, mel,
                replace(OPTIONS, without_timestamps=False),
            )

    def test_rejects_beam(self, params, draft_params, mel):
        with pytest.raises(ValueError):
            speculative_decode(
                params, CFG, draft_params, CFG, mel,
                replace(OPTIONS, beam_size=2),
            )


class TestMultiposStep:
    def test_multipos_matches_scalar_pos(self, params):
        """decode_step_multipos with equal positions == decode_step."""
        import jax

        from whisper_ipa.models.whisper import (
            decode_step,
            decode_step_multipos,
            encode,
            init_cache,
        )

        rng = np.random.default_rng(0)
        mel = jnp.asarray(
            rng.standard_normal((2, N_MEL_FRAMES, CFG.n_mels)).astype(
                np.float32
            )
        )
        feats = jax.jit(encode, static_argnames=("cfg",))(params, CFG, mel)
        cache_a = init_cache(params, CFG, feats, max_len=16)
        cache_b = init_cache(params, CFG, feats, max_len=16)
        toks = jnp.asarray([[50258, 50259], [50258, 50259]], jnp.int32)

        la, cache_a = decode_step(params, CFG, toks, cache_a, 0)
        lb, cache_b = decode_step_multipos(
            params, CFG, toks, cache_b, jnp.zeros((2,), jnp.int32)
        )
        np.testing.assert_allclose(la, lb, rtol=0, atol=1e-4)

        nxt = jnp.asarray([[100], [200]], jnp.int32)
        la, _ = decode_step(params, CFG, nxt, cache_a, 2)
        lb, _ = decode_step_multipos(
            params, CFG, nxt, cache_b, jnp.full((2,), 2, jnp.int32)
        )
        np.testing.assert_allclose(la, lb, rtol=0, atol=1e-4)

    def test_multipos_diverged_positions(self, params):
        """Per-element positions: each element must see only its own
        prefix — verified against two independent scalar-pos decodes."""
        import jax

        from whisper_ipa.models.whisper import (
            decode_step,
            decode_step_multipos,
            encode,
            init_cache,
        )

        rng = np.random.default_rng(1)
        mel = jnp.asarray(
            rng.standard_normal((2, N_MEL_FRAMES, CFG.n_mels)).astype(
                np.float32
            )
        )
        feats = jax.jit(encode, static_argnames=("cfg",))(params, CFG, mel)

        # element 0 consumed 3 tokens, element 1 consumed 2
        pre0 = jnp.asarray([[50258, 50259, 100]], jnp.int32)
        pre1 = jnp.asarray([[50258, 50259]], jnp.int32)

        c0 = init_cache(params, CFG, feats[:1], max_len=16)
        c1 = init_cache(params, CFG, feats[1:], max_len=16)
        _, c0 = decode_step(params, CFG, pre0, c0, 0)
        _, c1 = decode_step(params, CFG, pre1, c1, 0)
        ref0, _ = decode_step(
            params, CFG, jnp.asarray([[300]], jnp.int32), c0, 3
        )
        ref1, _ = decode_step(
            params, CFG, jnp.asarray([[300]], jnp.int32), c1, 2
        )

        cb = init_cache(params, CFG, feats, max_len=16)
        # consume both prefixes in one batched multipos call by feeding the
        # shared 2-token prefix, then element 0's extra token alone
        _, cb = decode_step(
            params, CFG, jnp.tile(pre1, (2, 1)), cb, 0
        )
        _, cb = decode_step_multipos(
            params,
            CFG,
            jnp.asarray([[100], [50259]], jnp.int32),
            cb,
            jnp.asarray([2, 1], jnp.int32),  # elt1 rewrites its last token
        )
        lb, _ = decode_step_multipos(
            params,
            CFG,
            jnp.asarray([[300], [300]], jnp.int32),
            cb,
            jnp.asarray([3, 2], jnp.int32),
        )
        np.testing.assert_allclose(lb[0], ref0[0], rtol=0, atol=1e-4)
        np.testing.assert_allclose(lb[1], ref1[0], rtol=0, atol=1e-4)


class TestNgramDraft:
    def test_matches_greedy(self, params, mel, tok):
        ref = decode(params, CFG, mel, OPTIONS, tokenizer=tok)
        out, stats = speculative_decode(
            params, CFG, None, None, mel, OPTIONS,
            draft_k=3, tokenizer=tok, return_stats=True,
        )
        assert [r.tokens for r in out] == [r.tokens for r in ref]
        assert [r.text for r in out] == [r.text for r in ref]
        assert stats.tokens_per_round >= 1.0

    def test_repetitive_output_accelerates(self, params, tok):
        """Random-weight models emit repetitive sequences; the bigram
        lookup must accept at least some continuations on them."""
        rng = np.random.default_rng(11)
        mel_b = jnp.asarray(
            rng.standard_normal((6, N_MEL_FRAMES, CFG.n_mels)).astype(
                np.float32
            )
        )
        opts = replace(OPTIONS, sample_len=16)
        ref = decode(params, CFG, mel_b, opts, tokenizer=tok)
        out, stats = speculative_decode(
            params, CFG, None, None, mel_b, opts,
            draft_k=4, tokenizer=tok, return_stats=True,
        )
        assert [r.tokens for r in out] == [r.tokens for r in ref]
        # at least one bigram continuation must have been accepted across
        # 6 repetitive random-weight sequences
        assert stats.tokens_per_round > 1.0

    def test_ngram_drafts_helper(self):
        from whisper_ipa.decode.speculative import _ngram_drafts

        buf = jnp.asarray(
            [
                # bigram (5, 6) last seen at j=1 -> drafts continue 7, 8, 9
                [4, 5, 6, 7, 8, 9, 5, 6, 0, 0],
                # no earlier occurrence of (2, 3): repeat last token 3
                [1, 2, 9, 9, 9, 9, 2, 3, 0, 0],
            ],
            jnp.int32,
        )
        lens = jnp.asarray([8, 8], jnp.int32)
        d = np.asarray(_ngram_drafts(buf, lens, 3))
        assert d[0].tolist() == [7, 8, 9]
        assert d[1].tolist() == [3, 3, 3]

    def test_ngram_trigram_beats_bigram(self):
        """The more specific trigram context wins over the (more recent)
        bigram match; rows without a trigram fall back to the bigram."""
        from whisper_ipa.decode.speculative import _ngram_drafts

        buf = jnp.asarray(
            [
                # suffix (1,5,6): trigram at j=0 continues with 7 even
                # though the LATEST bigram (5,6) at j=5 continues with 8
                [1, 5, 6, 7, 2, 5, 6, 8, 1, 5, 6, 0],
                # suffix (9,5,6): no trigram -> bigram (5,6) at j=1
                # continues with 4
                [3, 5, 6, 4, 2, 2, 2, 2, 9, 5, 6, 0],
            ],
            jnp.int32,
        )
        lens = jnp.asarray([11, 11], jnp.int32)
        d = np.asarray(_ngram_drafts(buf, lens, 2))
        assert d[0].tolist() == [7, 2]
        assert d[1].tolist() == [4, 2]
