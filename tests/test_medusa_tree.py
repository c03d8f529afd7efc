"""Tree-structured Medusa verification (decode/medusa_tree.py).

The load-bearing invariant: for ANY head parameters and ANY tree
template, the emitted tokens are exactly the plain greedy decode — the
tree changes only how many forwards are spent.
"""

from dataclasses import replace

import numpy as np
import pytest

import jax.numpy as jnp

from whisper_ipa.config import CONFIGS
from whisper_ipa.decode import DecodingOptions, decode
from whisper_ipa.decode.medusa_tree import (
    DEFAULT_TREE,
    _tree_tables,
    medusa_tree_decode,
)
from whisper_ipa.models import init_params
from whisper_ipa.models.medusa import init_medusa_params
from whisper_ipa.tokenizer import get_tokenizer

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=64)


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


class TestTreeTables:
    def test_default_tree(self):
        depth, parent, cand, anc, max_c, K = _tree_tables(DEFAULT_TREE)
        assert K == 4 and max_c == 3 and len(depth) == 9
        # node 8 (depth 4) descends 6 <- 3 <- 0
        assert list(np.nonzero(anc[8])[0]) == [0, 3, 6, 8]
        # ancestors carry strictly increasing depth along the chain
        assert depth[0] == 1 and depth[3] == 2 and depth[6] == 3

    def test_rejects_parent_after_child(self):
        with pytest.raises(AssertionError):
            _tree_tables(((0, 0), (-1, 0)))


class TestOptimizeTree:
    def test_picks_highest_probability_paths(self):
        from whisper_ipa.decode.medusa_tree import optimize_tree

        # head 0 strong with two good candidates; head 1 weaker;
        # head 2 weak — the 5-node optimum: both depth-1 candidates,
        # their best children, and the best depth-3 path
        probs = [[0.8, 0.5, 0.01], [0.6, 0.1, 0.01], [0.3, 0.01, 0.01]]
        tree = optimize_tree(probs, 5)
        assert len(tree) == 5
        depth, parent, cand, anc, max_c, K = _tree_tables(tree)
        # path probs: (0,)=0.8, (1,)=0.5, (0,0)=0.48, (1,0)=0.30,
        # (0,1)=0.08, (0,0,0)=0.144 -> top5 includes (0,0,0) over (0,1)
        paths = set()
        for i in range(len(tree)):
            path = []
            j = i
            while j >= 0:
                path.append(int(cand[j]))
                j = int(parent[j])
            paths.add(tuple(reversed(path)))
        assert paths == {(0,), (1,), (0, 0), (1, 0), (0, 0, 0)}

    def test_prefix_closure(self):
        from whisper_ipa.decode.medusa_tree import optimize_tree

        rng = np.random.default_rng(0)
        probs = rng.uniform(0.05, 0.9, size=(4, 3))
        tree = optimize_tree(probs, 10)
        # every parent index precedes its child (required by the tables)
        _tree_tables(tree)  # raises if not

    def test_tree_for_heads_sidecar(self, tmp_path):
        import json

        from whisper_ipa.decode.medusa_tree import tree_for_heads

        weights = str(tmp_path / "heads.safetensors")
        assert tree_for_heads(weights) == DEFAULT_TREE  # no sidecar
        with open(weights + ".accuracy.json", "w") as f:
            json.dump(
                {"head_topk_accuracy": [[0.9, 0.2], [0.5, 0.1]]}, f
            )
        tree = tree_for_heads(weights, n_nodes=4)
        assert len(tree) == 4
        assert tree[0] == (-1, 0)  # best path first


class TestTreeParity:
    def _greedy(self, params, mel, tok, opts):
        return [
            r.tokens for r in decode(params, CFG, mel, opts, tokenizer=tok)
        ]

    def test_random_heads_match_greedy(self, params, mel, tok):
        """Near-zero acceptance: every round emits >= 1 correct token."""
        heads = init_medusa_params(CFG, n_heads=4, seed=3)
        # perturb: zero-init heads mimic the base LM head; random w2
        # makes the proposals genuinely wrong
        import jax

        heads = jax.tree.map(
            lambda x: x + 0.1 * jax.random.normal(
                jax.random.PRNGKey(7), x.shape, x.dtype
            ),
            heads,
        )
        opts = DecodingOptions(
            language="en", without_timestamps=True, sample_len=10
        )
        ref = self._greedy(params, mel, tok, opts)
        out, stats = medusa_tree_decode(
            params, CFG, heads, mel, opts, tokenizer=tok, return_stats=True
        )
        assert [r.tokens for r in out] == ref
        assert stats.tokens_per_round >= 1.0

    def test_zero_init_heads_match_greedy(self, params, mel, tok):
        """Zero-init heads propose like the base LM head — acceptance is
        incidental but parity must be exact, including EOT handling."""
        heads = init_medusa_params(CFG, n_heads=4, seed=0)
        opts = DecodingOptions(
            language="en", without_timestamps=True, sample_len=12
        )
        ref = self._greedy(params, mel, tok, opts)
        out = medusa_tree_decode(
            params, CFG, heads, mel, opts, tokenizer=tok
        )
        assert [r.tokens for r in out] == ref

    def test_int8_kv_and_custom_tree(self, params, mel, tok):
        heads = init_medusa_params(CFG, n_heads=2, seed=1)
        tree = ((-1, 0), (-1, 1), (0, 0))  # depth 2, 3 nodes
        opts = DecodingOptions(
            language="en", without_timestamps=True, sample_len=8,
            kv_int8=True,
        )
        ref = self._greedy(params, mel, tok, opts)
        out = medusa_tree_decode(
            params, CFG, heads, mel, opts, tree=tree, tokenizer=tok
        )
        assert [r.tokens for r in out] == ref

    def test_tree_deeper_than_heads_rejected(self, params, mel, tok):
        heads = init_medusa_params(CFG, n_heads=2, seed=0)
        with pytest.raises(ValueError):
            medusa_tree_decode(
                params, CFG, heads, jnp.zeros((1, 64, CFG.n_mels)),
                DecodingOptions(
                    language="en", without_timestamps=True, sample_len=4
                ),
                tokenizer=tok,
            )
