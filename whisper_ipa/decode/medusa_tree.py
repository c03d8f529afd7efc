"""Tree-structured Medusa verification: many drafts, one forward.

Chain speculation (decode/speculative.py) verifies ONE candidate per
draft position; if the head's top-1 guess misses, the round ends there.
A draft TREE verifies several candidates per position at once — all
nodes ride the same (R+N)-query forward, and a few extra queries add
little to a decode-shaped forward, so tokens/round rises almost for
free.

Round anatomy (one jitted forward per round, no cache repair):
  1. RE-FEED: the last R = K+1 emitted tokens re-enter the decoder at
     their real positions. Rows already in the KV cache are rewritten
     with identical values (the engine's join trick); the tokens
     accepted LAST round get their first write. After the re-feed the
     cache is valid below ``lens`` by construction every round.
  2. TREE: N draft nodes follow. Node n holds candidate ``cand[n]`` of
     head ``depth[n]-1`` (models/medusa.py medusa_propose_topk), sits
     at position lens + depth[n] - 1 (siblings SHARE a position and are
     never written to the cache), and attends: the real re-fed context
     + its tree ancestors only.
  3. ACCEPT: walk depths greedily — the root's logits give the true
     greedy token g0; if a depth-1 node carries g0, its logits give g1;
     and so on. Emitted tokens are EXACTLY the target's greedy decode
     (each accepted node's token equals the greedy choice at its
     position; the walk ends with the greedy correction/bonus).

The tree is a static template: ``tree`` is a tuple of (parent, cand)
pairs, parent = -1 for depth-1 nodes else an index of an earlier node.
The default 9-node tree spends its nodes where acceptance decays:
3 candidates at depth 1, 3 at depth 2, 2 at depth 3, 1 at depth 4.

No counterpart exists in the reference (single-step mlx decode); the
technique follows Cai et al. 2024 (Medusa, arXiv:2401.10774), built
with static shapes, one lax.while_loop and no host round-trips.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import WhisperConfig
from ..models.whisper import decode_step_block, init_cache
from ..tokenizer import WhisperTokenizer, get_tokenizer
from .decoding import (
    DecodingOptions,
    DecodingResult,
    build_blank_mask,
    build_suppress_mask,
    compression_ratio,
    detect_language,
    initial_tokens,
)
from .speculative import SpeculativeStats

# default template: (parent, cand) per node; parent -1 = depth-1 node.
# 3 roots, then 2+1 at depth 2, 2 at depth 3, 1 at depth 4.
DEFAULT_TREE: Tuple[Tuple[int, int], ...] = (
    (-1, 0), (-1, 1), (-1, 2),      # nodes 0..2   depth 1
    (0, 0), (0, 1), (1, 0),         # nodes 3..5   depth 2
    (3, 0), (4, 0),                 # nodes 6..7   depth 3
    (6, 0),                         # node  8      depth 4
)


def optimize_tree(cand_probs, n_nodes: int) -> Tuple[Tuple[int, int], ...]:
    """Choose the expected-acceptance-maximizing static tree.

    cand_probs[k][c]: measured probability that head k's c-th candidate
    equals the greedy token at its position (cli/train_medusa writes
    these as <heads>.accuracy.json after training). The expected number
    of ACCEPTED nodes per round is the sum over nodes of their path
    probability (product of candidate probs along the path), so the
    optimal n_nodes-node tree is exactly the n_nodes highest-probability
    paths — which are closed under prefixes (a path's probability never
    exceeds its parent's), making greedy best-first expansion optimal.

    Returns a (parent, cand) template for medusa_tree_decode.
    """
    import heapq

    cand_probs = np.asarray(cand_probs, np.float64)
    K, C = cand_probs.shape
    # heap entries: (-path_prob, depth, parent_node_index, cand_index)
    heap = [
        (-cand_probs[0, c], 1, -1, c) for c in range(C)
    ]
    heapq.heapify(heap)
    tree: List[Tuple[int, int]] = []
    while heap and len(tree) < n_nodes:
        neg_p, d, parent, c = heapq.heappop(heap)
        node_id = len(tree)
        tree.append((parent, c))
        if d < K:
            for cc in range(C):
                child_p = -neg_p * cand_probs[d, cc]
                if child_p > 0:
                    heapq.heappush(heap, (-child_p, d + 1, node_id, cc))
    return tuple(tree)


def tree_for_heads(
    medusa_weights_path: str, n_nodes: int = 12
) -> Tuple[Tuple[int, int], ...]:
    """The serving-side tree choice: measured-accuracy-optimized when the
    sidecar written by cli/train_medusa exists, DEFAULT_TREE otherwise."""
    import json
    import os

    sidecar = medusa_weights_path + ".accuracy.json"
    if os.path.isfile(sidecar):
        with open(sidecar) as f:
            probs = json.load(f)["head_topk_accuracy"]
        return optimize_tree(probs, n_nodes)
    return DEFAULT_TREE


def _tree_tables(tree):
    """Static per-node tables + the ancestor mask (host-side)."""
    n = len(tree)
    depth = np.zeros(n, np.int32)
    parent = np.array([p for p, _ in tree], np.int32)
    cand = np.array([c for _, c in tree], np.int32)
    anc = np.zeros((n, n), bool)  # anc[i, j]: j is an ancestor of i (or i)
    for i, (p, _) in enumerate(tree):
        if p < 0:
            depth[i] = 1
        else:
            assert p < i, "tree nodes must come after their parents"
            depth[i] = depth[p] + 1
        anc[i, i] = True
        if p >= 0:
            anc[i] |= anc[p]
    max_c = int(cand.max()) + 1
    max_d = int(depth.max())
    return depth, parent, cand, anc, max_c, max_d


def tree_round(
    params,
    medusa_params,
    cfg: WhisperConfig,
    cache,
    tokens_buf,  # (B, buf_len): context tokens, EOT-padded past lens
    hidden_frontier,  # (B, d): hidden of the input at lens-2
    lens,  # (B,)
    suppress_mask,
    blank_mask,
    n_prefix: int,
    tree,
    dtype,
):
    """One tree verification forward + greedy acceptance walk.

    The shared core of the standalone loop (_tree_decode_jit) and the
    in-flight engine chunk (serve_continuous._spec_chunk_medusa_tree) —
    block assembly, masks, and the walk live HERE so the two callers
    cannot drift. Returns (cache, emit (B, K+1) greedy-path tokens,
    emit_lp (B, K+1) their logprobs, sel (B, K+1) block index whose
    hidden follows each emit, m (B,) matched node count, hidden
    (B, S, d) block hidden states).
    """
    from ..models.medusa import medusa_propose_topk

    depth_np, parent_np, cand_np, anc_np, max_c, K = _tree_tables(tree)
    N = len(tree)
    R = K + 2  # re-feed width: covers the K+1 max accepts + the root
    B = tokens_buf.shape[0]
    depth = jnp.asarray(depth_np)
    parent = jnp.asarray(parent_np)
    cand = jnp.asarray(cand_np)
    anc = jnp.asarray(anc_np)
    node_sl = jnp.arange(N)

    # ---- draft the tree from the frontier hidden
    topk = medusa_propose_topk(
        medusa_params, params, hidden_frontier, max_c, dtype
    )  # (B, K, C)
    node_tok = topk[:, depth - 1, :][
        :, node_sl, cand
    ]  # (B, N): candidate cand[n] of head depth[n]-1

    # ---- assemble the block: R re-fed tokens + N tree nodes
    start = jnp.maximum(lens - R, 0)  # (B,)
    refeed_pos = start[:, None] + jnp.arange(R)[None, :]  # (B, R)
    refeed_tok = jnp.take_along_axis(tokens_buf, refeed_pos, axis=1)
    node_pos = lens[:, None] + (depth - 1)[None, :]  # (B, N)
    block_tok = jnp.concatenate([refeed_tok, node_tok], axis=1)
    block_pos = jnp.concatenate([refeed_pos, node_pos], axis=1)

    # ---- in-block mask (additive): re-feed is causal over REAL entries
    # (pos < lens); tree nodes attend real re-feed + their own ancestors
    real = refeed_pos < lens[:, None]  # (B, R)
    m_rr = (
        real[:, None, :]
        & (refeed_pos[:, None, :] <= refeed_pos[:, :, None])
    )  # (B, R, R)
    m_nr = jnp.broadcast_to(real[:, None, :], (B, N, R))
    m_rn = jnp.zeros((B, R, N), bool)
    m_nn = jnp.broadcast_to(anc[None], (B, N, N))
    mask_new = jnp.where(
        jnp.concatenate(
            [
                jnp.concatenate([m_rr, m_rn], axis=2),
                jnp.concatenate([m_nr, m_nn], axis=2),
            ],
            axis=1,
        ),
        0.0,
        -jnp.inf,
    ).astype(jnp.float32)

    logits, cache, hidden = decode_step_block(
        params, cfg, block_tok, cache, block_pos, start, mask_new,
        write_len=R, dtype=dtype,
    )  # logits (B, S, V)

    # ---- greedy choice at every entry (suppress + first-token blank)
    lg = logits + suppress_mask
    lg = jnp.where(
        (block_pos + 1 == n_prefix)[..., None], lg + blank_mask, lg
    )
    greedy_all = jnp.argmax(lg, axis=-1).astype(jnp.int32)  # (B, S)
    lse = jax.nn.logsumexp(lg, axis=-1)
    lp_all = jnp.max(lg, axis=-1) - lse  # logprob of the greedy token

    # ---- walk the tree: accept nodes matching the running greedy
    root_idx = lens - 1 - start  # (B,) block index of input at lens-1
    take = lambda arr, idx: jnp.take_along_axis(
        arr, idx[:, None], axis=1
    )[:, 0]
    g = take(greedy_all, root_idx)  # g0: true greedy at position lens
    lp = take(lp_all, root_idx)
    emits = [g]
    lps = [lp]
    cur_node = jnp.full((B,), -1, jnp.int32)
    alive = jnp.ones((B,), bool)
    m = jnp.zeros((B,), jnp.int32)  # matched node count
    sel_idx = [root_idx]  # block idx whose hidden follows each emit
    for d in range(1, K + 1):
        cand_mask = (
            (depth[None, :] == d)
            & (parent[None, :] == cur_node[:, None])
            & (node_tok == g[:, None])
        )  # (B, N) — at most one True (top-k candidates are distinct)
        found = cand_mask.any(axis=1)
        idx = jnp.argmax(cand_mask, axis=1).astype(jnp.int32)
        alive = alive & found
        m = m + alive
        cur_node = jnp.where(alive, idx, cur_node)
        blk = R + idx
        g = jnp.where(alive, take(greedy_all, blk), g)
        lp = jnp.where(alive, take(lp_all, blk), lp)
        emits.append(g)
        lps.append(lp)
        sel_idx.append(jnp.where(alive, blk, sel_idx[-1]))
    emit = jnp.stack(emits, axis=1)  # (B, K+1) greedy path tokens
    emit_lp = jnp.stack(lps, axis=1)
    sel = jnp.stack(sel_idx, axis=1)  # (B, K+1)
    return cache, emit, emit_lp, sel, m, hidden


@partial(
    jax.jit,
    static_argnames=(
        "cfg",
        "eot",
        "n_prefix",
        "sample_len",
        "dtype_name",
        "sot_index",
        "cross_kv_int8",
        "cross_kv_int4",
        "tree",
    ),
)
def _tree_decode_jit(
    params,
    medusa_params,
    cfg: WhisperConfig,
    audio_features,
    prefix_tokens,  # (B, n_prefix)
    suppress_mask,
    blank_mask,
    eot: int,
    n_prefix: int,
    sample_len: int,
    dtype_name: str = "float32",
    sot_index: int = 0,
    cross_kv_int8: bool = False,
    cross_kv_int4: bool = False,
    tree: Tuple[Tuple[int, int], ...] = DEFAULT_TREE,
):
    from ..models.medusa import medusa_propose_topk
    from ..models.whisper import decode_step_multipos_hidden

    dtype = jnp.dtype(dtype_name)
    depth_np, parent_np, cand_np, anc_np, max_c, K = _tree_tables(tree)
    N = len(tree)
    R = K + 2  # re-feed width: covers the K+1 max accepts + the root
    S = R + N
    B = audio_features.shape[0]
    buf_len = n_prefix + sample_len + K + 2

    depth = jnp.asarray(depth_np)
    parent = jnp.asarray(parent_np)
    cand = jnp.asarray(cand_np)
    anc = jnp.asarray(anc_np)

    cache = init_cache(
        params, cfg, audio_features, max_len=buf_len, dtype=dtype,
        cross_kv_int8=cross_kv_int8, cross_kv_int4=cross_kv_int4,
    )

    # prefix pass; heads draft from the hidden of the input at lens-2
    prefix_logits, cache, prefix_hidden = decode_step_multipos_hidden(
        params, cfg, prefix_tokens, cache,
        jnp.zeros((B,), jnp.int32), dtype=dtype,
    )
    sot_logits = prefix_logits[:, sot_index]
    hidden0 = prefix_hidden[:, n_prefix - 2]

    tokens_buf = jnp.full((B, buf_len), eot, dtype=jnp.int32)
    tokens_buf = jax.lax.dynamic_update_slice(
        tokens_buf, prefix_tokens.astype(jnp.int32), (0, 0)
    )

    node_sl = jnp.arange(N)  # static node index vector

    def body(state):
        (
            rounds,
            lens,
            tokens_buf,
            finished,
            sum_logprobs,
            cache,
            emitted_total,
            hidden_frontier,
        ) = state

        cache, emit, emit_lp, sel, m, hidden = tree_round(
            params, medusa_params, cfg, cache, tokens_buf,
            hidden_frontier, lens, suppress_mask, blank_mask,
            n_prefix, tree, dtype,
        )
        idxs = jnp.arange(K + 1)[None, :]

        # ---- EOT / budget (identical contract to chain speculation)
        eot_hit = (emit == eot) & (idxs <= m[:, None])
        any_eot = eot_hit.any(axis=1)
        first_eot = jnp.argmax(eot_hit, axis=1)
        v = jnp.where(any_eot, first_eot + 1, m + 1)
        budget = sample_len - (lens - n_prefix)
        v = jnp.minimum(v, budget)
        v = jnp.where(finished, 0, v)

        sum_logprobs = sum_logprobs + jnp.where(
            idxs < v[:, None], emit_lp, 0.0
        ).sum(axis=1)
        emit_w = jnp.where(idxs < v[:, None], emit, eot)
        write_row = jax.vmap(
            lambda buf, new, p: jax.lax.dynamic_update_slice_in_dim(
                buf, new, p, axis=0
            )
        )
        tokens_buf = write_row(tokens_buf, emit_w, lens)

        emit_has_eot = any_eot & (first_eot < v)
        lens = lens + v
        finished = finished | emit_has_eot | (lens - n_prefix >= sample_len)
        emitted_total = emitted_total + v.sum()

        # hidden of the input at (new lens) - 2 feeds the next drafts:
        # v >= 2 -> accepted node at depth v-1 (sel[:, v-1]);
        # v == 1 -> the old root input (sel[:, 0])
        pick = jnp.take_along_axis(
            sel, jnp.maximum(v - 1, 0)[:, None], axis=1
        )[:, 0]
        new_hf = jnp.take_along_axis(
            hidden, pick[:, None, None], axis=1
        )[:, 0]
        hidden_frontier = jnp.where(
            (v >= 1)[:, None], new_hf, hidden_frontier
        )

        return (
            rounds + 1,
            lens,
            tokens_buf,
            finished,
            sum_logprobs,
            cache,
            emitted_total,
            hidden_frontier,
        )

    def cond(state):
        rounds, finished = state[0], state[3]
        return (rounds < sample_len) & ~jnp.all(finished)

    state = (
        jnp.array(0, jnp.int32),
        jnp.full((B,), n_prefix, jnp.int32),
        tokens_buf,
        jnp.zeros((B,), bool),
        jnp.zeros((B,), jnp.float32),
        cache,
        jnp.array(0, jnp.int32),
        hidden0,
    )
    out = jax.lax.while_loop(cond, body, state)
    rounds, tokens_buf, sum_logprobs, emitted_total = (
        out[0],
        out[2],
        out[4],
        out[6],
    )
    return tokens_buf, sum_logprobs, sot_logits, rounds, emitted_total


def medusa_tree_decode(
    params,
    cfg: WhisperConfig,
    medusa_params,
    mel,
    options: DecodingOptions = DecodingOptions(),
    tree: Tuple[Tuple[int, int], ...] = DEFAULT_TREE,
    tokenizer: Optional[WhisperTokenizer] = None,
    return_stats: bool = False,
) -> List[DecodingResult]:
    """Greedy decode accelerated by tree-verified Medusa drafts.

    Output tokens are exactly ``decode(params, cfg, mel, options)`` at
    temperature 0 (the tree affects only how many forwards are needed).
    Same restrictions as chain speculation: greedy, no timestamps.
    """
    if options.temperature != 0.0:
        raise ValueError("medusa_tree_decode requires temperature == 0")
    if not options.without_timestamps:
        raise ValueError("medusa_tree_decode requires without_timestamps")
    if options.beam_size is not None or options.best_of is not None:
        raise ValueError("medusa_tree_decode excludes beam_size/best_of")
    depth_np, _, cand_np, _, max_c, K = _tree_tables(tree)
    n_heads = len(medusa_params["heads"])
    if K > n_heads:
        raise ValueError(
            f"tree depth {K} exceeds the {n_heads} trained heads"
        )

    if tokenizer is None:
        tokenizer = get_tokenizer(
            multilingual=cfg.multilingual,
            num_languages=cfg.num_languages,
            language=options.language or "en",
            task=options.task,
        )
    dtype = jnp.bfloat16 if options.fp16 else jnp.float32

    mel = jnp.asarray(mel)
    if mel.ndim == 2:
        mel = mel[None]
    from .decoding import _encode_jit

    audio_features = _encode_jit(params, cfg, mel, dtype=dtype)

    prefix = initial_tokens(tokenizer, options)
    n_prefix = len(prefix)
    sot_index = prefix.index(tokenizer.sot)
    B = audio_features.shape[0]
    prefix_tokens = jnp.tile(jnp.asarray(prefix, jnp.int32)[None, :], (B, 1))

    detected_langs = None
    if options.language is None and cfg.multilingual:
        detected_langs, _ = detect_language(
            params, cfg, audio_features, tokenizer
        )
        lang_ids = jnp.asarray(
            [tokenizer.language_token(c) for c in detected_langs], jnp.int32
        )
        prefix_tokens = prefix_tokens.at[:, 1].set(lang_ids)

    sample_len = options.sample_len or (cfg.n_text_ctx // 2)
    sample_len = min(sample_len, cfg.n_text_ctx - n_prefix - K - 2)

    suppress_mask = jnp.asarray(
        build_suppress_mask(tokenizer, options, cfg.n_vocab)
    )
    blank_mask = (
        jnp.asarray(build_blank_mask(tokenizer, cfg.n_vocab))
        if options.suppress_blank
        else jnp.zeros((cfg.n_vocab,), jnp.float32)
    )

    tokens_buf, sum_logprobs, sot_logits, rounds, emitted = _tree_decode_jit(
        params,
        medusa_params,
        cfg,
        audio_features,
        prefix_tokens,
        suppress_mask,
        blank_mask,
        eot=tokenizer.eot,
        n_prefix=n_prefix,
        sample_len=int(sample_len),
        dtype_name=jnp.dtype(dtype).name,
        sot_index=sot_index,
        cross_kv_int8=options.kv_int8,
        cross_kv_int4=options.kv_int4,
        tree=tuple(tree),
    )

    tokens_np = np.asarray(tokens_buf)
    sum_logprobs_np = np.asarray(sum_logprobs)
    no_speech_probs = np.asarray(
        jax.nn.softmax(sot_logits, axis=-1)[:, tokenizer.no_speech]
    )

    results = []
    for b in range(B):
        seq = tokens_np[b, n_prefix:]
        eot_pos = np.nonzero(seq == tokenizer.eot)[0]
        end = int(eot_pos[0]) if len(eot_pos) else len(seq)
        end = min(end, sample_len)
        out_tokens = seq[:end].tolist()
        text = tokenizer.decode_text(out_tokens).strip()
        results.append(
            DecodingResult(
                tokens=out_tokens,
                text=text,
                avg_logprob=float(sum_logprobs_np[b]) / (end + 1),
                no_speech_prob=float(no_speech_probs[b]),
                temperature=0.0,
                compression_ratio=compression_ratio(text),
                language=(
                    detected_langs[b]
                    if detected_langs
                    else options.language or tokenizer.language
                ),
            )
        )
    stats = SpeculativeStats(
        rounds=int(rounds),
        emitted_tokens=int(emitted),
        draft_k=K,
        batch=B,
    )
    if return_stats:
        return results, stats
    return results
