"""Byte-pair encoding core: GPT-2 byte mapping + rank-based BPE merge.

Implements the byte-level BPE used by the Whisper/GPT-2 tokenizer family.
Ranks map token *bytes* to integer ids (the tiktoken ``.tiktoken`` file
format: one ``base64(token_bytes) rank`` pair per line).

When the real Whisper rank file (``multilingual.tiktoken``) is present we
produce bit-identical token ids; without it callers can fall back to a pure
byte-level vocabulary (see vocab.py) that preserves the special-token layout.

Behavioral reference: the upstream pipeline tokenizes IPA through the stock
multilingual Whisper tokenizer (reference scripts/ipa_data_loader.py:102-131).
"""

from __future__ import annotations

import base64
import unicodedata
from typing import Dict, Iterable, List

# GPT-2 pre-tokenization pattern (shared by the Whisper tokenizer), in the
# syntax of the third-party ``regex`` package. ``pretokenize`` implements
# it without that package.
GPT2_PAT = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)

_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
# str.isspace() also accepts the information separators U+001C..U+001F,
# which are not Unicode White_Space and so not ``\s`` in the pattern
_NOT_WHITE_SPACE = frozenset("\x1c\x1d\x1e\x1f")


def _is_space(c: str) -> bool:
    return c.isspace() and c not in _NOT_WHITE_SPACE


def _is_letter(c: str) -> bool:  # \p{L}: Lu, Ll, Lt, Lm, Lo
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:  # \p{N}: Nd, Nl and No (e.g. ¹ ² ³)
    return unicodedata.category(c)[0] == "N"


def _is_other(c: str) -> bool:  # [^\s\p{L}\p{N}]
    return not (_is_space(c) or _is_letter(c) or _is_number(c))


def pretokenize(text: str) -> List[str]:
    """Split text into BPE pieces exactly as ``GPT2_PAT.findall`` would.

    The alternatives are tried in the pattern's order at each position:
    a contraction; an optional space plus a run of letters, of numbers,
    or of other characters; then whitespace, of which a run followed by
    a non-space keeps its last character for the next piece. Character
    classes come from the interpreter's Unicode database (unicodedata).
    """
    pieces: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "'":
            suffix = next(
                (x for x in _CONTRACTIONS if text.startswith(x, i + 1)), None
            )
            if suffix is not None:
                pieces.append(text[i:i + 1 + len(suffix)])
                i += 1 + len(suffix)
                continue
        # " ?\p{L}+" | " ?\p{N}+" | " ?[^\s\p{L}\p{N}]+"
        j = i + 1 if c == " " and i + 1 < n else i
        matched = False
        for in_class in (_is_letter, _is_number, _is_other):
            if in_class(text[j]):
                k = j + 1
                while k < n and in_class(text[k]):
                    k += 1
                pieces.append(text[i:k])
                i = k
                matched = True
                break
        if matched:
            continue
        # "\s+(?!\S)" | "\s+": here text[i] is whitespace
        k = i + 1
        while k < n and _is_space(text[k]):
            k += 1
        if k < n and k - i > 1:
            k -= 1  # leave the last space to prefix the next piece
        pieces.append(text[i:k])
        i = k
    return pieces


def load_tiktoken_ranks(path: str) -> Dict[bytes, int]:
    """Load a tiktoken-format rank file: ``base64(token) rank`` per line."""
    ranks: Dict[bytes, int] = {}
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            token_b64, rank = line.split()
            ranks[base64.b64decode(token_b64)] = int(rank)
    return ranks


def byte_level_ranks(n_base: int = 50257) -> Dict[bytes, int]:
    """Degenerate rank table: 256 single-byte tokens, no merges.

    Token id i == byte value i for i < 256; ids 256..n_base-1 are unused
    placeholders so the special-token id layout matches the real vocabulary.
    Every Unicode string round-trips (multi-byte characters become several
    tokens). Used when no Whisper rank file is available on disk.
    """
    del n_base  # layout handled by the tokenizer; only byte tokens exist
    return {bytes([i]): i for i in range(256)}


class BPE:
    """Rank-driven byte-pair encoder/decoder."""

    def __init__(self, ranks: Dict[bytes, int]):
        self.ranks = ranks
        self.decoder: Dict[int, bytes] = {v: k for k, v in ranks.items()}
        self._cache: Dict[bytes, List[int]] = {}

    @property
    def n_vocab(self) -> int:
        return max(self.ranks.values()) + 1 if self.ranks else 0

    def _bpe_merge(self, piece: bytes) -> List[int]:
        """Merge a pre-tokenized piece into ids using the rank table."""
        if piece in self.ranks:
            return [self.ranks[piece]]
        cached = self._cache.get(piece)
        if cached is not None:
            return cached

        parts: List[bytes] = [piece[i : i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                rank = self.ranks.get(parts[i] + parts[i + 1])
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank = rank
                    best_i = i
            if best_rank is None:
                break
            parts = (
                parts[:best_i]
                + [parts[best_i] + parts[best_i + 1]]
                + parts[best_i + 2 :]
            )

        out: List[int] = []
        for part in parts:
            rank = self.ranks.get(part)
            if rank is not None:
                out.append(rank)
            else:
                # No merge path and no single token: emit per-byte ids.
                out.extend(self.ranks[part[i : i + 1]] for i in range(len(part)))
        if len(piece) < 64:
            self._cache[piece] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in pretokenize(text):
            ids.extend(self._bpe_merge(piece.encode("utf-8")))
        return ids

    def decode_bytes(self, ids: Iterable[int]) -> bytes:
        return b"".join(self.decoder.get(i, b"") for i in ids)

    def decode(self, ids: Iterable[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")
