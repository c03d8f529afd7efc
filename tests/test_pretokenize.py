"""The first-party GPT-2 pre-tokenizer against the ``regex`` package.

tokenizer/bpe.pretokenize replaces ``regex.findall(GPT2_PAT, text)`` on
the main path. Character classes come from the interpreter's Unicode
database; code points it leaves unassigned may be classed differently by
a newer database inside ``regex``, so the sweep covers assigned ones.
"""

import random
import unicodedata

import pytest

from whisper_ipa.tokenizer.bpe import GPT2_PAT, pretokenize

regex = pytest.importorskip("regex")
PAT = regex.compile(GPT2_PAT)

CASES = {
    "ipa": ["ˈfoʊnətɪk ˌtræn.skrɪpʃən", "tʰɑ̃ː  ɲ̊ʷ  ʔə˞", "kʷʼ˥˩ a¹²³ b₄",
            "ð ə  ˈkæt", "t͡ʃ d͡ʒ"],
    "multilingual": ["Привет, мир!", "你好，世界。", "مرحبا بالعالم",
                     "नमस्ते दुनिया", "こんにちは 世界123", "Ⅻ ⅷ ½ ௰"],
    "english": ["I'm here, you're there; it's 12:30 — he'll go'd",
                "don't  stop\n\n  now ", "  leading and trailing  ",
                "tabs\tand\r\nnewlines\x0b\x0c", "'quoted' 'S 'T 're"],
    "separators": ["a\x1cb\x1d c\x1e\x1f d", "x y z　w v"],
}


@pytest.mark.parametrize("group", sorted(CASES))
def test_matches_regex(group):
    for text in CASES[group]:
        assert pretokenize(text) == PAT.findall(text), text


def _assigned():
    return [chr(c) for c in range(0x110000)
            if not 0xD800 <= c <= 0xDFFF
            and unicodedata.category(chr(c)) != "Cn"]


@pytest.mark.parametrize("context", ["{}", " {}", "{0}{0} x", "a{}1",
                                     "  {}", "'{}"])
def test_category_sweep(context):
    """Every assigned code point, in contexts that exercise each branch."""
    for c in _assigned():
        text = context.format(c)
        assert pretokenize(text) == PAT.findall(text), hex(ord(c))


def test_random_strings():
    rng = random.Random(0)
    pool = list(" \t\n'sStTrvmldL09¹²ˈəɪʃŋɾʔ.,!?-　\x1c") + _assigned()[
        ::97]
    for _ in range(5000):
        text = "".join(rng.choice(pool) for _ in range(rng.randint(0, 14)))
        assert pretokenize(text) == PAT.findall(text), repr(text)


def test_pieces_cover_the_text():
    text = "ˈfoʊ  nə\ttɪk's 42 ¹²"
    assert "".join(pretokenize(text)) == text
