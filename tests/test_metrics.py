"""Metric contract tests.

Ports the reference's de-facto unit suite: the inline assertions and golden
cases of scripts/evaluate_ipa.py:381-462 (tokenization of combining
diacritics, PER/PFER behavior on canonical pairs).
"""

import numpy as np
import pytest

from whisper_ipa.metrics import (
    NUM_FEATURES,
    edit_distance,
    evaluate_batch,
    get_phone_features,
    normalize_ipa_for_comparison,
    phone_error_rate,
    phone_feature_error_rate,
    phone_feature_error_rate_cosine,
    tokenize_ipa,
)


class TestTokenizeIPA:
    """The 9 hard assertions from the reference self-test."""

    def test_syllabic_n(self):
        assert tokenize_ipa("n̩æp") == ["n̩", "æ", "p"]

    def test_nasalized_flap(self):
        assert tokenize_ipa("ɾ̃æ") == ["ɾ̃", "æ"]

    def test_devoiced_schwa(self):
        assert tokenize_ipa("ə̥tʃ") == ["ə̥", "t", "ʃ"]

    def test_affricate_splits(self):
        assert tokenize_ipa("tʃ") == ["t", "ʃ"]

    def test_syllabic_ng(self):
        assert tokenize_ipa("ŋ̍") == ["ŋ̍"]

    def test_simple(self):
        assert tokenize_ipa("kæt") == ["k", "æ", "t"]

    def test_syllabic_m(self):
        assert tokenize_ipa("m̩") == ["m̩"]

    def test_syllabic_l(self):
        assert tokenize_ipa("l̩") == ["l̩"]

    def test_empty(self):
        assert tokenize_ipa("") == []

    def test_spaces_stripped(self):
        assert tokenize_ipa("k æ t") == ["k", "æ", "t"]

    def test_tie_bar_joins(self):
        assert tokenize_ipa("t͡ʃa") == ["t͡ʃ", "a"]

    def test_aspiration_attaches(self):
        assert tokenize_ipa("kʰæt") == ["kʰ", "æ", "t"]

    def test_length_mark_attaches(self):
        assert tokenize_ipa("aːt") == ["aː", "t"]


class TestNormalize:
    def test_latin_g(self):
        assert normalize_ipa_for_comparison("gæg") == "ɡæɡ"

    def test_spaces(self):
        assert normalize_ipa_for_comparison("a b") == "ab"

    def test_nfc(self):
        # decomposed n + combining vertical line below -> NFC keeps combining
        s = normalize_ipa_for_comparison("n̩")
        assert tokenize_ipa(s) == ["n̩"]


class TestPER:
    def test_perfect(self):
        assert phone_error_rate("kæt", "kæt") == 0.0

    def test_one_sub(self):
        assert phone_error_rate("kæt", "kɛt") == pytest.approx(100.0 / 3)

    def test_insertion(self):
        assert phone_error_rate("kæt", "kæti") == pytest.approx(100.0 / 3)

    def test_deletion(self):
        assert phone_error_rate("kæt", "kt") == pytest.approx(100.0 / 3)

    def test_empty_ref(self):
        assert phone_error_rate("", "") == 0.0
        assert phone_error_rate("", "a") == 100.0

    def test_complete_difference(self):
        assert phone_error_rate("kæt", "dɑɡ") == 100.0

    def test_edit_distance_basic(self):
        assert edit_distance(list("kitten"), list("sitting")) == 3
        assert edit_distance([], list("abc")) == 3
        assert edit_distance(list("abc"), []) == 3


class TestFeatures:
    def test_vector_shape(self):
        assert get_phone_features("k").shape == (NUM_FEATURES,)

    def test_unknown_phone_zero(self):
        assert np.all(get_phone_features("∅") == 0)

    def test_voicing_pair_differs_only_slightly(self):
        p = get_phone_features("p")
        b = get_phone_features("b")
        diff = int(np.sum(p != b))
        assert 1 <= diff <= 3

    def test_aspiration_single_feature(self):
        k = get_phone_features("k")
        kh = get_phone_features("kʰ")
        assert int(np.sum(k != kh)) == 1

    def test_nasalization(self):
        a = get_phone_features("a")
        an = get_phone_features("ã")
        assert int(np.sum(a != an)) == 1

    def test_long_vowel(self):
        a = get_phone_features("a")
        al = get_phone_features("aː")
        assert int(np.sum(a != al)) == 1

    def test_syllabic_consonant(self):
        n = get_phone_features("n")
        ns = get_phone_features("n̩")
        assert int(np.sum(n != ns)) == 1

    def test_vowel_vs_stop_far_apart(self):
        a = get_phone_features("a")
        k = get_phone_features("k")
        assert int(np.sum(a != k)) > 6


class TestPFER:
    def test_perfect(self):
        assert phone_feature_error_rate("kæt", "kæt") == 0.0

    def test_aspiration_is_small(self):
        pfer = phone_feature_error_rate("kæt", "kʰæt")
        # single-feature substitution: 1/24 over 3 phones
        assert pfer == pytest.approx(100.0 / 24 / 3)

    def test_bounded_by_per(self):
        for ref, hyp in [("kæt", "kɛt"), ("kæt", "dɑɡ"), ("kæt", "kt")]:
            assert phone_feature_error_rate(ref, hyp) <= phone_error_rate(
                ref, hyp
            ) + 1e-9

    def test_deletion_costs_one(self):
        assert phone_feature_error_rate("kæt", "kt") == pytest.approx(
            100.0 / 3
        )

    def test_empty(self):
        assert phone_feature_error_rate("", "") == 0.0
        assert phone_feature_error_rate("", "a") == 100.0

    def test_cosine_perfect(self):
        assert phone_feature_error_rate_cosine("kæt", "kæt") == 0.0

    def test_cosine_selfsim_zero(self):
        # identical feature vectors: inherits diagonal -> 0
        assert phone_feature_error_rate_cosine("bʌtn̩", "bʌtn̩") == 0.0

    def test_cosine_positive_on_mismatch(self):
        assert phone_feature_error_rate_cosine("kæt", "dɑɡ") > 0.0


class TestEvaluateBatch:
    def test_self_comparison_zero(self):
        # IAA sanity check from reference compute_iaa.py:85-90
        refs = ["kæt", "bʌtn̩", "ə̥tʃ"]
        out = evaluate_batch(refs, refs)
        assert out["per"] == 0.0
        assert out["pfer"] == 0.0
        assert out["num_samples"] == 3

    def test_mean_and_std(self):
        out = evaluate_batch(["kæt", "kæt"], ["kæt", "kɛt"])
        assert out["per"] == pytest.approx((0 + 100.0 / 3) / 2)
        assert out["per_std"] > 0

    def test_mismatched_lengths_raise(self):
        with pytest.raises(AssertionError):
            evaluate_batch(["a"], [])


class TestNativeParity:
    """NumPy fallback and C++ core must agree."""

    def test_levenshtein_parity(self):
        native = pytest.importorskip("whisper_ipa.metrics.native")
        from whisper_ipa.metrics.per import _levenshtein_numpy

        rng = np.random.default_rng(0)
        for _ in range(20):
            a = rng.integers(0, 5, size=rng.integers(0, 30)).tolist()
            b = rng.integers(0, 5, size=rng.integers(0, 30)).tolist()
            assert native.levenshtein(a, b) == _levenshtein_numpy(a, b)

    def test_weighted_parity(self):
        native = pytest.importorskip("whisper_ipa.metrics.native")
        rng = np.random.default_rng(1)
        for _ in range(10):
            m, n = rng.integers(1, 20, size=2)
            sc = rng.uniform(0, 1, size=(m, n))
            # reference O(mn) scalar DP
            dp = np.zeros((m + 1, n + 1))
            dp[:, 0] = np.arange(m + 1)
            dp[0, :] = np.arange(n + 1)
            for i in range(1, m + 1):
                for j in range(1, n + 1):
                    dp[i, j] = min(
                        dp[i - 1, j] + 1,
                        dp[i, j - 1] + 1,
                        dp[i - 1, j - 1] + sc[i - 1, j - 1],
                    )
            assert native.weighted_edit_distance(sc) == pytest.approx(
                dp[m, n]
            )


class TestPanphonCSVLoader:
    def test_exact_table_override(self, tmp_path):
        import whisper_ipa.metrics.features as F

        csv_path = tmp_path / "ipa_all.csv"
        header = "ipa," + ",".join(F.FEATURE_NAMES)
        # a fake segment with an arbitrary vector
        row = "ʘ," + ",".join(["+"] * 5 + ["-"] * 10 + ["0"] * 9)
        csv_path.write_text(header + "\n" + row + "\n")
        n = F.load_panphon_csv(str(csv_path))
        try:
            assert n == 1
            v = F.get_phone_features("ʘ")
            assert list(v[:5]) == [1] * 5
            assert list(v[5:15]) == [-1] * 10
            assert list(v[15:]) == [0] * 9
        finally:
            F._EXACT_TABLE.clear()
            F.phone_to_vector.cache_clear()


class TestErrorAnalysis:
    def test_alignment_ops(self):
        from whisper_ipa.metrics.analysis import align_phones

        ops = align_phones(["k", "æ", "t"], ["k", "ɛ", "t"])
        assert [o[0] for o in ops] == ["match", "sub", "match"]
        assert ops[1][1:] == ("æ", "ɛ")

        ops = align_phones(["k", "æ", "t"], ["k", "t"])
        kinds = [o[0] for o in ops]
        assert kinds.count("del") == 1 and kinds.count("match") == 2

    def test_confusion_analysis(self):
        from whisper_ipa.metrics.analysis import confusion_analysis

        report = confusion_analysis(
            ["kæt", "kæt", "siː"], ["kɛt", "kæt", "siːs"]
        )
        assert report["num_pairs"] == 3
        assert (("æ", "ɛ"), 1) in report["top_substitutions"]
        assert ("s", 1) in report["top_insertions"]
        assert 0 < report["phone_accuracy"] <= 1
        assert report["per"]["mean"] > 0


class TestCompatFolds:
    """r3: real-corpus non-IPA leaks get honest feature vectors."""

    def test_greek_orthography_leak_is_i(self):
        from whisper_ipa.metrics.features import get_phone_features

        # Modern Greek iota/upsilon (incl. diaeresis forms) sound /i/
        i_vec = get_phone_features("i")
        assert (get_phone_features("ϊ") != 0).any()
        assert abs(get_phone_features("ϊ") - i_vec).sum() <= 2
        assert (get_phone_features("ϋ") != 0).any()

    def test_fullwidth_latin_folds_to_ascii(self):
        import numpy as np

        from whisper_ipa.metrics.features import get_phone_features

        assert np.array_equal(
            get_phone_features("ｌ"), get_phone_features("l")
        )
        assert np.array_equal(
            get_phone_features("ａ"), get_phone_features("a")
        )

    def test_tamil_aytam_is_x(self):
        import numpy as np

        from whisper_ipa.metrics.features import get_phone_features

        assert np.array_equal(
            get_phone_features("ஃ"), get_phone_features("x")
        )

    def test_juncture_marks_known_with_zero_features(self):
        from whisper_ipa.metrics.features import (
            get_phone_features,
            known_phone,
        )

        for mark in ("'", "・", "#", "!"):
            assert known_phone(mark)  # classified, not a coverage gap
            assert (get_phone_features(mark) == 0).all()  # reference cost

    def test_cjk_junk_stays_unknown(self):
        from whisper_ipa.metrics.features import known_phone

        assert not known_phone("玖")
