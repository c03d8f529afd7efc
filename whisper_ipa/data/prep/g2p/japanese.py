"""Japanese kana -> IPA converter.

Covers hiragana + katakana (incl. palatalized digraphs, sokuon gemination,
chōonpu long vowels, ん -> ɴ). Kanji requires a reading dictionary and is
out of scope: sentences containing kanji raise ValueError so the caller can
skip them (the reference delegated this to the external multipa converter;
CommonVoice Japanese sentences are mostly kana after its filtering).
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, List

from ....env import setting

_BASE: Dict[str, str] = {
    "あ": "a", "い": "i", "う": "ɯ", "え": "e", "お": "o",
    "か": "ka", "き": "ki", "く": "kɯ", "け": "ke", "こ": "ko",
    "が": "ɡa", "ぎ": "ɡi", "ぐ": "ɡɯ", "げ": "ɡe", "ご": "ɡo",
    "さ": "sa", "し": "ɕi", "す": "sɯ", "せ": "se", "そ": "so",
    "ざ": "za", "じ": "dʑi", "ず": "zɯ", "ぜ": "ze", "ぞ": "zo",
    "た": "ta", "ち": "tɕi", "つ": "tsɯ", "て": "te", "と": "to",
    "だ": "da", "ぢ": "dʑi", "づ": "zɯ", "で": "de", "ど": "do",
    "な": "na", "に": "ɲi", "ぬ": "nɯ", "ね": "ne", "の": "no",
    "は": "ha", "ひ": "çi", "ふ": "ɸɯ", "へ": "he", "ほ": "ho",
    "ば": "ba", "び": "bi", "ぶ": "bɯ", "べ": "be", "ぼ": "bo",
    "ぱ": "pa", "ぴ": "pi", "ぷ": "pɯ", "ぺ": "pe", "ぽ": "po",
    "ま": "ma", "み": "mi", "む": "mɯ", "め": "me", "も": "mo",
    "や": "ja", "ゆ": "jɯ", "よ": "jo",
    "ら": "ɾa", "り": "ɾi", "る": "ɾɯ", "れ": "ɾe", "ろ": "ɾo",
    "わ": "wa", "ゐ": "i", "ゑ": "e", "を": "o",
    "ん": "ɴ",
    "ぁ": "a", "ぃ": "i", "ぅ": "ɯ", "ぇ": "e", "ぉ": "o",
    "ゔ": "vɯ",
}

# Corpus convention (measured against the reference's CV ja split,
# data/v2_filtered/ja_*_ipa.json): plain consonants palatalize as C+j
# (kjo̞ː not kʲo̞ː); the inherently palatal series stays single-symbol.
_DIGRAPH_ONSET: Dict[str, str] = {
    "き": "kj", "ぎ": "ɡj", "し": "ɕ", "じ": "dʑ", "ち": "tɕ",
    "に": "ɲ", "ひ": "ç", "び": "bj", "ぴ": "pj", "み": "mj", "り": "ɾj",
}
_SMALL_VOWEL = {"ゃ": "a", "ゅ": "ɯ", "ょ": "o"}
# katakana innovations: consonant + small vowel (ディ ティ ウィ ファ ...)
_SMALL_VOWEL_FULL = {"ぁ": "a", "ぃ": "i", "ぅ": "ɯ", "ぇ": "e", "ぉ": "o"}
_FOREIGN_ONSET = {"て": "t", "で": "d", "う": "w", "ふ": "ɸ", "ゔ": "v",
                  "し": "ɕ", "じ": "dʑ", "ち": "tɕ"}

_VOWELS = "aiɯeo"


def _to_hiragana(text: str) -> str:
    """Katakana -> hiragana (same phonology)."""
    out = []
    for ch in text:
        code = ord(ch)
        if 0x30A1 <= code <= 0x30F6:
            out.append(chr(code - 0x60))
        else:
            out.append(ch)
    return "".join(out)


def remove_ja_punct(text: str) -> str:
    return re.sub(r"[、。・「」『』！？!?,.\s]+", " ", text).strip()


# -- kanji readings ---------------------------------------------------------
# Built-in common-word reading table (longest-match-first). This is a small
# high-frequency subset — numbers, days, pronouns, frequent nouns/verb stems
# — NOT a full dictionary; sentences with uncovered kanji still raise so the
# preprocessing pipeline can skip them (reference delegated kanji to an
# external G2P repo not in the snapshot). A full dictionary (e.g. derived
# offline from UniDic) can be supplied as a TSV "word<TAB>kana" file via
# WHISPER_IPA_KANJI_DICT.
KANJI_READINGS = {
    # multi-kanji words first (longest match wins)
    "日本語": "にほんご", "日本人": "にほんじん", "日本": "にほん",
    "今日": "きょう", "明日": "あした", "昨日": "きのう", "毎日": "まいにち",
    "今年": "ことし", "去年": "きょねん", "来年": "らいねん",
    "今朝": "けさ", "今晩": "こんばん", "午前": "ごぜん", "午後": "ごご",
    "時間": "じかん", "時計": "とけい", "天気": "てんき", "電話": "でんわ",
    "電車": "でんしゃ", "自転車": "じてんしゃ", "自動車": "じどうしゃ",
    "学校": "がっこう", "学生": "がくせい", "先生": "せんせい",
    "大学": "だいがく", "会社": "かいしゃ", "仕事": "しごと",
    "家族": "かぞく", "友達": "ともだち", "子供": "こども",
    "女性": "じょせい", "男性": "だんせい", "一人": "ひとり",
    "二人": "ふたり", "三人": "さんにん", "大人": "おとな",
    "一つ": "ひとつ", "二つ": "ふたつ", "三つ": "みっつ",
    "一番": "いちばん", "一緒": "いっしょ", "全部": "ぜんぶ",
    "大丈夫": "だいじょうぶ", "本当": "ほんとう", "今度": "こんど",
    "世界": "せかい", "問題": "もんだい", "質問": "しつもん",
    "言葉": "ことば", "名前": "なまえ", "場所": "ばしょ",
    "部屋": "へや", "写真": "しゃしん", "映画": "えいが",
    "音楽": "おんがく", "料理": "りょうり", "買い物": "かいもの",
    "飛行機": "ひこうき", "新聞": "しんぶん", "図書館": "としょかん",
    "病院": "びょういん", "銀行": "ぎんこう", "駅": "えき",
    "月曜日": "げつようび", "火曜日": "かようび", "水曜日": "すいようび",
    "木曜日": "もくようび", "金曜日": "きんようび", "土曜日": "どようび",
    "日曜日": "にちようび", "誕生日": "たんじょうび",
    "お願い": "おねがい", "お金": "おかね", "お茶": "おちゃ",
    "お風呂": "おふろ", "元気": "げんき", "好き": "すき",
    "嫌い": "きらい", "上手": "じょうず", "下手": "へた",
    "有名": "ゆうめい", "簡単": "かんたん", "便利": "べんり",
    "静か": "しずか", "綺麗": "きれい", "面白": "おもしろ",
    "難し": "むずかし", "新し": "あたらし", "古い": "ふるい",
    "大き": "おおき", "小さ": "ちいさ", "高い": "たかい",
    "安い": "やすい", "早い": "はやい", "速い": "はやい",
    "遅い": "おそい", "近い": "ちかい", "遠い": "とおい",
    "多い": "おおい", "少な": "すくな", "少し": "すこし",
    "食べ": "たべ", "飲み": "のみ", "飲ん": "のん",
    "行き": "いき", "行っ": "いっ", "行く": "いく",
    "来る": "くる", "来て": "きて", "来た": "きた", "来ま": "きま",
    "帰り": "かえり", "帰っ": "かえっ", "帰る": "かえる",
    "見え": "みえ", "見せ": "みせ", "見る": "みる", "見て": "みて",
    "見た": "みた", "見ま": "みま", "聞い": "きい", "聞き": "きき",
    "聞く": "きく", "話し": "はなし", "話す": "はなす",
    "読み": "よみ", "読む": "よむ", "読ん": "よん",
    "書い": "かい", "書き": "かき", "書く": "かく",
    "買い": "かい", "買っ": "かっ", "買う": "かう",
    "使い": "つかい", "使っ": "つかっ", "使う": "つかう",
    "作り": "つくり", "作っ": "つくっ", "作る": "つくる",
    "思い": "おもい", "思っ": "おもっ", "思う": "おもう",
    "言い": "いい", "言っ": "いっ", "言う": "いう", "言わ": "いわ",
    "知り": "しり", "知っ": "しっ", "知ら": "しら",
    "分かり": "わかり", "分かっ": "わかっ", "分かる": "わかる",
    "出来": "でき", "出し": "だし", "出る": "でる", "出て": "でて",
    "入り": "はいり", "入っ": "はいっ", "入れ": "いれ",
    "待っ": "まっ", "待ち": "まち", "持っ": "もっ", "持ち": "もち",
    "歩い": "あるい", "歩き": "あるき", "走り": "はしり", "走っ": "はしっ",
    "泳ぎ": "およぎ", "働い": "はたらい", "働き": "はたらき",
    "勉強": "べんきょう", "旅行": "りょこう", "散歩": "さんぽ",
    "練習": "れんしゅう", "結婚": "けっこん", "生活": "せいかつ",
    "意味": "いみ", "気持ち": "きもち", "気分": "きぶん",
    # single kanji (common kun readings) — last resort after word matches
    "一": "いち", "二": "に", "三": "さん", "四": "よん", "五": "ご",
    "六": "ろく", "七": "なな", "八": "はち", "九": "きゅう", "十": "じゅう",
    "百": "ひゃく", "千": "せん", "万": "まん", "円": "えん",
    "人": "ひと", "日": "ひ", "月": "つき", "年": "とし", "時": "とき",
    "分": "ふん", "今": "いま", "先": "さき", "前": "まえ", "後": "あと",
    "上": "うえ", "下": "した", "中": "なか", "外": "そと", "間": "あいだ",
    "右": "みぎ", "左": "ひだり", "北": "きた", "南": "みなみ",
    "東": "ひがし", "西": "にし", "山": "やま", "川": "かわ",
    "海": "うみ", "空": "そら", "雨": "あめ", "雪": "ゆき", "風": "かぜ",
    "火": "ひ", "水": "みず", "木": "き", "金": "かね", "土": "つち",
    "花": "はな", "草": "くさ", "石": "いし", "犬": "いぬ", "猫": "ねこ",
    "鳥": "とり", "魚": "さかな", "牛": "うし", "馬": "うま",
    "手": "て", "足": "あし", "目": "め", "耳": "みみ", "口": "くち",
    "頭": "あたま", "顔": "かお", "心": "こころ", "体": "からだ",
    "声": "こえ", "力": "ちから", "男": "おとこ", "女": "おんな",
    "子": "こ", "父": "ちち", "母": "はは", "兄": "あに", "姉": "あね",
    "弟": "おとうと", "妹": "いもうと", "家": "いえ", "店": "みせ",
    "道": "みち", "町": "まち", "村": "むら", "国": "くに", "島": "しま",
    "車": "くるま", "船": "ふね", "門": "もん", "窓": "まど",
    "本": "ほん", "紙": "かみ", "字": "じ", "絵": "え", "歌": "うた",
    "色": "いろ", "白": "しろ", "黒": "くろ", "赤": "あか", "青": "あお",
    "春": "はる", "夏": "なつ", "秋": "あき", "冬": "ふゆ",
    "朝": "あさ", "昼": "ひる", "夜": "よる", "晩": "ばん",
    "何": "なに", "誰": "だれ", "私": "わたし", "僕": "ぼく", "君": "きみ",
    "物": "もの", "事": "こと", "所": "ところ", "方": "ほう",
    "新": "しん", "大": "だい", "小": "しょう", "長": "なが", "短": "みじか",
    "高": "たか", "安": "やす", "良": "よ", "悪": "わる", "強": "つよ",
    "弱": "よわ", "重": "おも", "軽": "かる", "暑": "あつ", "寒": "さむ",
    "広": "ひろ", "狭": "せま", "深": "ふか", "浅": "あさ",
    "立": "た", "座": "すわ", "寝": "ね", "起": "お", "開": "あ",
    "閉": "し", "始": "はじ", "終": "お", "送": "おく", "受": "う",
    "教": "おし", "習": "なら", "覚": "おぼ", "忘": "わす",
    # high-frequency Sino on-yomi (compose into compounds via
    # longest-match + the sokuon rule in kanji_to_kana; Sino えい is
    # written えー to match the corpus long-vowel convention)
    "現": "げん", "主": "しゅ", "在": "ざい", "原": "げん", "都": "と",
    "員": "いん", "発": "はつ", "成": "せー", "理": "り", "地": "ち",
    "京": "きょう", "代": "だい", "社": "しゃ", "術": "じゅつ",
    "論": "ろん", "意": "い", "放": "ほう", "相": "そう", "親": "おや",
    "台": "だい", "奈": "な", "想": "そう", "章": "しょう", "野": "の",
    "標": "ひょう", "状": "じょう", "信": "しん", "不": "ふ",
    "品": "ひん", "務": "む", "観": "かん", "勝": "しょう", "屋": "や",
    "単": "たん", "料": "りょう", "吸": "きゅう", "態": "たい",
    "選": "せん", "故": "こ", "民": "みん", "然": "ぜん",
    "業": "ぎょう", "験": "けん", "具": "ぐ", "画": "が",
    "建": "けん", "議": "ぎ", "優": "ゆう", "矛": "む", "盾": "じゅん",
    "型": "けー", "配": "はい", "又": "また", "政": "せー",
    "党": "とう", "格": "かく", "韓": "かん", "局": "きょく",
    "丸": "まる", "橋": "はし", "仕": "し", "要": "よう",
    "星": "ほし", "与": "よ", "解": "かい", "神": "かみ",
    "即": "そく", "訳": "やく", "友": "とも", "果": "か",
    "題": "だい", "老": "ろう", "能": "のう", "予": "よ",
    "存": "そん", "資": "し", "制": "せー", "阿": "あ", "比": "ひ",
    "機": "き", "衣": "い", "膜": "まく", "雰": "ふん", "尾": "お",
    "差": "さ", "問": "もん", "邦": "ほう", "謝": "しゃ",
    "念": "ねん", "補": "ほ", "常": "じょう", "王": "おう",
    "眼": "がん", "展": "てん", "内": "ない", "熊": "くま",
    "谷": "たに", "因": "いん", "利": "り", "転": "てん",
    "廊": "ろう", "英": "えー", "荘": "そう", "兵": "へい",
    "歴": "れき", "史": "し", "駐": "ちゅう", "収": "しゅう",
    "策": "さく", "嘘": "うそ", "公": "こう", "香": "こう",
    "御飯": "ごはん", "御": "ご",
    # compound verb stems whose kun reading beats composition
    "現れ": "あらわれ", "含ま": "ふくま", "含む": "ふくむ",
    "認め": "みとめ", "負け": "まけ", "勝っ": "かっ", "勝ち": "かち",
    "選ば": "えらば", "選ん": "えらん", "建て": "たて",
    "浮かん": "うかん", "浮かべ": "うかべ", "浮か": "うか",
    "乾い": "かわい", "想像": "そうぞう", "理由": "りゆう",
    "売": "う", "貸": "か", "借": "か", "返": "かえ", "払": "はら",
    "洗": "あら", "着": "き", "脱": "ぬ", "住": "す", "死": "し",
    "生": "い", "会": "あ", "答": "こた", "取": "と", "置": "お",
}

_kanji_dict_loaded = False


def _kanji_dict() -> dict:
    """Reading table: built-ins + corpus-derived TSV + optional external
    TSV (word\\tkana, via WHISPER_IPA_KANJI_DICT; its entries win)."""
    global _kanji_dict_loaded
    if not _kanji_dict_loaded:
        _kanji_dict_loaded = True
        import os

        # corpus-derived readings (see derive_ja_readings.py): shipped
        # with the package, recovered by alignment against the reference
        # CV ja corpus IPA
        derived = os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "ja_readings_corpus.tsv",
        )
        paths = [derived, setting("KANJI_DICT")]
        for path in paths:
            if path and os.path.isfile(path):
                with open(path, encoding="utf-8") as f:
                    for line in f:
                        if line.startswith("#"):
                            continue
                        parts = line.rstrip("\n").split("\t")
                        if len(parts) == 2 and parts[0]:
                            # later sources override earlier ones
                            KANJI_READINGS[parts[0]] = parts[1]
    return KANJI_READINGS


def kanji_to_kana(text: str) -> str:
    """Replace known kanji words with kana readings (longest match first).

    Unknown kanji pass through unchanged (kana_to_ipa raises on them, so
    uncovered sentences are still skipped rather than silently mangled).
    """
    table = _kanji_dict()
    if not any(0x4E00 <= ord(c) <= 0x9FFF for c in text):
        return text
    max_len = max(len(k) for k in table)
    out: List[str] = []
    i = 0
    prev_reading = False  # last appended piece came from the table
    while i < len(text):
        if 0x4E00 <= ord(text[i]) <= 0x9FFF:
            for ln in range(min(max_len, len(text) - i), 0, -1):
                word = text[i : i + ln]
                if word in table:
                    reading = table[word]
                    # Sino-compound sandhi between composed readings:
                    # つ/ち geminate before k/s/t/p rows, く/き before
                    # the k row (がく+こう -> がっこう, はつ+たつ ->
                    # はったつ)
                    if (
                        prev_reading
                        and out
                        and out[-1]
                        and reading
                        and reading[0] in "かきくけこさしすせそたちつてとぱぴぷぺぽ"
                        and (
                            out[-1][-1] in "つち"
                            or (
                                out[-1][-1] in "くき"
                                and reading[0] in "かきくけこ"
                            )
                        )
                    ):
                        out[-1] = out[-1][:-1] + "っ"
                    out.append(reading)
                    prev_reading = True
                    i += ln
                    break
            else:
                out.append(text[i])
                prev_reading = False
                i += 1
        else:
            out.append(text[i])
            prev_reading = False
            i += 1
    return "".join(out)


# Common words beginning in は (or containing it after ご/お): the
# topic-particle heuristic must NOT turn these into わ. Curated from the
# reference CV ja corpus contexts (no morphological analyzer offline).
_HA_WORD_NEXT = set("やじずっ")  # はやく はじめ はず はっきり


def _mark_particles(h: str) -> str:
    """Rewrite particle は->わ and directional へ->え on the kana string.

    The reference corpus was produced with a morphological analyzer; the
    closest offline approximation is positional heuristics: は defaults
    to the (far more frequent) topic particle except in word-initial
    patterns, は after ご/お (ごはん/おはよう), before another は (母),
    before なし/なす/なれ (話し), or sentence-initially; へ becomes the
    particle only before motion verbs or phrase-finally.
    """
    out = list(h)
    n = len(h)
    for i, c in enumerate(h):
        if c == "は":
            if i == 0:
                continue
            nxt = h[i + 1] if i + 1 < n else ""
            prv = h[i - 1]
            if prv in "ごお":
                continue
            if nxt in _HA_WORD_NEXT or nxt == "は":
                continue
            if nxt == "な" and i + 2 < n and h[i + 2] in "しすれ":
                continue
            out[i] = "わ"
        elif c == "へ" and i > 0:
            if i + 1 >= n or h[i + 1 : i + 3] in (
                "いき", "いく", "いこ", "むか", "かえ", "まい",
            ):
                out[i] = "え"
    return "".join(out)


def kana_to_ipa(text: str) -> str:
    """Convert a kana (or covered-kanji) string to IPA.

    Known kanji words are first converted to kana via the reading table;
    sentences containing UNCOVERED kanji raise so callers can skip them.
    Conventions follow the reference's CV ja corpus (measured against
    data/v2_filtered/ja_*_ipa.json): centralized ä / lowered o̞ e̞,
    gemination as onset+ː, oɯ/oo -> o̞ː, いい -> iː, particle は -> wä,
    ん place assimilation with n' before を/や-row.
    """
    text = kanji_to_kana(unicodedata.normalize("NFC", text))
    text = _mark_particles(_to_hiragana(text))
    out: List[str] = []
    i = 0
    n = len(text)
    geminate_next = False
    while i < n:
        ch = text[i]
        if ch == "っ":
            geminate_next = True
            i += 1
            continue
        if ch == "ー":
            # chōonpu: lengthen previous vowel
            if out and out[-1] and out[-1][-1] in _VOWELS:
                out.append("ː")
            i += 1
            continue
        if ch.isspace():
            out.append(" ")
            i += 1
            continue
        if ch == "ん":
            # n' before a vowel-initial particle を or the や-row
            # (corpus convention); place assimilation happens on the
            # IPA string below for consonant contexts
            nxt_k = text[i + 1] if i + 1 < n else ""
            out.append("n'" if nxt_k in ("を", "や", "ゆ", "よ") else "ɴ")
            i += 1
            continue
        nxt = text[i + 1] if i + 1 < n else ""
        if nxt in _SMALL_VOWEL and ch in _DIGRAPH_ONSET:
            syl = _DIGRAPH_ONSET[ch] + _SMALL_VOWEL[nxt]
            i += 2
        elif nxt in _SMALL_VOWEL_FULL and ch in _FOREIGN_ONSET:
            syl = _FOREIGN_ONSET[ch] + _SMALL_VOWEL_FULL[nxt]
            i += 2
        elif ch in _BASE:
            syl = _BASE[ch]
            i += 1
        elif 0x4E00 <= ord(ch) <= 0x9FFF:
            raise ValueError(f"kanji not supported without a reading dict: {ch!r}")
        else:
            i += 1
            continue
        prev_v = out[-1][-1] if out and out[-1] else ""
        # long vowels (corpus conventions): o+う / o+お -> o̞ː,
        # ɯ+う -> ɯː, and i+い -> iː — except when the い starts the
        # word いい (a following い keeps this one short: やっぱりいい
        # -> ɾiiː) or follows the particle に (に+いました -> ɲii)
        nxt_k = text[i] if i < n else ""  # ch already consumed above
        if ch == "う" and syl == "ɯ" and prev_v in ("o", "ɯ"):
            out.append("ː")
            continue
        if ch == "お" and syl == "o" and prev_v == "o":
            out.append("ː")
            continue
        if (
            ch == "い"
            and syl == "i"
            and prev_v == "i"
            and nxt_k != "い"
            and text[i - 2 : i - 1] != "に"
        ):
            out.append("ː")
            continue
        if geminate_next and syl and syl[0] not in _VOWELS:
            # gemination as onset + ː + vowel (tːe̞, kːo̞, tɕːɯ)
            k = 0
            while k < len(syl) and syl[k] not in _VOWELS:
                k += 1
            out.append(syl[:k] + "ː" + syl[k:])
            geminate_next = False
            continue
        geminate_next = False
        out.append(syl)
    text_out = "".join(out)
    # corpus vowel conventions (multipa): centralized a, lowered o/e
    text_out = (
        text_out.replace("a", "ä").replace("o", "o̞").replace("e", "e̞")
    )
    # ん place assimilation (corpus convention: n before labials too —
    # the reference data has np/nb 52x vs mp 1x)
    text_out = re.sub(r"ɴ(?=[kɡ])", "ŋ", text_out)
    text_out = re.sub(r"ɴ(?=m)", "m", text_out)
    text_out = re.sub(r"ɴ(?=[tdnɾpb])", "n", text_out)
    # assimilated nasal + identical nasal -> geminate
    text_out = re.sub(r"nn", "nː", text_out)
    text_out = re.sub(r"mm", "mː", text_out)
    return text_out


class Japanese2IPA:
    """Reference-surface converter class."""

    def remove_ja_punct(self, text: str) -> str:
        return remove_ja_punct(text)

    def convert_sentence_to_ipa(self, text: str) -> str:
        return kana_to_ipa(text)
