"""Korean text normalizer and jamo tokenizer (self-contained, no `jamo`/`nltk` deps).

Behavioral parity target: reference ``text/korean.py`` (normalize: :233-299,
number conversion: :292-394, tokenize: :177-228, symbol inventories: :24-27).
Hangul decomposition is done arithmetically on Unicode code points instead of
the reference's dictionary walk through the `jamo` library.

Symbol-type 1 (the default, 80 symbols, used with ``n_symbols=80``) represents
leads as U+1100-block jamo and vowels/tails as compatibility jamo.  The
reference's type-1 tail table maps the tail ㄷ (U+11AE) to 'ㅇ' — an apparent
typo in ``korean.py:151`` — and its symbol list therefore contains 'ㅇ' twice,
so both tails ㄷ and ㅇ resolve to id 62.  We reproduce that exactly: trained
checkpoints and golden id sequences (README.md:18-23) depend on it.
"""

from __future__ import annotations

import ast
import json
import os
import re
from functools import lru_cache

PAD = "_"
EOS = "~"
PUNC = "!'(),-.:;?"
SPACE = " "

# --- Unicode jamo inventories -------------------------------------------------

# 19 leads (choseong), U+1100..U+1112
LEADS = "".join(chr(0x1100 + i) for i in range(19))
# 21 vowels (jungseong), U+1161..U+1175
VOWELS = "".join(chr(0x1161 + i) for i in range(21))
# 27 tails (jongseong, excluding "no tail"), U+11A8..U+11C2
TAILS = "".join(chr(0x11A8 + i) for i in range(27))

# Compatibility-jamo renderings, in jamo-block order.
COMPAT_LEADS = "ㄱㄲㄴㄷㄸㄹㅁㅂㅃㅅㅆㅇㅈㅉㅊㅋㅌㅍㅎ"
COMPAT_VOWELS = "ㅏㅐㅑㅒㅓㅔㅕㅖㅗㅘㅙㅚㅛㅜㅝㅞㅟㅠㅡㅢㅣ"
COMPAT_TAILS = "ㄱㄲㄳㄴㄵㄶㄷㄹㄺㄻㄼㄽㄾㄿㅀㅁㅂㅄㅅㅆㅇㅈㅊㅋㅌㅍㅎ"
# Reference type-1 tail table with its ㄷ→ㅇ quirk (korean.py:151, index 6).
COMPAT_TAILS_TYPE1 = "ㄱㄲㄳㄴㄵㄶㅇㄹㄺㄻㄼㄽㄾㄿㅀㅁㅂㅄㅅㅆㅇㅈㅊㅋㅌㅍㅎ"

# Multi-symbol decompositions of compound jamo (types 3/4), by compat char.
_SPLIT_LEAD = {"ㄲ": "ㄱㄱ", "ㄸ": "ㄷㄷ", "ㅃ": "ㅂㅂ", "ㅆ": "ㅅㅅ", "ㅉ": "ㅈㅈ"}
_SPLIT_TAIL = {
    "ㄲ": "ㄱㄱ", "ㄳ": "ㄱㅅ", "ㄵ": "ㄴㅈ", "ㄶ": "ㄴㅎ", "ㄺ": "ㄹㄱ",
    "ㄻ": "ㄹㅁ", "ㄼ": "ㄹㅂ", "ㄽ": "ㄹㅅ", "ㄾ": "ㄹㅌ", "ㄿ": "ㄹㅍ",
    "ㅀ": "ㄹㅎ", "ㅄ": "ㅂㅅ", "ㅆ": "ㅅㅅ",
}

# Exported symbol inventories (identical content to reference korean.py:24-27;
# these are the model's vocabulary and must match trained checkpoints).
ALL_SYMBOLS_1 = PAD + EOS + LEADS + COMPAT_VOWELS + COMPAT_TAILS_TYPE1 + PUNC + SPACE
ALL_SYMBOLS_2 = (
    PAD + EOS + "ㄱㄲㄳㄴㄵㄶㄷㄸㄹㄺㄻㄼㄾㅀㅁㅂㅃㅄㅅㅆㅇㅈㅉㅊㅋㅌㅍㅎ"
    + COMPAT_VOWELS + PUNC + SPACE
)
ALL_SYMBOLS_3 = (
    PAD + EOS + "ᄀᄂᄃᄅᄆᄇᄉᄋᄌᄎᄏᄐᄑᄒ" + COMPAT_VOWELS
    + "ㄱㄴㄷㄹㅁㅂㅅㅇㅈㅊㅋㅌㅍㅎ" + "!'(),-.;? "
)
ALL_SYMBOLS_4 = (
    PAD + EOS + "ㄱㄴㄷㄹㅁㅂㅅㅇㅈㅊㅋㅌㅍㅎ" + COMPAT_VOWELS + "!'(),-.;? "
)

ALL_SYMBOLS = ALL_SYMBOLS_1  # default inventory (symbol_type=1)

# Note: dict comprehension makes later duplicates win, exactly like the
# reference (char_to_id_1['ㅇ'] = 62, the *tail* slot).
char_to_id_1 = {s: i for i, s in enumerate(ALL_SYMBOLS_1)}
char_to_id_2 = {s: i for i, s in enumerate(ALL_SYMBOLS_2)}
char_to_id_3 = {s: i for i, s in enumerate(ALL_SYMBOLS_3)}
char_to_id_4 = {s: i for i, s in enumerate(ALL_SYMBOLS_4)}
_CHAR_TO_ID = {1: char_to_id_1, 2: char_to_id_2, 3: char_to_id_3, 4: char_to_id_4}

_COMPAT_TO_LEAD = {c: LEADS[i] for i, c in enumerate(COMPAT_LEADS)}

_HANGUL_BASE = 0xAC00
_HANGUL_END = 0xD7A3


def decompose(text: str) -> list[str]:
    """Decompose Hangul syllables into U+1100-block jamo.

    Non-Hangul characters pass through; standalone compatibility jamo are
    promoted to lead jamo (matching reference korean.py:183's
    ``hcj_to_jamo(_, 'lead')``).
    """
    out = []
    for ch in text:
        code = ord(ch)
        if _HANGUL_BASE <= code <= _HANGUL_END:
            s = code - _HANGUL_BASE
            lead, vowel, tail = s // 588, (s % 588) // 28, s % 28
            out.append(LEADS[lead])
            out.append(VOWELS[vowel])
            if tail:
                out.append(TAILS[tail - 1])
        elif ch in _COMPAT_TO_LEAD:
            out.append(_COMPAT_TO_LEAD[ch])
        else:
            out.append(ch)
    return out


@lru_cache(maxsize=None)
def _jamo_symbol_map(symbol_type: int) -> dict[str, str]:
    """Map each U+1100-block jamo to its output symbol string for a type."""
    m: dict[str, str] = {}
    if symbol_type == 1:
        for i, c in enumerate(LEADS):
            m[c] = c
        for i, c in enumerate(VOWELS):
            m[c] = COMPAT_VOWELS[i]
        for i, c in enumerate(TAILS):
            m[c] = COMPAT_TAILS_TYPE1[i]
    elif symbol_type == 2:
        for i, c in enumerate(LEADS):
            m[c] = COMPAT_LEADS[i]
        for i, c in enumerate(VOWELS):
            m[c] = COMPAT_VOWELS[i]
        for i, c in enumerate(TAILS):
            m[c] = COMPAT_TAILS[i]
    elif symbol_type == 3:
        for i, c in enumerate(LEADS):
            compat = COMPAT_LEADS[i]
            split = _SPLIT_LEAD.get(compat)
            m[c] = "".join(_COMPAT_TO_LEAD[x] for x in split) if split else LEADS[i]
        for i, c in enumerate(VOWELS):
            m[c] = COMPAT_VOWELS[i]
        for i, c in enumerate(TAILS):
            compat = COMPAT_TAILS[i]
            m[c] = _SPLIT_TAIL.get(compat, compat)
    elif symbol_type == 4:
        for i, c in enumerate(LEADS):
            compat = COMPAT_LEADS[i]
            m[c] = _SPLIT_LEAD.get(compat, compat)
        for i, c in enumerate(VOWELS):
            m[c] = COMPAT_VOWELS[i]
        for i, c in enumerate(TAILS):
            compat = COMPAT_TAILS[i]
            m[c] = _SPLIT_TAIL.get(compat, compat)
    else:
        raise ValueError(f"symbol_type must be 1..4, got {symbol_type}")
    for c in PAD + EOS + PUNC + SPACE:
        m[c] = c
    return m


def tokenize(text: str, as_id: bool = False, symbol_type: int = 1) -> list:
    """Normalize Korean text and decompose to jamo symbols (+ EOS).

    Matches reference ``korean.tokenize`` (korean.py:177-228); unknown
    characters are silently dropped instead of raising KeyError.
    """
    symmap = _jamo_symbol_map(symbol_type)
    char_to_id = _CHAR_TO_ID[symbol_type]
    text = normalize(text)
    tokens: list[str] = []
    for j in decompose(text):
        mapped = symmap.get(j)
        if mapped is not None:
            tokens.extend(mapped)
    if as_id:
        return [char_to_id[t] for t in tokens] + [char_to_id[EOS]]
    return tokens + [EOS]


# --- Normalization -------------------------------------------------------------

_DICT_PATH = os.path.join(os.path.dirname(__file__), "ko_dictionary.json")
with open(_DICT_PATH, encoding="utf-8") as _f:
    _DICTS = json.load(_f)
etc_dictionary: dict = _DICTS["etc"]
english_dictionary: dict = _DICTS["english"]

num_to_kor = dict(zip("0123456789", "영일이삼사오육칠팔구"))

unit_to_kor1 = {"%": "퍼센트", "cm": "센치미터", "mm": "밀리미터",
                "km": "킬로미터", "kg": "킬로그람"}
unit_to_kor2 = {"m": "미터"}

upper_to_kor = {
    "A": "에이", "B": "비", "C": "씨", "D": "디", "E": "이", "F": "에프",
    "G": "지", "H": "에이치", "I": "아이", "J": "제이", "K": "케이", "L": "엘",
    "M": "엠", "N": "엔", "O": "오", "P": "피", "Q": "큐", "R": "알",
    "S": "에스", "T": "티", "U": "유", "V": "브이", "W": "더블유", "X": "엑스",
    "Y": "와이", "Z": "지",
}

_QUOTE_RE = re.compile(r"""([`"'＂“‘])(.+?)([`"'＂”’])""")
_HANJA_PAREN_RE = re.compile(
    "\\([⺀-⺙⺛-⻳⼀-⿕々〇〡-〩〸-〺〻㐀-䶵一-鿃豈-鶴侮-頻並-龎]+\\)"
)
_SENT_SPLIT_RE = re.compile(r"(?<=[.!?])\s+")


def normalize(text: str) -> str:
    """Full Korean normalization pipeline (reference korean.py:233-249)."""
    text = text.strip()
    text = text.replace("'", "").replace('"', "")
    text = re.sub(r"\(\d+일\)", "", text)
    text = _HANJA_PAREN_RE.sub("", text)
    text = normalize_with_dictionary(text, etc_dictionary)
    text = normalize_english(text)
    text = re.sub("[a-zA-Z]+", normalize_upper, text)
    text = normalize_quote(text)
    text = normalize_number(text)
    return text


def normalize_with_dictionary(text: str, dic: dict) -> str:
    if any(key in text for key in dic):
        pattern = re.compile("|".join(re.escape(key) for key in dic))
        return pattern.sub(lambda x: dic[x.group()], text)
    return text


def normalize_english(text: str) -> str:
    return re.sub(
        "([A-Za-z]+)",
        lambda m: english_dictionary.get(m.group(), m.group()),
        text,
    )


def normalize_upper(m) -> str:
    word = m.group(0)
    if word.isupper():
        return "".join(upper_to_kor[c] for c in word)
    return word


def normalize_quote(text: str) -> str:
    """Split quoted spans into sentences, re-quoting each with '...'.

    The reference uses nltk.sent_tokenize (korean.py:277-287); we use a
    regex splitter (split after terminal punctuation) to stay dependency-free.
    """
    def fn(m):
        sentences = _SENT_SPLIT_RE.split(m.group(2))
        return " ".join(f"'{s}'" for s in sentences if s)

    return _QUOTE_RE.sub(fn, text)


NUMBER_PATTERN = r"([+-]?\d[\d,]*)[\.]?\d*"
COUNT_UNITS = (
    "시|명|가지|살|마리|포기|송이|수|톨|통|점|개|벌|척|채|다발|그루|자루|줄|"
    "켤레|그릇|잔|마디|상자|사람|곡|병|판"
)

SINO_DIGITS = [""] + list("일이삼사오육칠팔구")
SINO_GROUP_UNITS = [""] + list("만억조경해")
SINO_SMALL_UNITS = [""] + list("십백천")
NATIVE_DIGITS = [""] + ["한", "두", "세", "네", "다섯", "여섯", "일곱", "여덟", "아홉"]
NATIVE_TENS = {
    "십": "열", "두십": "스물", "세십": "서른", "네십": "마흔", "다섯십": "쉰",
    "여섯십": "예순", "일곱십": "일흔", "여덟십": "여든", "아홉십": "아흔",
}


def normalize_number(text: str) -> str:
    text = normalize_with_dictionary(text, unit_to_kor1)
    text = normalize_with_dictionary(text, unit_to_kor2)
    text = re.sub(
        NUMBER_PATTERN + f"({COUNT_UNITS})",
        lambda m: _number_to_korean(m.group(1), m.group(2), is_count=True),
        text,
    )
    text = re.sub(
        NUMBER_PATTERN,
        lambda m: _number_to_korean(m.group(), "", is_count=False),
        text,
    )
    return text


def number_to_korean(num_str: str, is_count: bool = False) -> str:
    """Public helper mirroring the reference signature on plain strings."""
    return _number_to_korean(num_str, "", is_count)


def _number_to_korean(num_str: str, unit_str: str, is_count: bool) -> str:
    num_str = num_str.replace(",", "")
    try:
        num = ast.literal_eval(num_str)
    except (ValueError, SyntaxError):
        num = int(num_str)  # e.g. leading zeros: "010..."
    if num == 0:
        # Reference drops the unit for zero (korean.py:334-335).
        return "영"

    parts = num_str.split(".")
    digit_str = parts[0]
    float_str = parts[1] if len(parts) == 2 else None
    if is_count and float_str is not None:
        raise ValueError("count numbers cannot be fractional")

    digit_str = digit_str.lstrip("+")
    negative = digit_str.startswith("-")
    if negative:
        digit_str = str(abs(int(digit_str)))

    kor = ""
    # Like the reference (korean.py:354), size ignores leading zeros while the
    # digit loop below still walks the raw string.
    size = len(str(int(digit_str)))
    group: list[str] = []
    for i, ch in enumerate(digit_str, start=1):
        v = int(ch)
        if v != 0:
            group += (NATIVE_DIGITS if is_count else SINO_DIGITS)[v]
            group += SINO_SMALL_UNITS[(size - i) % 4]
        if (size - i) % 4 == 0 and group:
            kor += "".join(group)
            group = []
            kor += SINO_GROUP_UNITS[(size - i) // 4]

    if is_count:
        if kor.startswith("한") and len(kor) > 1:
            kor = kor[1:]
        if any(w in kor for w in NATIVE_TENS):
            kor = re.sub(
                "|".join(NATIVE_TENS), lambda m: NATIVE_TENS[m.group()], kor
            )
    elif kor.startswith("일") and len(kor) > 1:
        kor = kor[1:]

    if float_str is not None:
        kor += "쩜 " + re.sub(r"\d", lambda m: num_to_kor[m.group()], float_str)

    if num_str.startswith("+"):
        kor = "플러스 " + kor
    elif num_str.startswith("-"):
        kor = "마이너스 " + kor

    return kor + unit_str
