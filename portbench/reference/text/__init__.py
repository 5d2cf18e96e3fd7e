"""Text front end of the Korean configurations: text → symbol ids
(reference ``text/__init__.py`` ``text_to_sequence`` with
``korean_cleaners``; frozen copy).  The symbol table is chosen per call by
``symbol_type`` (1..4) instead of the reference's module globals.  Only
``korean_cleaners`` is copied, and text in curly braces (an ARPAbet span,
which the benchmark's texts never hold) is refused.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

from .korean import ALL_SYMBOLS_1, ALL_SYMBOLS_2, ALL_SYMBOLS_3, ALL_SYMBOLS_4
from .korean import tokenize as ko_tokenize


@lru_cache(maxsize=None)
def _symbol_to_id(symbol_type: int) -> dict:
    tables = {1: ALL_SYMBOLS_1, 2: ALL_SYMBOLS_2, 3: ALL_SYMBOLS_3, 4: ALL_SYMBOLS_4}
    if symbol_type not in tables:
        raise ValueError(f"symbol_type must be 1..4, got {symbol_type}")
    return {s: i for i, s in enumerate(tables[symbol_type])}


def text_to_sequence(text: str, cleaner_names: Sequence[str],
                     symbol_type: int = 1) -> List[int]:
    """Symbol ids of ``text`` after ``korean_cleaners`` (normalisation and
    jamo decomposition), with the end symbol '~' appended."""
    if tuple(cleaner_names) != ("korean_cleaners",):
        raise ValueError(f"only korean_cleaners is copied, not {list(cleaner_names)}")
    if "{" in text:
        raise ValueError("ARPAbet spans are not copied")
    symbol_to_id = _symbol_to_id(symbol_type)
    tokens = ko_tokenize(text, as_id=False, symbol_type=symbol_type)
    ids = [symbol_to_id[s] for s in tokens if s in symbol_to_id and s not in ("_", "~")]
    return ids + [symbol_to_id["~"]]
