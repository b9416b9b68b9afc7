"""Anime-name canonicalization.

A copy of anime_recommendations_tpu/utils/text.py, so that the port loads
nothing of the JAX package: replace a fixed set of irregular glyphs with a
space, strip all whitespace, drop non-word characters, strip combining
accents after NFKD normalization, and lowercase.
"""

from __future__ import annotations

import re
import string
import unicodedata
from typing import Iterable

_IRREGULAR = ("★", "♥", "☆", "♡", "½", "ß", "²")
_WS_TABLE = {ord(c): None for c in string.whitespace}
_NON_WORD = re.compile(r"\W+")


def clean_name(item: str) -> str:
    """Canonicalize one name the way the original project does."""
    s = str(item)
    for irr in _IRREGULAR:
        if irr in s:
            s = s.replace(irr, " ")
    s = s.translate(_WS_TABLE)
    s = _NON_WORD.sub("", s)
    s = "".join(
        c for c in unicodedata.normalize("NFKD", s) if not unicodedata.combining(c)
    )
    return s.lower()


def clean_names(items: Iterable[str]) -> list[str]:
    """Canonicalize a list of names (the original project's clean() list branch)."""
    return [clean_name(x) for x in items]
