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


# clean_name of an ASCII string: whitespace and every other non-word
# character dropped, A-Z lowered (NFKD and the irregular glyphs leave ASCII
# as it is). NUL stays, to separate the names of one joined string.
_ASCII_LOWER = bytes(range(256)).translate(
    bytes.maketrans(bytes(range(65, 91)), bytes(range(97, 123))))
_ASCII_DROP = bytes(c for c in range(1, 128) if not (chr(c).isalnum() or chr(c) == "_"))


def clean_names(items: Iterable[str]) -> list[str]:
    """Canonicalize a list of names (the original project's clean() list
    branch). A list of ASCII strings without NUL is cleaned as one joined
    string, in a few passes of C whatever its length (a catalog of tens of
    millions of names)."""
    items = list(items)
    try:
        joined = "\0".join(items)
    except TypeError:           # not all str
        joined = None
    if (joined is not None and joined.isascii()
            and joined.count("\0") == max(len(items) - 1, 0)):
        if not items:
            return []
        return joined.encode("ascii").translate(_ASCII_LOWER, _ASCII_DROP).decode(
            "ascii").split("\0")
    return [clean_name(x) for x in items]
