"""Text normalisation and tokenisation (``mmqg_tpu/data/text_prep.py``):
de-hyphenation, de-contraction with ASCII and typographic apostrophes,
punctuation spacing, a Treebank-style rule tokenizer and the
alpha / numeric / ``, . ? !`` filter, without NLTK. Only what serving
calls; the corpus prep stays in the JAX package."""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

# (pattern, replacement) pairs, in the order they apply
_CONTRACTIONS: List[Tuple[re.Pattern, str]] = [
    (re.compile(r"won['’]t"), "will not"),
    (re.compile(r"can['’]t"), "can not"),
    (re.compile(r"let['’]s"), "let us"),
    (re.compile(r"n['’]t"), " not"),
    (re.compile(r"['’]re"), " are"),
    (re.compile(r"['’]s"), " is"),
    (re.compile(r"['’]d"), " would"),
    (re.compile(r"['’]ll"), " will"),
    (re.compile(r"['’]t"), " not"),
    (re.compile(r"['’]ve"), " have"),
    (re.compile(r"['’]m"), " am"),
]

_ALLOWED_PUNCT = {",", ".", "?", "!"}

# words (unicode letters included), numbers (decimals included), or any
# single non-space symbol
_TOKEN_RE = re.compile(r"\d+(?:\.\d+)?|\w+|[^\w\s]", re.UNICODE)


def decontract(phrase: str) -> str:
    """Expand English contractions."""
    for pat, rep in _CONTRACTIONS:
        phrase = pat.sub(rep, phrase)
    return phrase


def tokenize(text: str) -> List[str]:
    """Treebank-style rule tokenizer (in place of NLTK's word_tokenize)."""
    return _TOKEN_RE.findall(text)


def preprocess_text(text: str) -> Optional[str]:
    """De-hyphenate, de-contract, pad sentence punctuation, tokenize, and
    keep only alpha / numeric / ``, . ? !`` tokens, space-joined. None when
    nothing is left."""
    text = text.replace("—", " ").replace("-", " ").replace("_", " ")
    text = decontract(text)
    for p in (".", ",", "?", "!"):
        text = text.replace(p, f" {p}")

    filtered = []
    for tok in tokenize(text):
        if tok.isalpha() or tok.isnumeric():
            filtered.append(tok)
        elif tok in _ALLOWED_PUNCT:
            filtered.append(tok)
    if not filtered:
        return None
    return " ".join(filtered)


def lowercase_subtitle(subtitle: str) -> str:
    """Caption cleanup: lowercase, newlines to spaces, stripped."""
    return subtitle.lower().replace("\n", " ").strip()
