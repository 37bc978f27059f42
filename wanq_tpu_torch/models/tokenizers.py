"""HuggingFace tokenizer wrapper (counterpart of wanq_tpu/models/tokenizers.py):
fixed-length padding to text_len and whitespace cleaning. ``transformers``
is imported when a tokenizer is built, ftfy only when present."""

from __future__ import annotations

import html
import re
import string
from typing import List, Union


def basic_clean(text: str) -> str:
    try:
        import ftfy
    except ImportError:
        pass
    else:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def canonicalize(text: str, keep_punctuation_exact_string=None) -> str:
    text = text.replace("_", " ")
    drop = str.maketrans("", "", string.punctuation)
    if keep_punctuation_exact_string:
        text = keep_punctuation_exact_string.join(
            part.translate(drop) for part in text.split(keep_punctuation_exact_string))
    else:
        text = text.translate(drop)
    return whitespace_clean(text.lower())


class HuggingfaceTokenizer:
    def __init__(self, name: str, seq_len=None, clean=None, **kwargs):
        if clean not in (None, "whitespace", "lower", "canonicalize"):
            raise ValueError(f"unknown clean mode {clean!r}")
        from transformers import AutoTokenizer

        self.name = name
        self.seq_len = seq_len
        self.clean = clean
        self.tokenizer = AutoTokenizer.from_pretrained(name, **kwargs)
        self.vocab_size = self.tokenizer.vocab_size

    def __call__(self, sequence: Union[str, List[str]], **kwargs):
        """Token ids [B, seq_len] as numpy (and the attention mask with
        ``return_mask=True``)."""
        return_mask = kwargs.pop("return_mask", False)
        _kwargs = {"return_tensors": "np"}
        if self.seq_len is not None:
            _kwargs.update(padding="max_length", truncation=True, max_length=self.seq_len)
        _kwargs.update(**kwargs)
        if isinstance(sequence, str):
            sequence = [sequence]
        if self.clean:
            sequence = [self._clean(u) for u in sequence]
        ids = self.tokenizer(sequence, **_kwargs)
        if return_mask:
            return ids.input_ids, ids.attention_mask
        return ids.input_ids

    def _clean(self, text: str) -> str:
        if self.clean == "whitespace":
            return whitespace_clean(basic_clean(text))
        if self.clean == "lower":
            return whitespace_clean(basic_clean(text)).lower()
        if self.clean == "canonicalize":
            return canonicalize(basic_clean(text))
        return text
