"""BERT-style WordPiece tokenizer (port of `herald_tpu/data/tokenizer.py`).

Pure Python and numpy, host code with no device: the same surface and the
same tokens and ids as the JAX package's tokenizer. ``BertTokenizer(
vocab_file, do_lower_case)``, ``tokenize``, ``convert_tokens_to_ids`` /
``convert_ids_to_tokens``, ``encode`` / ``encode_batch`` (static-shape
int32 arrays: [CLS] a [SEP] (b [SEP])? padded to ``max_len``) and
``from_pretrained`` on a local vocab file or a directory holding
``vocab.txt`` (there is no download path).

Normalization drops control characters, canonicalizes whitespace,
isolates CJK codepoints, optionally lower-cases and strips accents, and
splits at punctuation; WordPiece is greedy longest-match-first with
``##`` continuations, walked over a prefix trie.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")

_CJK_RANGES = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
    (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
    (0xF900, 0xFAFF), (0x2F800, 0x2FA1F),
)

# ASCII characters BERT treats as punctuation even though Unicode doesn't
# (e.g. ^ $ `): all non-alphanumeric printable ASCII.
_ASCII_PUNCT = frozenset(
    c for c in map(chr, range(33, 127)) if not c.isalnum()
)


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _is_punct(ch: str) -> bool:
    return ch in _ASCII_PUNCT or unicodedata.category(ch).startswith("P")


def _is_space(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def load_vocab(vocab_file: str) -> Dict[str, int]:
    """One token per line -> {token: line_number}."""
    vocab: Dict[str, int] = {}
    with open(vocab_file, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok and tok not in vocab:
                vocab[tok] = i
    return vocab


def save_vocab(vocab: Dict[str, int], vocab_file: str) -> None:
    inv = {i: t for t, i in vocab.items()}
    with open(vocab_file, "w", encoding="utf-8") as f:
        for i in range(max(inv) + 1 if inv else 0):
            f.write(inv.get(i, f"[unused{i}]") + "\n")


class _Trie:
    """Prefix trie over vocab entries; longest-match scan per position."""

    __slots__ = ("root",)

    def __init__(self, words: Iterable[str]):
        self.root: dict = {}
        for w in words:
            node = self.root
            for ch in w:
                node = node.setdefault(ch, {})
            node[""] = w  # terminal marker holds the full token

    def longest(self, chars: Sequence[str], start: int) -> Optional[str]:
        node, best = self.root, None
        for i in range(start, len(chars)):
            node = node.get(chars[i])
            if node is None:
                break
            if "" in node:
                best = node[""]
        return best


class BasicTokenizer:
    """Normalize + split on whitespace and punctuation.

    Same contract as the reference BasicTokenizer
    (`bert_tokenizer.py`:160-267): NUL/replacement/control chars are
    dropped, whitespace becomes single spaces, CJK codepoints become
    standalone tokens, and (unless listed in ``never_split``) tokens are
    lower-cased, NFD accent-stripped, and split at punctuation.
    """

    def __init__(self, do_lower_case: bool = True,
                 never_split: Sequence[str] = SPECIAL_TOKENS):
        self.do_lower_case = do_lower_case
        self.never_split = frozenset(never_split)

    def _normalize(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_space(ch):
                out.append(" ")
            elif _is_cjk(cp):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        return "".join(out)

    def _split_word(self, word: str) -> List[str]:
        if word in self.never_split:
            return [word]
        if self.do_lower_case:
            word = "".join(
                ch for ch in unicodedata.normalize("NFD", word.lower())
                if unicodedata.category(ch) != "Mn")
        pieces: List[str] = []
        run: List[str] = []
        for ch in word:
            if _is_punct(ch):
                if run:
                    pieces.append("".join(run))
                    run = []
                pieces.append(ch)
            else:
                run.append(ch)
        if run:
            pieces.append("".join(run))
        return pieces

    def tokenize(self, text: str) -> List[str]:
        toks: List[str] = []
        for word in self._normalize(text).split():
            toks.extend(self._split_word(word))
        return toks


class WordpieceTokenizer:
    """Greedy longest-match-first WordPiece over a trie.

    Matches the reference algorithm (`bert_tokenizer.py`:270-323): a
    word is consumed left to right, each step taking the longest vocab
    entry (continuations carry the ``##`` prefix); if any position has
    no match, the whole word becomes ``unk_token``.
    """

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word
        self._head = _Trie(w for w in vocab if not w.startswith("##"))
        self._cont = _Trie(w[2:] for w in vocab if w.startswith("##"))

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in text.split():
            chars = list(word)
            if len(chars) > self.max_input_chars_per_word:
                out.append(self.unk_token)
                continue
            pieces: List[str] = []
            start = 0
            while start < len(chars):
                trie = self._cont if start else self._head
                m = trie.longest(chars, start)
                if m is None:
                    pieces = [self.unk_token]
                    break
                pieces.append("##" + m if start else m)
                start += len(m)
            out.extend(pieces)
        return out


class BertTokenizer:
    """End-to-end BERT tokenization: basic split + WordPiece + ids."""

    def __init__(self, vocab_file: str, do_lower_case: bool = True,
                 max_len: Optional[int] = None,
                 never_split: Sequence[str] = SPECIAL_TOKENS):
        if not os.path.isfile(vocab_file):
            raise ValueError(f"no vocabulary file at {vocab_file!r}")
        self.vocab = load_vocab(vocab_file)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.basic_tokenizer = BasicTokenizer(do_lower_case, never_split)
        self.wordpiece_tokenizer = WordpieceTokenizer(self.vocab)
        self.max_len = max_len or int(1e12)

    @classmethod
    def from_pretrained(cls, path: str, **kwargs) -> "BertTokenizer":
        """Load from a vocab file or a directory containing vocab.txt.

        Local paths only: there is no download path.
        """
        if os.path.isdir(path):
            path = os.path.join(path, "vocab.txt")
        return cls(path, **kwargs)

    def tokenize(self, text: str) -> List[str]:
        return self.wordpiece_tokenizer.tokenize(
            " ".join(self.basic_tokenizer.tokenize(text)))

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        ids = [self.vocab[t] for t in tokens]
        if len(ids) > self.max_len:
            raise ValueError(
                f"sequence length {len(ids)} > max_len {self.max_len}")
        return ids

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.ids_to_tokens[i] for i in ids]

    # -- static-shape encoding ----------------------------------------

    def encode(self, text: str, text_pair: Optional[str] = None,
               max_len: int = 128) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
        """[CLS] a [SEP] (b [SEP])? padded to ``max_len``.

        Returns (input_ids, attention_mask, token_type_ids), each a
        fixed-shape int32 vector, whatever the input's length.
        """
        a = self.tokenize(text)
        b = self.tokenize(text_pair) if text_pair is not None else []
        # truncate longest-first until the total fits
        budget = max_len - 2 - (1 if b else 0)
        while len(a) + len(b) > budget:
            (a if len(a) >= len(b) else b).pop()
        toks = ["[CLS]"] + a + ["[SEP]"]
        types = [0] * len(toks)
        if b:
            toks += b + ["[SEP]"]
            types += [1] * (len(b) + 1)
        ids = self.convert_tokens_to_ids(toks)
        n, pad = len(ids), self.vocab.get("[PAD]", 0)
        out = np.full(max_len, pad, np.int32)
        out[:n] = ids
        mask = np.zeros(max_len, np.int32)
        mask[:n] = 1
        tt = np.zeros(max_len, np.int32)
        tt[:n] = types
        return out, mask, tt

    def encode_batch(self, texts: Sequence[str],
                     max_len: int = 128) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]:
        cols = [self.encode(t, max_len=max_len) for t in texts]
        return tuple(np.stack(c) for c in zip(*cols))  # type: ignore
