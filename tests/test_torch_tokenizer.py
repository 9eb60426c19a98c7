"""The port's tokenizer (`herald_tpu_torch/data/tokenizer.py`) against
herald_tpu's: every case of `tests/test_tokenizer.py` on both tokenizers,
from the vocab file the test writes, with equal tokens, ids and arrays,
and the port's result also held to that test's own expectation; then
a fuzz of WordPiece and of whole texts against JAX's tokenizer."""

import random

import numpy as np
import pytest

from herald_tpu_torch.data import tokenizer as T

VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
    "un", "##aff", "##able", "run", "##ning", "the", "quick", "brown",
    "fox", ",", ".", "!", "a", "##b", "##c", "want", "##ed", "wa",
    "##nt", "中", "国", "hello", "world", "##s",
]


@pytest.fixture()
def toks(tmp_path):
    from herald_tpu.data import tokenizer as J
    p = tmp_path / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return J.BertTokenizer(str(p)), T.BertTokenizer(str(p))


def _both(toks, fn):
    """fn on JAX's and the port's tokenizer: equal results, the port's
    returned."""
    a, b = fn(toks[0]), fn(toks[1])
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    else:
        assert a == b
    return b


def test_wordpiece_longest_match_first(toks):
    assert _both(toks, lambda t: t.tokenize("unaffable")) == [
        "un", "##aff", "##able"]
    assert _both(toks, lambda t: t.tokenize("wanted")) == ["want", "##ed"]
    assert _both(toks, lambda t: t.tokenize("running")) == ["run", "##ning"]


def test_unknown_word_is_single_unk(toks):
    assert _both(toks, lambda t: t.tokenize("zzz")) == ["[UNK]"]
    assert _both(toks, lambda t: t.tokenize("runz")) == ["[UNK]"]


def test_punctuation_splitting_and_lowercase(toks):
    assert _both(toks, lambda t: t.tokenize("The quick, brown fox!")) == [
        "the", "quick", ",", "brown", "fox", "!"]


def test_accent_stripping(toks):
    assert _both(toks, lambda t: t.tokenize("Thé")) == ["the"]


def test_cjk_chars_isolated(toks):
    assert _both(toks, lambda t: t.tokenize("hello中国world")) == [
        "hello", "中", "国", "world"]


def test_never_split_specials(toks):
    assert _both(toks, lambda t: t.basic_tokenizer.tokenize(
        "[CLS] hello [SEP]")) == ["[CLS]", "hello", "[SEP]"]
    assert _both(toks, lambda t: t.tokenize("[MASK]")) == ["[MASK]"]


def test_control_chars_removed_whitespace_collapsed(toks):
    assert _both(toks, lambda t: t.tokenize(
        "hello\x00� \t\n world\x07")) == ["hello", "world"]


def test_ids_round_trip(toks):
    ids = _both(toks, lambda t: t.convert_tokens_to_ids(
        t.tokenize("the quick fox")))
    assert _both(toks, lambda t: t.convert_ids_to_tokens(ids)) == \
        toks[1].tokenize("the quick fox")
    with pytest.raises(KeyError):
        toks[1].convert_tokens_to_ids(["nope"])


def test_max_input_chars_per_word(toks):
    assert _both(toks, lambda t: t.tokenize("a" * 200)) == ["[UNK]"]


def test_vocab_save_load_round_trip(toks, tmp_path):
    from herald_tpu.data import tokenizer as J
    p, q = tmp_path / "v_port.txt", tmp_path / "v_jax.txt"
    T.save_vocab(toks[1].vocab, str(p))
    J.save_vocab(toks[0].vocab, str(q))
    assert p.read_bytes() == q.read_bytes()
    assert T.load_vocab(str(p)) == toks[1].vocab == J.load_vocab(str(p))
    gappy = {"a": 0, "c": 2}
    T.save_vocab(gappy, str(p))
    J.save_vocab(gappy, str(q))
    assert p.read_bytes() == q.read_bytes()


def test_from_pretrained_dir(tmp_path):
    from herald_tpu.data import tokenizer as J
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB), encoding="utf-8")
    t = T.BertTokenizer.from_pretrained(str(tmp_path))
    j = J.BertTokenizer.from_pretrained(str(tmp_path))
    assert t.tokenize("running") == j.tokenize("running") == [
        "run", "##ning"]
    assert t.vocab == j.vocab
    with pytest.raises(ValueError, match="no vocabulary file"):
        T.BertTokenizer.from_pretrained(str(tmp_path / "missing"))


def test_encode_static_shapes(toks):
    ids, mask, tt = _both(toks, lambda t: t.encode(
        "the quick fox", "hello worlds", max_len=16))
    tok = toks[1]
    assert ids.shape == mask.shape == tt.shape == (16,)
    assert ids.dtype == np.int32
    n = int(mask.sum())
    got = tok.convert_ids_to_tokens(ids[:n].tolist())
    assert got[0] == "[CLS]" and got.count("[SEP]") == 2
    first_sep = got.index("[SEP]")
    assert set(tt[:first_sep + 1].tolist()) == {0}
    assert set(tt[first_sep + 1:n].tolist()) == {1}
    assert set(ids[n:].tolist()) == {tok.vocab["[PAD]"]}


def test_encode_truncates_longest_first(toks):
    ids, mask, _ = _both(toks, lambda t: t.encode(
        "the quick brown fox " * 10, "hello", max_len=12))
    assert int(mask.sum()) == 12


def test_encode_batch(toks):
    ids, mask, tt = _both(toks, lambda t: t.encode_batch(
        ["the fox", "hello worlds"], max_len=8))
    assert ids.shape == (2, 8)
    assert mask[1].sum() >= mask[0].sum()


def test_wordpiece_fuzz_vs_jax():
    """`test_tokenizer.py`'s fuzz vocabulary and words, on both
    WordpieceTokenizers."""
    from herald_tpu.data import tokenizer as J
    rng = random.Random(0)
    alpha = "abcde"
    pieces = set()
    for _ in range(60):
        w = "".join(rng.choice(alpha) for _ in range(rng.randint(1, 4)))
        pieces.add(w if rng.random() < 0.4 else "##" + w)
    vocab = {t: i for i, t in enumerate(sorted(pieces) + ["[UNK]"])}
    wj, wt = J.WordpieceTokenizer(vocab), T.WordpieceTokenizer(vocab)
    for _ in range(500):
        word = "".join(rng.choice(alpha + "xz")
                       for _ in range(rng.randint(1, 12)))
        assert wt.tokenize(word) == wj.tokenize(word), word


def test_basic_tokenizer_no_lower():
    from herald_tpu.data import tokenizer as J
    text = "Héllo, World"
    assert T.BasicTokenizer(do_lower_case=False).tokenize(text) == \
        J.BasicTokenizer(do_lower_case=False).tokenize(text) == [
            "Héllo", ",", "World"]


def test_text_fuzz_vs_jax(toks):
    """Random texts over the vocab's pieces, punctuation, accents, CJK,
    controls and whitespace: equal tokens and encodings."""
    rng = random.Random(1)
    parts = VOCAB[5:] + ["É", "é", "ü", "\x00", "\t", "\n", " ", "  ",
                         "$", "^", "`", "?", "—", "日本", "Ünder", "[CLS]",
                         "　", "\x07"]
    for _ in range(300):
        text = "".join(rng.choice(parts) for _ in range(rng.randint(0, 20)))
        pair = None if rng.random() < 0.5 else "".join(
            rng.choice(parts) for _ in range(rng.randint(0, 8)))
        _both(toks, lambda t: t.tokenize(text))
        _both(toks, lambda t: t.encode(text, pair, max_len=24))
