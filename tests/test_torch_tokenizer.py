"""The port's byte-level BPE tokenizer and text-record pipeline
(``data/tokenizer.py``), held to the JAX package's, and the JAX package's
own tokenizer tests as the port's cases.

Tolerances: none — merges lists, ids, saved vocab files and record files
are compared exactly (the merges list is the tokenizer's weights).
"""

import numpy as np
import pytest

from distributed_tensorflow_guide_tpu.data import native_loader as jnl
from distributed_tensorflow_guide_tpu.data import tokenizer as jtok
from distributed_tensorflow_guide_tpu_torch.data.native_loader import (
    PyRecordLoader,
    load_native_lib,
    open_record_loader,
)
from distributed_tensorflow_guide_tpu_torch.data.tokenizer import (
    ByteBPETokenizer,
    ByteTokenizer,
    import_labeled_text,
    import_text,
    labeled_text_fields,
    padded_vocab,
    text_fields,
)

CORPUS = (
    "the quick brown fox jumps over the lazy dog. " * 40
    + "pack my box with five dozen liquor jugs! " * 30
    + "héllo wörld — ünïcode ✓ 测试 " * 10
)

HARD_CASES = [
    "",
    "plain ascii",
    "  leading and trailing  ",
    "tabs\tand\nnewlines\r\n",
    "\x00\x01\x02 control bytes \x7f",
    "héllo wörld — ünïcode ✓",
    "测试中文 with mixed ascii",
    "🙂🙃 emoji pairs 👩‍👩‍👧‍👧",
    "never-seen-at-training xyzzy qwfpgj",
]


@pytest.fixture(scope="module")
def bpe():
    return ByteBPETokenizer.train(CORPUS, vocab_size=512)


# -- the JAX package's tokenizer tests, as the port's cases -----------------


@pytest.mark.parametrize("text", HARD_CASES)
def test_bpe_roundtrip_exact(bpe, text):
    assert bpe.decode(bpe.encode(text)) == text


@pytest.mark.parametrize("text", HARD_CASES)
def test_byte_tokenizer_roundtrip_exact(text):
    bt = ByteTokenizer()
    ids = bt.encode(text)
    assert bt.decode(ids) == text
    assert all(0 <= i < 256 for i in ids)


def test_bpe_compresses_training_distribution(bpe):
    ids = bpe.encode(CORPUS)
    n_bytes = len(CORPUS.encode())
    assert len(ids) < n_bytes / 2, (len(ids), n_bytes)
    assert max(ids) >= 256
    assert bpe.vocab_size == 256 + len(bpe.merges) + 1
    assert bpe.eos_id == bpe.vocab_size - 1


def test_bpe_training_is_deterministic():
    a = ByteBPETokenizer.train(CORPUS, vocab_size=400)
    b = ByteBPETokenizer.train(CORPUS, vocab_size=400)
    assert a.merges == b.merges


def test_bpe_save_load_identity(bpe, tmp_path):
    p = tmp_path / "vocab.json"
    bpe.save(p)
    again = ByteBPETokenizer.load(p)
    assert again.merges == bpe.merges
    for text in HARD_CASES:
        assert again.encode(text) == bpe.encode(text)
    (tmp_path / "bad.json").write_text('{"format": "other"}')
    with pytest.raises(ValueError, match="vocab file"):
        ByteBPETokenizer.load(tmp_path / "bad.json")


def test_bpe_rejects_tiny_vocab():
    with pytest.raises(ValueError, match="258"):
        ByteBPETokenizer.train("x", vocab_size=257)


def test_import_text_records_match_direct_tokenization(bpe, tmp_path):
    """The records stream exactly encode(corpus)+[EOS], windowed, through
    both loaders."""
    corpus = tmp_path / "c.txt"
    corpus.write_text(CORPUS)
    rec = tmp_path / "c.records"
    seq_len = 32
    n = import_text(corpus, rec, bpe, seq_len)
    expect = bpe.encode(CORPUS) + [bpe.eos_id]
    assert n == len(expect) // seq_len
    want = np.asarray(expect[: n * seq_len], np.int32).reshape(n, seq_len)
    py = PyRecordLoader(rec, text_fields(seq_len), batch_size=n,
                        shuffle=False)
    np.testing.assert_array_equal(py.next_batch()["tokens"], want)
    if load_native_lib() is not None:
        native = open_record_loader(rec, text_fields(seq_len), batch_size=n,
                                    shuffle=False)
        np.testing.assert_array_equal(native.next_batch()["tokens"], want)
        native.close()


def test_import_text_rewrites_clean(bpe, tmp_path):
    corpus = tmp_path / "c.txt"
    corpus.write_text(CORPUS)
    rec = tmp_path / "c.records"
    n1 = import_text(corpus, rec, bpe, 32)
    n2 = import_text(corpus, rec, bpe, 32)
    assert n1 == n2
    assert rec.stat().st_size == n1 * 32 * 4


def test_giant_pretoken_bounded(bpe):
    """Whitespace-free input encodes in bounded time and still roundtrips
    exactly (pre-tokens are capped, not dropped)."""
    import time

    blob = "QUJDREVGR0hJSktMTU5PUA==" * 8000  # ~200 KB, no whitespace
    t0 = time.time()
    ids = bpe.encode(blob)
    assert time.time() - t0 < 10.0
    assert bpe.decode(ids) == blob


def test_import_text_too_small_raises(bpe, tmp_path):
    corpus = tmp_path / "tiny.txt"
    corpus.write_text("ab")
    with pytest.raises(ValueError, match="seq_len"):
        import_text(corpus, tmp_path / "t.records", bpe, 4096)


LINES = [
    "1\tthe film was great and warm",
    "0\tbleak and broken plot",
    "1\tsuperb honest delightful scenes",
    "0\tsour awful ending",
    "1\tcrisp bright dialogue",
    "0\tmurky shallow pacing",
]


@pytest.fixture(scope="module")
def labeled_tsv(tmp_path_factory):
    p = tmp_path_factory.mktemp("labeled") / "data.tsv"
    p.write_text("\n".join(LINES) + "\n")
    return p, LINES


def test_import_labeled_text_roundtrip(bpe, labeled_tsv, tmp_path):
    tsv, lines = labeled_tsv
    seq = 24
    rec = tmp_path / "d.records"
    n = import_labeled_text(tsv, rec, bpe, seq)
    assert n == len(lines)
    ld = PyRecordLoader(rec, labeled_text_fields(seq), batch_size=n,
                        shuffle=False)
    b = ld.next_batch()
    for i, line in enumerate(lines):
        label, text = line.split("\t", 1)
        assert b["label"][i] == int(label)
        ids = bpe.encode(text.encode())[:seq]
        want = ids + [bpe.eos_id] * (seq - len(ids))
        np.testing.assert_array_equal(b["tokens"][i], want)


def test_import_labeled_text_truncates_long_lines(bpe, tmp_path):
    tsv = tmp_path / "long.tsv"
    tsv.write_text("0\t" + "word " * 500 + "\n")
    rec = tmp_path / "long.records"
    seq = 16
    assert import_labeled_text(tsv, rec, bpe, seq) == 1
    ld = PyRecordLoader(rec, labeled_text_fields(seq), batch_size=1,
                        shuffle=False)
    b = ld.next_batch()
    assert b["tokens"].shape == (1, seq)
    np.testing.assert_array_equal(
        b["tokens"][0], bpe.encode(("word " * 500).encode())[:seq])


def test_import_labeled_text_rejects_malformed(bpe, tmp_path):
    for bad, match in [("no tab here", "label<TAB>text"),
                       ("x\ttext", "label<TAB>text"),
                       ("", "no examples")]:
        tsv = tmp_path / "bad.tsv"
        tsv.write_text(bad + "\n" if bad else "")
        with pytest.raises(ValueError, match=match):
            import_labeled_text(tsv, tmp_path / "bad.records", bpe, 8)


def test_import_labeled_text_chunked_append(bpe, labeled_tsv, tmp_path):
    tsv, _ = labeled_tsv
    a, b = tmp_path / "a.records", tmp_path / "b.records"
    import_labeled_text(tsv, a, bpe, 24, chunk_records=2)
    import_labeled_text(tsv, b, bpe, 24)
    assert a.read_bytes() == b.read_bytes()


# -- parity with the JAX package -------------------------------------------

WORDS = ("data", "parallel", "mesh", "shard", "the", "a", "of", "to",
         "tensor", "pipeline", "rank", "step", "loss", "grad", "chip",
         "kernel", "flash", "attention", "épreuve", "数据", "x" * 40, "\t",
         "\n", "  ", ",", ".", "!", "0", "1024", "🙂")


def _text(seed: int, n_words: int = 1500) -> str:
    """A few KB of seeded text over a word list with many pair-count ties
    (the tie-break decides many merges)."""
    rng = np.random.RandomState(seed)
    return " ".join(WORDS[i] for i in rng.randint(0, len(WORDS), n_words))


@pytest.mark.parametrize("seed,vocab", [(0, 300), (1, 290), (2, 258)])
def test_bpe_merges_and_ids_equal_the_jax_packages(seed, vocab):
    """Same bytes, same vocab: the same merges list, in order (the
    tie-break "max count, then smallest pair ids"), and the same ids for
    the corpus and for text never seen in training."""
    text = _text(seed)
    mine = ByteBPETokenizer.train(text, vocab)
    theirs = jtok.ByteBPETokenizer.train(text, vocab)
    assert mine.merges == theirs.merges
    assert len(mine.merges) == vocab - 257
    assert (mine.vocab_size, mine.eos_id) == (theirs.vocab_size,
                                              theirs.eos_id)
    for probe in [text, *HARD_CASES, _text(seed + 10, 200)]:
        assert mine.encode(probe) == theirs.encode(probe)
    assert ByteTokenizer().encode(text) == jtok.ByteTokenizer().encode(text)
    assert padded_vocab(mine.vocab_size) == jtok.padded_vocab(
        theirs.vocab_size)


def test_saved_tokenizers_load_in_either_package(tmp_path):
    text = _text(3)
    mine = ByteBPETokenizer.train(text, 300)
    theirs = jtok.ByteBPETokenizer.train(text, 300)
    mine.save(tmp_path / "port.json")
    theirs.save(tmp_path / "jax.json")
    assert ((tmp_path / "port.json").read_bytes()
            == (tmp_path / "jax.json").read_bytes())
    a = ByteBPETokenizer.load(tmp_path / "jax.json")
    b = jtok.ByteBPETokenizer.load(tmp_path / "port.json")
    assert a.merges == mine.merges and b.merges == theirs.merges
    for probe in HARD_CASES:
        assert a.encode(probe) == b.encode(probe) == mine.encode(probe)


def test_text_record_files_equal_the_jax_packages(tmp_path, labeled_tsv):
    """``import_text`` and ``import_labeled_text`` (one-shot and chunked)
    write the JAX package's bytes; the field layouts agree."""
    text = _text(4, 3000)
    mine = ByteBPETokenizer.train(text, 300)
    theirs = jtok.ByteBPETokenizer.train(text, 300)
    corpus = tmp_path / "c.txt"
    corpus.write_text(text)
    tsv, _ = labeled_tsv
    for chunk in (4096, 2):
        a, b = tmp_path / f"p{chunk}.rec", tmp_path / f"j{chunk}.rec"
        assert (import_text(corpus, a, mine, 32, chunk_records=chunk)
                == jtok.import_text(corpus, b, theirs, 32,
                                    chunk_records=chunk))
        assert a.read_bytes() == b.read_bytes()
        a, b = tmp_path / f"pl{chunk}.rec", tmp_path / f"jl{chunk}.rec"
        assert (import_labeled_text(tsv, a, mine, 24, chunk_records=chunk)
                == jtok.import_labeled_text(tsv, b, theirs, 24,
                                            chunk_records=chunk))
        assert a.read_bytes() == b.read_bytes()
    for f, g in ((text_fields(32), jtok.text_fields(32)),
                 (labeled_text_fields(24), jtok.labeled_text_fields(24))):
        assert [(x.name, x.dtype, x.shape) for x in f] == [
            (x.name, x.dtype, x.shape) for x in g]
    # the JAX package's loader streams the port's records
    rec = tmp_path / "p4096.rec"
    got = jnl.PyRecordLoader(rec, jnl.make_fields(
        {"tokens": (np.int32, (32,))}), 4, shuffle=False).next_batch()
    want = np.asarray(mine.encode(text)[:128], np.int32).reshape(4, 32)
    np.testing.assert_array_equal(got["tokens"], want)
