"""Byte-level tokenizers + the text → token-record pipeline.

The JAX package's ``data/tokenizer.py``, for the port: the same training
algorithm and tie-break, so one corpus gives the two packages the same
merges list, the same ids and byte-equal record files.

The reference's input story is TF's compiled input machinery over MNIST
(SURVEY.md §2b row 3); its LM-era configs here (GPT-2 config 5, BERT
config 3) need the text equivalent: corpus in, fixed-length token records
out, streamed by the same native loader that feeds images. This module is
the host-side text tier:

* :class:`ByteTokenizer` — the 256-byte vocabulary (+EOS). Zero training,
  perfectly lossless; the byte-vocab baseline used by byte-level LMs.
* :class:`ByteBPETokenizer` — GPT-2-style byte-level BPE: base vocab is
  the 256 bytes, merges are learned greedily from corpus pair counts, so
  ANY input roundtrips exactly (no <unk> — unknown text degrades to raw
  bytes, never fails). Pre-tokenization attaches one leading space to each
  word (GPT-2's convention, simplified: no regex category classes) and
  merges never cross pre-token boundaries.
* :func:`import_text` — corpus file → packed fixed-length records through
  :func:`~distributed_tensorflow_guide_tpu_torch.data.native_loader.write_records`
  in bounded-memory chunks, ready for the C++ mmap/shuffle/prefetch loader.

Consequence: tokenization is a one-time host-side import, never per-step
work — steps stream mmap'd int32 records, exactly like the image path, so
the card never waits on Python string handling.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from distributed_tensorflow_guide_tpu_torch.data.native_loader import (
    Field,
    make_fields,
    write_records,
)

# pre-tokens: a word with its leading space attached (" hello"), runs of
# other whitespace, or leading-of-text words. Byte-level: applied to the
# raw utf-8 bytes, so no unicode table is needed at encode time.
_PRETOKEN = re.compile(rb" ?[^\s]+|\s+")

# whitespace-free input (minified JS, base64 blobs, long URLs) yields one
# giant pre-token, and the merge loop is O(L^2) in pre-token length — a
# 100 KB blob would effectively hang encode. Capping the piece length
# bounds the cost; merges simply never span a cap boundary (negligible
# compression loss on pathological inputs, zero on prose) and roundtrip
# exactness is untouched.
_MAX_PRETOKEN = 1024


def _pretokens(data: bytes):
    for m in _PRETOKEN.finditer(data):
        w = m.group()
        if len(w) <= _MAX_PRETOKEN:
            yield w
        else:
            for i in range(0, len(w), _MAX_PRETOKEN):
                yield w[i:i + _MAX_PRETOKEN]


class ByteTokenizer:
    """Identity byte vocabulary: id i == byte i, plus one EOS id (256)."""

    def __init__(self):
        self.vocab_size = 257
        self.eos_id = 256

    def encode(self, text: str | bytes) -> list[int]:
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        return list(data)

    def decode(self, ids: Iterable[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


class ByteBPETokenizer:
    """Byte-level BPE: 256 byte ids + learned merges (+EOS as the last id).

    ``merges[k] = (a, b)`` creates token ``256 + k`` from adjacent tokens
    (a, b); lower k = higher priority at encode time, exactly the ranking
    produced by greedy frequency training. Losslessness is structural:
    every token decodes to a fixed byte string and every byte is a token,
    so decode(encode(x)) == x for any x.
    """

    def __init__(self, merges: Sequence[tuple[int, int]] = ()):
        self.merges = [tuple(m) for m in merges]
        self._rank = {m: k for k, m in enumerate(self.merges)}
        # id -> bytes expansion table (merge ids reference only earlier ids,
        # so one forward pass materializes it)
        self._bytes: list[bytes] = [bytes([b]) for b in range(256)]
        for a, b in self.merges:
            self._bytes.append(self._bytes[a] + self._bytes[b])
        self.eos_id = 256 + len(self.merges)
        self.vocab_size = self.eos_id + 1
        self._word_cache: dict[bytes, tuple[int, ...]] = {}

    # -- training -----------------------------------------------------------

    @classmethod
    def train(cls, text: str | bytes, vocab_size: int,
              min_pair_count: int = 2) -> "ByteBPETokenizer":
        """Greedy BPE over pre-token frequencies (Sennrich et al. 2016,
        byte flavor). ``vocab_size`` counts bytes + merges + EOS; training
        stops early when no adjacent pair reaches ``min_pair_count``."""
        if vocab_size < 258:
            raise ValueError("vocab_size must be >= 258 (256 bytes + >=1 "
                             f"merge + EOS), got {vocab_size}")
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        # word -> frequency; BPE statistics over types, not tokens
        freqs: dict[bytes, int] = {}
        for w in _pretokens(data):
            freqs[w] = freqs.get(w, 0) + 1
        words = [(list(w), f) for w, f in freqs.items()]
        merges: list[tuple[int, int]] = []
        n_merges = vocab_size - 257  # minus bytes and EOS
        for next_id in range(256, 256 + n_merges):
            counts: dict[tuple[int, int], int] = {}
            for seq, f in words:
                for pair in zip(seq, seq[1:]):
                    counts[pair] = counts.get(pair, 0) + f
            if not counts:
                break
            # deterministic tie-break: max count, then smallest pair ids
            best, n = min(counts.items(), key=lambda kv: (-kv[1], kv[0]))
            if n < min_pair_count:
                break
            merges.append(best)
            a, b = best
            for seq, _ in words:
                i = 0
                while i < len(seq) - 1:
                    if seq[i] == a and seq[i + 1] == b:
                        seq[i:i + 2] = [next_id]
                    else:
                        i += 1
        return cls(merges)

    # -- encode / decode ----------------------------------------------------

    def _encode_word(self, word: bytes) -> tuple[int, ...]:
        cached = self._word_cache.get(word)
        if cached is not None:
            return cached
        seq = list(word)
        while len(seq) > 1:
            ranked = [
                (self._rank[p], i)
                for i, p in enumerate(zip(seq, seq[1:]))
                if p in self._rank
            ]
            if not ranked:
                break
            rank, i = min(ranked)
            seq[i:i + 2] = [256 + rank]
        out = tuple(seq)
        if len(self._word_cache) < 1 << 20:  # bounded (corpora repeat words)
            self._word_cache[word] = out
        return out

    def encode(self, text: str | bytes) -> list[int]:
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        out: list[int] = []
        for w in _pretokens(data):
            out.extend(self._encode_word(w))
        return out

    def decode(self, ids: Iterable[int]) -> str:
        return b"".join(
            self._bytes[i] for i in ids if 0 <= i < len(self._bytes)
        ).decode("utf-8", errors="replace")

    # -- persistence --------------------------------------------------------

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps({
            "format": "dtg-byte-bpe-v1",
            "merges": [list(m) for m in self.merges],
        }))

    @classmethod
    def load(cls, path: str | Path) -> "ByteBPETokenizer":
        spec = json.loads(Path(path).read_text())
        if spec.get("format") != "dtg-byte-bpe-v1":
            raise ValueError(f"{path}: not a dtg-byte-bpe-v1 vocab file")
        return cls([tuple(m) for m in spec["merges"]])


# -- corpus -> fixed-length token records ------------------------------------


def text_fields(seq_len: int) -> list[Field]:
    """The record layout LM configs stream: one int32 token row per record.
    Models shift internally (targets = tokens[:, 1:]), so a record is
    exactly the training window."""
    return make_fields({"tokens": (np.int32, (seq_len,))})


def padded_vocab(n: int, multiple: int = 128) -> int:
    """Model vocab for a tokenizer of ``n`` tokens: rounded up to the lane
    multiple (tensor-core tiling + even vocab-parallel sharding over any model
    axis — the standard Megatron-style padding). One definition so a
    served model's head size can never drift from its trained
    checkpoint's."""
    return -(-n // multiple) * multiple


def labeled_text_fields(seq_len: int) -> list[Field]:
    """Record layout for classification configs (BERT/GLUE, config 3): one
    fixed-length int32 token row + an int32 label per record."""
    return make_fields({"tokens": (np.int32, (seq_len,)),
                        "label": (np.int32, ())})


def import_labeled_text(tsv: str | Path, out: str | Path, tokenizer,
                        seq_len: int, *, chunk_records: int = 4096) -> int:
    """Pack a ``label<TAB>text`` file into fixed-length classification
    records (the GLUE-style input path for config 3).

    Each line becomes one record: the text's tokens truncated to
    ``seq_len`` and right-padded with EOS (the byte-level vocab has no
    dedicated pad id, and padding-vs-content is recoverable — content
    never contains EOS). Blank lines are skipped; a malformed line (no
    tab, non-integer label) raises with its line number — silently
    dropping examples would skew a benchmarked accuracy. Written through
    ``write_records(append=True)`` in ``chunk_records`` chunks, temp-file +
    atomic-replace like :func:`import_text`. Returns records written.
    """
    tsv, out = Path(tsv), Path(out)
    fields = labeled_text_fields(seq_len)
    tmp = out.with_suffix(out.suffix + f".tmp{os.getpid()}")
    eos = tokenizer.eos_id
    toks = np.full((chunk_records, seq_len), eos, np.int32)
    labs = np.zeros((chunk_records,), np.int32)
    n, fill = 0, 0
    try:
        with open(tsv, "rb") as fh:
            for lineno, line in enumerate(fh, 1):
                line = line.rstrip(b"\r\n")
                if not line:
                    continue
                label, tab, text = line.partition(b"\t")
                try:
                    labs[fill] = int(label)
                except ValueError:
                    raise ValueError(
                        f"{tsv}:{lineno}: expected 'label<TAB>text', got "
                        f"{line[:80]!r}") from None
                if not tab:
                    raise ValueError(
                        f"{tsv}:{lineno}: no tab separator in "
                        f"{line[:80]!r}")
                ids = tokenizer.encode(text)[:seq_len]
                toks[fill, :len(ids)] = ids
                toks[fill, len(ids):] = eos
                fill += 1
                if fill == chunk_records:
                    write_records(tmp, {"tokens": toks, "label": labs},
                                  fields, append=n > 0)
                    n += fill
                    fill = 0
        if fill:
            write_records(tmp, {"tokens": toks[:fill], "label": labs[:fill]},
                          fields, append=n > 0)
            n += fill
        if n == 0:
            raise ValueError(f"{tsv}: no examples (empty file?)")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return n


def import_text(corpus: str | Path, out: str | Path, tokenizer,
                seq_len: int, *, chunk_records: int = 4096) -> int:
    """Tokenize ``corpus`` and pack into ``out`` as fixed-length records.

    The token stream is document text + EOS, sliced into back-to-back
    ``seq_len`` windows (remainder dropped — records are fixed-size by
    format). Written through ``write_records(append=True)`` in
    ``chunk_records`` chunks so corpus size is bounded by the token array,
    not a full record buffer. Returns the number of records written.
    """
    corpus, out = Path(corpus), Path(out)
    ids = tokenizer.encode(corpus.read_bytes())
    ids.append(tokenizer.eos_id)
    n_records = len(ids) // seq_len
    if n_records == 0:
        raise ValueError(
            f"{corpus}: only {len(ids)} tokens — need at least seq_len="
            f"{seq_len} for one record")
    fields = text_fields(seq_len)
    arr = np.asarray(ids[:n_records * seq_len], np.int32).reshape(
        n_records, seq_len)
    # write-to-temp + atomic replace (the _build_lib convention): an
    # interrupted import must never leave a truncated-but-valid record
    # file behind for an mtime-keyed cache to silently reuse
    tmp = out.with_suffix(out.suffix + f".tmp{os.getpid()}")
    try:
        for lo in range(0, n_records, chunk_records):
            write_records(tmp, {"tokens": arr[lo:lo + chunk_records]},
                          fields, append=lo > 0)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return n_records
