"""Copy of ``deeplearningexamples_tpu/data/bert_prep.py``, numpy only.

BERT pretraining corpus preparation (offline toolchain).

The role of the reference's offline pipeline
(``LanguageModeling/BERT/data/bertPrep.py`` + ``TextSharding.py`` +
``create_pretraining_data.py``): raw text → documents → sentences →
WordPiece token ids → shards on disk. Masking and NSP instances are made
online by ``bert_pretrain.BertPretrainLoader``, so the on-disk format is
just tokenized documents:

``shard_XXXX.npz``:
  - ``tokens``: flat int32 token-id stream
  - ``sent_offsets``: int64 (S+1,) sentence boundaries into ``tokens``
  - ``doc_offsets``: int64 (D+1,) document boundaries into ``sent_offsets``

Input convention matches the reference's formatter output: one or more text
files, documents separated by blank lines, one or more sentences per line.
Sentence segmentation is a rule-based splitter rather than NLTK punkt
(reference ``TextSharding.py:118``); the split only affects NSP segment
boundaries, not the token stream.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Iterable, Sequence

import numpy as np

from .tokenization import BertTokenizer

__all__ = [
    "segment_sentences",
    "iter_documents",
    "prepare_corpus",
    "load_corpus_shards",
]

# sentence end: ./!/? (+ closing quotes/brackets) followed by whitespace and
# an upper-case/digit start; avoids splitting single-letter initials ("J. K.")
_SENT_RE = re.compile(r"(?<=[.!?])(?<![A-Z]\.)[\"')\]]*\s+(?=[\"'(\[]*[A-Z0-9])")


def segment_sentences(text: str) -> list[str]:
    parts = [p.strip() for p in _SENT_RE.split(text)]
    return [p for p in parts if p]


def iter_documents(paths: Iterable[str]) -> Iterable[list[str]]:
    """Yield documents (lists of sentences) from blank-line-separated files."""
    for path in paths:
        doc: list[str] = []
        with open(path, encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    if doc:
                        yield doc
                        doc = []
                    continue
                doc.extend(segment_sentences(line))
        if doc:
            yield doc


def prepare_corpus(
    inputs: str | Sequence[str],
    vocab_file: str | dict,
    out_dir: str,
    n_shards: int = 1,
    min_sentence_tokens: int = 1,
    max_docs: int | None = None,
) -> int:
    """Tokenize a raw corpus into shard files. Returns documents written.

    ``inputs``: a glob pattern, a directory (all ``*.txt``), or path list.
    Documents are dealt round-robin across shards (the reference's
    ``TextSharding`` balances by sentence count; round-robin over the
    shuffled-on-load shards achieves the same training-time balance).
    """
    if isinstance(inputs, str):
        if os.path.isdir(inputs):
            paths = sorted(glob.glob(os.path.join(inputs, "*.txt")))
        else:
            paths = sorted(glob.glob(inputs))
    else:
        paths = list(inputs)
    if not paths:
        raise FileNotFoundError(f"no input files matched {inputs!r}")
    tok = BertTokenizer(vocab_file)
    os.makedirs(out_dir, exist_ok=True)

    shards: list[dict] = [
        {"tokens": [], "sent_offsets": [0], "doc_offsets": [0]}
        for _ in range(n_shards)
    ]
    n_docs = 0
    for doc in iter_documents(paths):
        sents = []
        for s in doc:
            ids = tok.convert_tokens_to_ids(tok.tokenize(s))
            if len(ids) >= min_sentence_tokens:
                sents.append(np.asarray(ids, np.int32))
        if not sents:
            continue
        sh = shards[n_docs % n_shards]
        for ids in sents:
            sh["tokens"].append(ids)
            sh["sent_offsets"].append(sh["sent_offsets"][-1] + len(ids))
        sh["doc_offsets"].append(len(sh["sent_offsets"]) - 1)
        n_docs += 1
        if max_docs is not None and n_docs >= max_docs:
            break

    for i, sh in enumerate(shards):
        np.savez(
            os.path.join(out_dir, f"shard_{i:04d}.npz"),
            tokens=(
                np.concatenate(sh["tokens"])
                if sh["tokens"]
                else np.zeros(0, np.int32)
            ),
            sent_offsets=np.asarray(sh["sent_offsets"], np.int64),
            doc_offsets=np.asarray(sh["doc_offsets"], np.int64),
        )
    return n_docs


def load_corpus_shards(
    directory: str, shard: tuple[int, int] = (0, 1)
) -> list[list[np.ndarray]]:
    """Shard files → documents (list of per-sentence id arrays) for
    ``BertPretrainLoader``. ``shard=(i, n)`` takes every n-th shard file
    (multi-host: each host loads a disjoint subset)."""
    files = sorted(glob.glob(os.path.join(directory, "shard_*.npz")))
    if not files:
        raise FileNotFoundError(f"no shard_*.npz under {directory}")
    docs: list[list[np.ndarray]] = []
    for path in files[shard[0] :: shard[1]]:
        with np.load(path) as z:
            tokens, so, do = z["tokens"], z["sent_offsets"], z["doc_offsets"]
        for d in range(len(do) - 1):
            docs.append(
                [
                    tokens[so[s] : so[s + 1]]
                    for s in range(do[d], do[d + 1])
                ]
            )
    return docs
