"""Copy of ``deeplearningexamples_tpu/data/criteo.py``, numpy only: the
Criteo pipeline for DLRM, a feature-spec schema, binary datasets and tools.

Covers the reference's data layer (``dlrm/data/``):
- ``feature_spec.py``: YAML schema declaring channels (numerical /
  categorical / label), per-feature cardinalities, and file mapping
- ``datasets.py`` ``ParametricDataset`` (:64): memory-mapped binary files,
  one .bin per channel: label f32, numerical f32 x 13, categorical i32 x C
- ``transcode.py``: TSV -> binary converter (hashing to cardinalities)
- synthetic generation (``prepare_synthetic_dataset.py``)

The feature spec is read and written with the port's ``core/yaml_subset.py``
(``to_yaml`` writes ``yaml.safe_dump``'s text). ``FeatureSpec.from_yaml``
keeps the JAX package's order: it reads the cardinalities in ``sorted()``
key order (``cat_0.bin``, ``cat_1.bin``, ``cat_10.bin``, ...), while
``categorical.bin``'s columns stay in file order, so with more than ten
tables a column's ids index another table's rows.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from ..core import yaml_subset

__all__ = ["FeatureSpec", "CriteoBinaryDataset", "transcode_tsv",
           "preprocess_criteo_tsv", "write_synthetic_dataset"]


@dataclass
class FeatureSpec:
    categorical_cardinalities: list[int]
    num_numerical: int = 13
    label_name: str = "label"

    @classmethod
    def from_yaml(cls, path: str) -> "FeatureSpec":
        doc = yaml_subset.load(path)
        cats = doc.get("feature_spec", {})
        cards = [
            int(v["cardinality"])
            for k, v in sorted(cats.items())
            if "cardinality" in v
        ]
        num = sum(1 for v in cats.values() if "cardinality" not in v and
                  v.get("dtype", "") != "label")
        return cls(categorical_cardinalities=cards,
                   num_numerical=num or 13)

    def to_yaml(self, path: str) -> None:
        spec = {}
        for i in range(self.num_numerical):
            spec[f"num_{i}"] = {"dtype": "float32"}
        for i, c in enumerate(self.categorical_cardinalities):
            spec[f"cat_{i}.bin"] = {"cardinality": int(c), "dtype": "int32"}
        with open(path, "w") as f:
            f.write(yaml_subset.dump({"feature_spec": spec}))


class CriteoBinaryDataset:
    """Memory-mapped binary split: label.bin (f32), numerical.bin
    (f32 x num_numerical), categorical.bin (i32 x n_tables)."""

    def __init__(self, directory: str, spec: FeatureSpec, batch_size: int,
                 drop_last: bool = True, shard: tuple[int, int] = (0, 1),
                 row_range: tuple[float, float] = (0.0, 1.0)):
        self.spec = spec
        self.batch_size = batch_size
        n_cat = len(spec.categorical_cardinalities)
        self.label = np.memmap(os.path.join(directory, "label.bin"),
                               np.float32, "r")
        n = self.label.shape[0]
        self.numerical = np.memmap(
            os.path.join(directory, "numerical.bin"), np.float32, "r"
        ).reshape(n, spec.num_numerical)
        self.categorical = np.memmap(
            os.path.join(directory, "categorical.bin"), np.int32, "r"
        ).reshape(n, n_cat)
        # fractional row window (train/held-out carve when there is no
        # separate test split dir — the reference's last-day convention),
        # then contiguous per-shard range (hosts stream disjoint slices)
        lo, hi = int(n * row_range[0]), int(n * row_range[1])
        idx, count = shard
        per = (hi - lo) // count
        self.start = lo + idx * per
        self.stop = lo + (idx + 1) * per if idx < count - 1 else hi
        self.drop_last = drop_last

    def __len__(self):
        n = self.stop - self.start
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _slice(self, s: int, e: int) -> dict:
        return {
            "numerical": np.log1p(np.maximum(
                np.asarray(self.numerical[s:e]), 0.0)),
            "categorical": np.asarray(self.categorical[s:e]),
            "label": np.asarray(self.label[s:e]),
        }

    def __iter__(self) -> Iterator[dict]:
        bs = self.batch_size
        n_full = (self.stop - self.start) // bs
        for i in range(n_full):
            s = self.start + i * bs
            yield self._slice(s, s + bs)
        tail = self.start + n_full * bs
        if not self.drop_last and tail < self.stop:
            yield self._slice(tail, self.stop)  # short tail batch (eval only)


def transcode_tsv(
    tsv_path: str, out_dir: str, spec: FeatureSpec, hash_unknown: bool = True
) -> int:
    """Criteo TSV (label \t 13 ints \t 26 hex) -> binary split. Returns rows.
    Categorical hex ids hash into each table's cardinality (the reference's
    preprocessing hashes with frequency thresholding; plain modulo hashing
    here — thresholding is an offline spark-stage concern)."""
    os.makedirs(out_dir, exist_ok=True)
    n_cat = len(spec.categorical_cardinalities)
    labels, nums, cats = [], [], []
    with open(tsv_path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 1 + spec.num_numerical + n_cat:
                parts = parts + [""] * (1 + spec.num_numerical + n_cat - len(parts))
            labels.append(float(parts[0] or 0))
            nums.append([
                float(p) if p else 0.0
                for p in parts[1 : 1 + spec.num_numerical]
            ])
            row = []
            for i, p in enumerate(parts[1 + spec.num_numerical :][:n_cat]):
                card = spec.categorical_cardinalities[i]
                row.append((int(p, 16) % card) if p else 0)
            cats.append(row)
    np.asarray(labels, np.float32).tofile(os.path.join(out_dir, "label.bin"))
    np.asarray(nums, np.float32).tofile(os.path.join(out_dir, "numerical.bin"))
    np.asarray(cats, np.int32).tofile(os.path.join(out_dir, "categorical.bin"))
    spec.to_yaml(os.path.join(out_dir, "feature_spec.yaml"))
    return len(labels)


def _iter_tsv_rows(tsv_path: str, num_numerical: int, n_cat: int):
    with open(tsv_path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            want = 1 + num_numerical + n_cat
            if len(parts) < want:
                parts = parts + [""] * (want - len(parts))
            yield parts


def preprocess_criteo_tsv(
    tsv_paths: list[str] | str,
    out_dir: str,
    *,
    frequency_threshold: int = 15,
    num_numerical: int = 13,
    n_cat: int = 26,
    test_split_last: bool = False,
) -> FeatureSpec:
    """Full Criteo preprocessing with frequency thresholding.

    The reference's offline stage (``DLRM/preproc/preproc_NVTabular.py`` /
    the Spark scripts, driven by ``prepare_dataset.sh`` with
    ``frequency_threshold=15``): per table, category values seen fewer than
    ``frequency_threshold`` times across the corpus all collapse into one
    "rare" bucket (id 0); frequent values get dense contiguous ids starting
    at 1, ordered by descending frequency (most-frequent = 1). The resulting
    per-table cardinality is ``1 + n_frequent`` — this is what shrinks
    Criteo 1TB's raw ~800M ids to the 26 table sizes in BASELINE.md.

    Two passes over the TSVs (count, then map+write); the host-side dict
    counting replaces the reference's Spark cluster for datasets that fit a
    single node — same semantics, documented scale limit.

    ``tsv_paths`` may be one path or a list (days). With ``test_split_last``
    the last file becomes ``out_dir/test`` (the reference's
    last-day-is-eval convention), the rest ``out_dir/train``; otherwise
    everything lands in ``out_dir`` flat.
    """
    if isinstance(tsv_paths, str):
        tsv_paths = [tsv_paths]

    # pass 1: frequency count per table
    counts: list[dict] = [{} for _ in range(n_cat)]
    for path in tsv_paths:
        for parts in _iter_tsv_rows(path, num_numerical, n_cat):
            for i, p in enumerate(parts[1 + num_numerical:][:n_cat]):
                if p:
                    c = counts[i]
                    c[p] = c.get(p, 0) + 1
    vocabs: list[dict] = []
    cards: list[int] = []
    for c in counts:
        frequent = sorted(
            (k for k, v in c.items() if v >= frequency_threshold),
            key=lambda k: (-c[k], k),
        )
        vocabs.append({k: i + 1 for i, k in enumerate(frequent)})
        cards.append(1 + len(frequent))
    spec = FeatureSpec(categorical_cardinalities=cards,
                       num_numerical=num_numerical)

    # pass 2: map + write binary splits
    def write_split(paths: list[str], directory: str) -> int:
        os.makedirs(directory, exist_ok=True)
        labels, nums, cats = [], [], []
        for path in paths:
            for parts in _iter_tsv_rows(path, num_numerical, n_cat):
                labels.append(float(parts[0] or 0))
                nums.append([float(p) if p else 0.0
                             for p in parts[1:1 + num_numerical]])
                cats.append([
                    vocabs[i].get(p, 0)
                    for i, p in enumerate(parts[1 + num_numerical:][:n_cat])
                ])
        np.asarray(labels, np.float32).tofile(
            os.path.join(directory, "label.bin"))
        np.asarray(nums, np.float32).tofile(
            os.path.join(directory, "numerical.bin"))
        np.asarray(cats, np.int32).tofile(
            os.path.join(directory, "categorical.bin"))
        spec.to_yaml(os.path.join(directory, "feature_spec.yaml"))
        return len(labels)

    if test_split_last and len(tsv_paths) > 1:
        write_split(tsv_paths[:-1], os.path.join(out_dir, "train"))
        write_split(tsv_paths[-1:], os.path.join(out_dir, "test"))
    else:
        write_split(tsv_paths, out_dir)
    return spec


def write_synthetic_dataset(
    out_dir: str, spec: FeatureSpec, n_rows: int, seed: int = 0
) -> None:
    """``prepare_synthetic_dataset.py`` role: random rows in binary layout."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    rng.integers(0, 2, n_rows).astype(np.float32).tofile(
        os.path.join(out_dir, "label.bin")
    )
    rng.normal(size=(n_rows, spec.num_numerical)).astype(np.float32).tofile(
        os.path.join(out_dir, "numerical.bin")
    )
    cats = np.stack(
        [rng.integers(0, c, n_rows) for c in spec.categorical_cardinalities],
        axis=1,
    ).astype(np.int32)
    cats.tofile(os.path.join(out_dir, "categorical.bin"))
    spec.to_yaml(os.path.join(out_dir, "feature_spec.yaml"))
