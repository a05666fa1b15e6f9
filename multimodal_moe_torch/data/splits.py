"""Stratified train/val/test split creation, without sklearn.

The port's own copy of ``multimodal_moe_tpu/data/splits.py``: a two-stage
80/10/10 split stratified on ``ped_bin_4 + "_" + time_of_day``. JAX's calls
sklearn's ``train_test_split`` twice (``random_state=seed``); sklearn is
not among the card host's packages, so :func:`stratified_split_positions`
redoes in numpy what ``train_test_split(..., stratify=y)`` computes
(``StratifiedShuffleSplit._iter_indices`` and ``_approximate_mode`` of
sklearn 1.x): the same rows in the same order from the same
``np.random.RandomState(seed)`` draws, and a ``ValueError`` in the same
cases (``tests/test_torch_ingest_modules.py``). pandas is imported where it
is used.
"""

from __future__ import annotations

from math import ceil
from pathlib import Path

import numpy as np


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """The per-class draw counts closest to ``class_counts`` scaled to
    ``n_draws``: floors first, then one more to the classes of the largest
    remainders, ties broken by ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        values = np.sort(np.unique(remainder))[::-1]
        for value in values:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split_positions(y, test_size: float, seed: int
                               ) -> "tuple[np.ndarray, np.ndarray]":
    """Train and test row positions of a shuffled split stratified on the
    labels ``y``: ``ceil(test_size·n)`` test rows, the rest train."""
    y = np.asarray(y, dtype=object)
    n_samples = len(y)
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size={test_size} should be a float in the (0, 1) range")
    n_test = ceil(test_size * n_samples)
    n_train = n_samples - n_test
    if n_train == 0:
        raise ValueError(
            f"With n_samples={n_samples}, test_size={test_size} and train_size=None, the "
            "resulting train set will be empty. Adjust any of the aforementioned parameters.")

    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    n_classes = classes.shape[0]
    if np.min(class_counts) < 2:
        raise ValueError(
            "The least populated classes in y have only 1 member, which is too few. The "
            "minimum number of groups for any class cannot be less than 2. Classes with too "
            f"few members are: {classes[class_counts < 2].tolist()}")
    if n_train < n_classes:
        raise ValueError(f"The train_size = {n_train} should be greater or equal to the "
                         f"number of classes = {n_classes}")
    if n_test < n_classes:
        raise ValueError(f"The test_size = {n_test} should be greater or equal to the "
                         f"number of classes = {n_classes}")

    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train: list = []
    test: list = []
    for i in range(n_classes):
        members = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(members[: n_i[i]])
        test.extend(members[n_i[i]: n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def create_stratified_splits(df, seed: int = 0, test_size: float = 0.20) -> "dict":
    """Split frames 80/10/10 stratified by ``ped_bin_4 × time_of_day``;
    each split a ``pandas.DataFrame`` of the input's rows (index labels
    kept) with a ``strat_key`` column."""
    df = df.copy()
    df["time_of_day"] = df["time_of_day"].fillna("unknown").astype(str)
    df["ped_bin_4"] = df["ped_bin_4"].astype(int)
    df["strat_key"] = df["ped_bin_4"].astype(str) + "_" + df["time_of_day"]

    train_pos, temp_pos = stratified_split_positions(df["strat_key"], test_size, seed)
    train_df, temp_df = df.iloc[train_pos], df.iloc[temp_pos]
    val_pos, test_pos = stratified_split_positions(temp_df["strat_key"], 0.50, seed)
    return {"train": train_df, "val": temp_df.iloc[val_pos], "test": temp_df.iloc[test_pos]}


def write_split_csvs(splits: "dict", output_dir: "str | Path") -> "dict[str, Path]":
    """Write ``{split}_ids.csv`` files holding only ``frame_id`` columns."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    out = {}
    for split_name, split_df in splits.items():
        path = output_dir / f"{split_name}_ids.csv"
        split_df[["frame_id"]].to_csv(path, index=False)
        out[split_name] = path
    return out
