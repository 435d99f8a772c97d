"""Synthetic Criteo-like click log (a verbatim numpy copy of
``repro.data.synthetic.ClickLogDataset``: the same seed yields
byte-identical batches).

13 continuous features, 26 categorical features with Zipf-distributed ids
(the power-law access skew that makes CPR-MFU/SSU work, paper Fig. 6), and
labels produced by a hidden logistic "teacher" so the task is learnable
and failure-induced parameter loss measurably degrades AUC.  Batches are
dicts of numpy arrays; the emulator moves them to its device.
"""
from __future__ import annotations

import numpy as np


class ClickLogDataset:
    def __init__(self, table_sizes, num_dense=13, num_samples=200_000,
                 multi_hot=1, zipf_a=1.2, seed=0, teacher_dim=16):
        self.table_sizes = tuple(table_sizes)
        self.num_dense = num_dense
        self.num_samples = num_samples
        self.multi_hot = multi_hot
        rng = np.random.default_rng(seed)
        self.rng = rng
        F = len(table_sizes)

        # Zipf ranks -> per-table id permutation so hot ids differ per table.
        self.perms = [rng.permutation(n) for n in self.table_sizes]
        self.zipf_a = zipf_a

        # hidden teacher: logistic model over dense feats + per-id effects
        self.teacher_dense = rng.normal(size=(num_dense,)) / np.sqrt(num_dense)
        self.teacher_emb = [rng.normal(size=(n,)) * 0.7 for n in self.table_sizes]
        self.bias = -0.3

        # pregenerate in blocks for determinism
        self._dense = rng.normal(size=(num_samples, num_dense)).astype(np.float32)
        sparse = np.empty((num_samples, F, multi_hot), np.int64)
        for f, n in enumerate(self.table_sizes):
            ranks = rng.zipf(zipf_a, size=(num_samples, multi_hot)) - 1
            ranks = np.minimum(ranks, n - 1)
            sparse[:, f, :] = self.perms[f][ranks]
        self._sparse = sparse.astype(np.int32)
        logits = self._dense @ self.teacher_dense + self.bias
        for f in range(F):
            logits = logits + np.mean(
                self.teacher_emb[f][self._sparse[:, f, :]], axis=1)
        p = 1.0 / (1.0 + np.exp(-logits))
        self._label = (rng.uniform(size=num_samples) < p).astype(np.float32)
        self.ctr = float(self._label.mean())

    def __len__(self):
        return self.num_samples

    def batches(self, batch_size, start=0, end=None, loop=False):
        """Yield dict batches of numpy arrays in [start, end)."""
        end = end if end is not None else self.num_samples
        i = start
        while True:
            j = min(i + batch_size, end)
            if j <= i:
                if not loop:
                    break
                i = start
                continue
            if j - i < batch_size and loop:
                i = start
                continue
            yield {
                "dense": self._dense[i:j],
                "sparse": self._sparse[i:j],
                "label": self._label[i:j],
            }
            i = j
            if i >= end:
                if not loop:
                    break
                i = start

    def eval_split(self, frac=0.1):
        n = int(self.num_samples * (1 - frac))
        return (0, n), (n, self.num_samples)
