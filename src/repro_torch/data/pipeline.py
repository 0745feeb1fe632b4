"""Deterministic synthetic token pipeline: document stream -> packed batches.

The port's copy of ``src/repro/data/pipeline.py`` (numpy only; the port
imports nothing of the JAX package). Batches stay numpy arrays, equal bit
for bit to the reference's; the train loop moves them to its device.

- Zipf-distributed token ids over the model vocab, seeded => reproducible.
- Documents packed back-to-back into fixed-length rows with EOS separators;
  the loss mask zeroes the EOS boundary predictions.
- ``state()``/``restore()``/``skip_to(step)`` give deterministic resume after
  checkpoint restart (fault tolerance: the pipeline is part of the state).
- Optional background prefetch thread keeps ``prefetch`` batches ready.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticPacked:
    def __init__(self, vocab_size: int, seq_len: int, batch: int, *,
                 seed: int = 0, mean_doc_len: int = 180, eos_id: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch
        self.seed = seed
        self.mean_doc = mean_doc_len
        self.eos = eos_id
        self.step = 0

    # -- deterministic batch synthesis -------------------------------------------
    def _batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 32) ^ step)
        rows = []
        masks = []
        for _ in range(self.batch):
            row = np.empty(self.seq + 1, np.int64)
            mask = np.ones(self.seq + 1, np.float32)
            pos = 0
            while pos < self.seq + 1:
                n = max(int(rng.exponential(self.mean_doc)), 4)
                doc = rng.zipf(1.3, size=n) % (self.vocab - 2) + 1
                take = min(n, self.seq + 1 - pos)
                row[pos:pos + take] = doc[:take]
                pos += take
                if pos < self.seq + 1:
                    row[pos] = self.eos
                    mask[pos] = 0.0   # don't train the doc boundary
                    pos += 1
            rows.append(row)
            masks.append(mask)
        toks = np.stack(rows)
        mask = np.stack(masks)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32),
                "mask": mask[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self._batch_at(self.step)
        self.step += 1
        return b

    # -- resume ------------------------------------------------------------------
    def state(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: Dict) -> None:
        assert state["seed"] == self.seed, "pipeline seed mismatch on resume"
        self.step = state["step"]

    def skip_to(self, step: int) -> None:
        self.step = step


class Prefetcher:
    """Background-thread prefetch wrapper (overlap host data work with step)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.it = it
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = False
        self.t = threading.Thread(target=self._worker, daemon=True)
        self.t.start()

    def _worker(self):
        try:
            for item in self.it:
                if self._stop:
                    return
                self.q.put(item)
        finally:
            self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop = True
