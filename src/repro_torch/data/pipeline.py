"""Deterministic, shard-aware token data pipeline with background prefetch.

Sources:
  - SyntheticSource: seeded per (step, shard) -> reproducible across
    restarts and across different data-parallel layouts (elastic restore
    keeps the stream aligned because seeding is by *global* step).
  - MemmapSource: flat uint16/uint32 token file, strided deterministically.

The pipeline yields host numpy batches; the train driver moves them to
its device.  A copy of `repro/data/pipeline.py` (numpy and stdlib only),
held to it by the AST copy check in `tests/test_torch_core.py`.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from pathlib import Path
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"          # synthetic | memmap
    path: str | None = None
    prefetch: int = 2


class SyntheticSource:
    """Markov-ish synthetic tokens: deterministic f(seed, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step]))
        b, s = self.cfg.global_batch, self.cfg.seq_len
        # low-entropy structure so tiny models can actually learn
        base = rng.integers(0, self.cfg.vocab, (b, 1), dtype=np.int64)
        drift = rng.integers(0, 7, (b, s), dtype=np.int64)
        toks = (base + np.cumsum(drift, axis=1)) % self.cfg.vocab
        return toks.astype(np.int32)


class MemmapSource:
    def __init__(self, cfg: DataConfig):
        assert cfg.path is not None
        self.cfg = cfg
        self.tokens = np.memmap(cfg.path, dtype=np.uint16, mode="r")
        self.n = len(self.tokens) - cfg.seq_len - 1

    def batch(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step]))
        b, s = self.cfg.global_batch, self.cfg.seq_len
        starts = rng.integers(0, self.n, (b,))
        out = np.stack([self.tokens[i:i + s] for i in starts])
        return out.astype(np.int32) % self.cfg.vocab


def make_source(cfg: DataConfig):
    if cfg.source == "synthetic":
        return SyntheticSource(cfg)
    if cfg.source == "memmap":
        return MemmapSource(cfg)
    raise ValueError(cfg.source)


class Pipeline:
    """Background-prefetching iterator of {"tokens": [B, S]} batches."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.source = make_source(cfg)
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        step = self._step
        while not self._stop.is_set():
            batch = {"tokens": self.source.batch(step)}
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
