"""Deterministic synthetic data pipeline, a numpy copy of
``repro.train.data.TokenStream``.

Counter-based RNG (numpy Philox) gives O(1) random access to any step's
batch, so the pipeline is resumable by construction: restoring a
checkpoint at step k and asking for ``batch_at(k)`` reproduces exactly the
batch the interrupted run would have seen.  The counters and draws are the
reference's, so the batches are bitwise the JAX package's.  Per-host
sharding slices the global batch by host index.  ``stream_for_shape``
is the stream of one ``ShapeConfig`` cell.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.models.config import ModelConfig, ShapeConfig


@dataclasses.dataclass
class TokenStream:
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1

    def __post_init__(self):
        if self.batch % self.host_count:
            raise ValueError(f"batch {self.batch} does not split over "
                             f"{self.host_count} hosts")
        self.local_batch = self.batch // self.host_count

    def _rng(self, step: int) -> np.random.Generator:
        # counter = (step, host); key = seed  -> random-access determinism
        return np.random.Generator(np.random.Philox(
            key=self.seed, counter=[0, 0, self.host_index, step]))

    def _perm(self) -> np.ndarray:
        """Per-seed token-transition permutation (the learnable signal)."""
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[1, 0, 0, 0]))
        return rng.permutation(self.cfg.vocab)

    def _tokens(self, rng, B: int, n: int) -> np.ndarray:
        """Markov sequences: t_{i+1} = perm[t_i] with 15% uniform noise,
        random-accessible and learnable (the loss can drop below ln(V))."""
        perm = self._perm()
        out = np.empty((B, n), dtype=np.int64)
        out[:, 0] = rng.integers(0, self.cfg.vocab, B)
        noise = rng.random((B, n)) < 0.15
        rand = rng.integers(0, self.cfg.vocab, (B, n))
        for i in range(1, n):
            out[:, i] = np.where(noise[:, i], rand[:, i],
                                 perm[out[:, i - 1]])
        return out

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg, S, B = self.cfg, self.seq, self.local_batch
        rng = self._rng(step)
        out: Dict[str, np.ndarray] = {}
        if cfg.family == "vlm":
            P = cfg.num_prefix_embeds
            out["embeds"] = rng.standard_normal(
                (B, P, cfg.d_model), dtype=np.float32) * 0.02
            toks = self._tokens(rng, B, S - P + 1)
        elif cfg.family == "encdec":
            out["frames"] = rng.standard_normal(
                (B, S, cfg.d_model), dtype=np.float32) * 0.02
            toks = self._tokens(rng, B, S + 1)
        else:
            toks = self._tokens(rng, B, S + 1)
        out["tokens"] = toks[:, :-1].astype(np.int32)
        out["labels"] = toks[:, 1:].astype(np.int32)
        return out


def stream_for_shape(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                     host_index: int = 0, host_count: int = 1,
                     batch_override: Optional[int] = None) -> TokenStream:
    return TokenStream(cfg, batch_override or shape.global_batch,
                       shape.seq_len, seed, host_index, host_count)
