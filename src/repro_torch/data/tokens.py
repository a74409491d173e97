"""Checkpointable synthetic token stream for LM serving and training
(counterpart of ``repro.data.tokens``).

A deterministic function of (seed, step), through a ``torch.Generator``
seeded from the pair: restoring at step t and continuing gives the same
batches as an uninterrupted run.  The tokens mix a Zipfian unigram with a
per-sequence repeated motif, so a model has structure to fit.  The draws
are not ``jax.random``'s: the same (seed, step) gives other tokens than
``repro``'s stream, with the same distribution.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import resolve_device

_MASK64 = (1 << 64) - 1


def _stream_seed(seed: int, step: int) -> int:
    """splitmix64 of (seed, step): a generator seed that differs for
    neighbouring seeds and steps."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(step) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 16
    p_motif: float = 0.35

    def _zipf_probs(self) -> torch.Tensor:
        ranks = torch.arange(1, self.vocab_size + 1, dtype=torch.float64)
        w = ranks ** -self.zipf_a
        return w / w.sum()

    def _draw(self, step: int):
        """(unigram tokens, motif tokens at each position, motif picks),
        each (batch, seq_len), on the CPU."""
        g = torch.Generator().manual_seed(_stream_seed(self.seed, step))
        probs = self._zipf_probs()
        b, s, m = self.batch, self.seq_len, self.motif_len
        uni = torch.multinomial(probs, b * s, replacement=True,
                                generator=g).view(b, s)
        motif = torch.multinomial(probs, b * m, replacement=True,
                                  generator=g).view(b, m)
        phase = torch.randint(0, m, (b, 1), generator=g)
        rep = motif.gather(1, (torch.arange(s)[None, :] + phase) % m)
        pick = torch.rand((b, s), generator=g) < self.p_motif
        return uni, rep, pick

    def batch_at(self, step: int, device=None) -> dict:
        """Batch for ``step``: {"tokens": (batch, seq_len) int64} on
        ``device`` (CUDA unless ``device="cpu"``); drawn on the CPU, so
        every device gets the same tokens."""
        dev = resolve_device(device)
        uni, rep, pick = self._draw(int(step))
        return {"tokens": torch.where(pick, rep, uni).to(dev)}

    def state(self, step: int) -> dict:
        """Serializable pipeline state for the checkpoint manifest."""
        return {"seed": self.seed, "step": int(step)}

    @staticmethod
    def resume(cfg: "TokenStream", state: dict) -> tuple["TokenStream", int]:
        if state["seed"] != cfg.seed:
            raise ValueError("stream seed mismatch on restore")
        return cfg, int(state["step"])
