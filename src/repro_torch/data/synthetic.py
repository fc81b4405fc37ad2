"""Synthetic LM token streams, drawn with explicit ``torch.Generator``s.

``lm_batch_fn`` is the bigram-teacher stream of the JAX package's
``data/synthetic.py``: a fixed low-entropy (V, V) transition table and
sequences sampled from it, so loss curves mean something. The draws differ
from JAX's (torch cannot reproduce jax.random); parity tests feed both
packages the same numpy batches instead.

The table is (V, V) float32: 1 MB at the reduced configs' V=512, but
92 GB at Qwen3's V=151936, which fits on no single card. Full-width runs
use ``uniform_batch_fn`` (uniform random tokens) until a stream that
scales to that vocabulary exists (ROADMAP).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def bigram_table(gen, vocab: int, concentration: float = 0.3,
                 device="cpu") -> torch.Tensor:
    """Row-stochastic transition matrix with low entropy (learnable)."""
    logits = torch.randn((vocab, vocab), generator=gen, device=device)
    return torch.softmax(logits / concentration, dim=-1)


def sample_lm(gen, table, batch: int, seq_len: int) -> torch.Tensor:
    """(batch, seq_len) int64 token sequences from the bigram teacher."""
    vocab = table.shape[0]
    tok = torch.randint(0, vocab, (batch,), generator=gen,
                        device=table.device)
    toks = [tok]
    for _ in range(seq_len - 1):
        tok = torch.multinomial(table[tok], 1, generator=gen)[:, 0]
        toks.append(tok)
    return torch.stack(toks, dim=1)


def _table_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def lm_batch_fn(model_cfg: ModelConfig, num_learners: int, k_steps: int,
                batch: int, seq_len: int, table_seed: int = 1234,
                device="cuda"):
    """Returns ``batch_fn(gen, step)`` producing (L, K, B, S) batches."""
    table = bigram_table(_table_generator(table_seed, device),
                         model_cfg.vocab_size, device=device)

    def batch_fn(gen, step):
        toks = torch.stack([
            sample_lm(gen, table, batch, seq_len)
            for _ in range(num_learners * k_steps)
        ]).view(num_learners, k_steps, batch, seq_len)
        return {"tokens": toks, "labels": toks}

    return batch_fn


def lm_eval_set(model_cfg: ModelConfig, n: int = 64, seq_len: int = 64,
                table_seed: int = 1234, seed: int = 98, device="cuda"):
    table = bigram_table(_table_generator(table_seed, device),
                         model_cfg.vocab_size, device=device)
    toks = sample_lm(_table_generator(seed, device), table, n, seq_len)
    return {"tokens": toks, "labels": toks}


def uniform_batch_fn(model_cfg: ModelConfig, num_learners: int,
                     k_steps: int, batch: int, seq_len: int):
    """``batch_fn(gen, step)``: (L, K, B, S) tokens uniform over the
    vocabulary, on ``gen``'s device. No teacher, so the loss stays near
    ln V; it exercises the full-width path, it does not measure
    learning."""

    def batch_fn(gen, step):
        toks = torch.randint(
            0, model_cfg.vocab_size,
            (num_learners, k_steps, batch, seq_len),
            generator=gen, device=gen.device,
        )
        return {"tokens": toks, "labels": toks}

    return batch_fn
