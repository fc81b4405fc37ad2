"""Synthetic data streams, drawn with explicit ``torch.Generator``s.

``lm_batch_fn`` is the bigram-teacher stream of the JAX package's
``data/synthetic.py``: a fixed low-entropy (V, V) transition table and
sequences sampled from it, so loss curves mean something.
``classif_batch_fn`` is its teacher-classification stream (the paper's
CIFAR-10 stand-in): Gaussian features labelled by a fixed random tanh
teacher network. The draws differ from JAX's (torch cannot reproduce
jax.random); parity tests feed both packages the same numpy batches
instead.

The table is (V, V) float32: 1 MB at the reduced configs' V=512, but
92 GB at Qwen3's V=151936, which fits on no single card. Full-width runs
use ``uniform_batch_fn`` (uniform random tokens) until a stream that
scales to that vocabulary exists (ROADMAP).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig


def bigram_table(gen, vocab: int, concentration: float = 0.3) -> torch.Tensor:
    """Row-stochastic transition matrix with low entropy (learnable), on
    ``gen``'s device."""
    logits = torch.randn((vocab, vocab), generator=gen, device=gen.device)
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
                         model_cfg.vocab_size)

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
                         model_cfg.vocab_size)
    toks = sample_lm(_table_generator(seed, device), table, n, seq_len)
    return {"tokens": toks, "labels": toks}


# ---------------------------------------------------------------------------
# teacher-network classification stream (the paper's CIFAR-10 stand-in)
# ---------------------------------------------------------------------------


def make_teacher(seed: int, d_in: int, classes: int, hidden: int = 64,
                 device="cuda") -> dict:
    gen = _table_generator(seed, device)
    return {
        "w1": torch.randn((d_in, hidden), generator=gen, device=device)
        / math.sqrt(d_in),
        "w2": torch.randn((hidden, classes), generator=gen, device=device)
        / math.sqrt(hidden),
    }


def _teacher_labels(teacher, x) -> torch.Tensor:
    """int32 argmax labels of the teacher on features ``x`` (..., d_in)."""
    h = torch.tanh(x @ teacher["w1"])
    return torch.argmax(h @ teacher["w2"], dim=-1).to(torch.int32)


def classif_batch_fn(d_in: int, classes: int, num_learners: int,
                     k_steps: int, batch: int, teacher_seed: int = 7,
                     noise: float = 0.0, device="cuda"):
    """Returns ``batch_fn(gen, step)`` producing {'x': (L, K, B, d_in) f32,
    'y': (L, K, B) int32} on ``device``. The features are drawn on
    ``gen``'s device (a CPU generator gives both devices the same batch),
    labelled by the teacher before ``noise`` is added, as in JAX."""
    teacher = make_teacher(teacher_seed, d_in, classes, device=device)
    shape = (num_learners, k_steps, batch, d_in)

    def batch_fn(gen, step):
        x = torch.randn(shape, generator=gen, device=gen.device)
        y = _teacher_labels(teacher, x.to(device))
        if noise:
            x = x + noise * torch.randn(shape, generator=gen,
                                        device=gen.device)
        return {"x": x.to(device), "y": y}

    return batch_fn


def classif_eval_set(d_in: int, classes: int, n: int = 2048,
                     teacher_seed: int = 7, seed: int = 99, device="cuda"):
    """A fixed (n, d_in) evaluation set with its teacher labels."""
    teacher = make_teacher(teacher_seed, d_in, classes, device=device)
    x = torch.randn((n, d_in), generator=_table_generator(seed, device),
                    device=device)
    return {"x": x, "y": _teacher_labels(teacher, x)}


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
