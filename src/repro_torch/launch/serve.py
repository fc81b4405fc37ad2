"""Serving launcher of the port: batched autoregressive decoding of the
dense and MoE transformers, Hymba and xLSTM (prefill, then one
``decode_step`` per token against the KV cache or the recurrent state).
Encoder-only configs (``hubert-xlarge``) are refused: they have no decode
path.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --batch 2 --tokens 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b

It serves the reduced config with random weights from a seeded generator,
as the JAX launcher does; the flags mean what they mean there, and
``--device`` (default ``cuda``) picks the card or the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.models import api as model_api


def generate(params, cfg, prompt_tokens, max_new: int, cache_len: int,
             temperature: float = 0.0, seed: int = 0,
             use_pallas: bool = False):
    """Greedy or temperature batched generation. prompt: (B, S0) int on the
    params' device -> (B, max_new) int32 tokens. ``use_pallas`` goes to
    ``prefill`` (the flash kernel). Greedy decoding is argmax; sampling
    draws from a ``torch.Generator`` seeded by ``seed`` on the prompt's
    device (JAX's ``jax.random.categorical`` stream cannot be reproduced).

    Raises ``ValueError`` before prefill when a full-attention config's
    cache cannot hold the prompt and the ``max_new`` decoded tokens
    (``cache_len < S0 + max_new``): JAX clamps the write and overwrites the
    cache's last row, the port's in-place write would fault on the card
    (see ``models/transformer.py::decode_step``). Sliding-window configs
    (Hymba among them) keep a rolling cache, and xLSTM's cache is its
    recurrent state: they take any length.
    """
    S0 = prompt_tokens.shape[1]
    full_kv = cfg.family != "ssm" and not cfg.sliding_window
    if full_kv and cache_len < S0 + max_new:
        raise ValueError(
            f"cache_len {cache_len} < prompt {S0} + max_new {max_new}: "
            f"the KV cache has no row for the later tokens")
    logits, cache = model_api.prefill(params, cfg, {"tokens": prompt_tokens},
                                      cache_len, use_pallas=use_pallas)
    gen = None
    if temperature > 0:
        gen = torch.Generator(device=prompt_tokens.device).manual_seed(seed)
    out = []
    for _ in range(max_new):
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            tok = torch.argmax(logits, dim=-1)
        tok = tok.to(torch.int32)
        out.append(tok)
        logits, cache = model_api.decode_step(params, cfg, cache, tok)
    return torch.stack(out, dim=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    if not cfg.supports_decode:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path")
    device = torch.device(args.device)
    params = model_api.init_params(
        torch.Generator(device=device).manual_seed(0), cfg, device)
    prompt = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), device=device,
        generator=torch.Generator(device=device).manual_seed(1),
        dtype=torch.int32)
    cache_len = args.prompt_len + args.tokens + 8
    t0 = time.perf_counter()
    with torch.no_grad():
        out = generate(params, cfg, prompt, args.tokens, cache_len,
                       temperature=args.temperature)
    ids = out[0][:16].tolist()  # waits for the device
    dt = time.perf_counter() - t0
    print(f"arch={args.arch} batch={args.batch} generated {args.tokens} "
          f"tokens/seq in {dt:.2f}s "
          f"({args.batch * args.tokens / dt:.1f} tok/s) on {device}")
    print("sample token ids:", ids)


if __name__ == "__main__":
    main()
