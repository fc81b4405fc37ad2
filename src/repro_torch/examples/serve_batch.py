"""Batched serving: prefill a prompt batch, then greedy decode with the KV
cache, for every decode-capable architecture at reduced scale (the JAX
package's ``examples/serve_batch.py``, on the port's ``prefill`` and
``decode_step``).

The dense, MoE, hybrid (Hymba) and SSM (xLSTM) architectures are served.
``hubert-xlarge`` is encoder-only and skipped; ``internvl2-76b``, whose
inputs come from a stub frontend, runs the reference's decode-only demo
from an empty cache. Attention is plain PyTorch here, as the reference's
example does not set ``use_pallas``.

  PYTHONPATH=src python -m repro_torch.examples.serve_batch \\
      [--arch qwen3-1.7b] [--device cpu]

``serve(..., params=, prompt=)`` takes JAX's initial params and prompt in
a parity test.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.models import api as model_api
from repro_torch.utils.rng import seeded_generator
from repro_torch.utils.tree import tree_map

def serve(arch: str, batch: int, prompt_len: int, new_tokens: int,
          device="cuda", params: Optional[dict] = None,
          prompt: Optional[torch.Tensor] = None, log=print):
    """Greedy tokens (batch, new_tokens) of ``arch``'s reduced config, or
    None for an encoder-only config."""
    cfg = get_config(arch).reduced()
    if not cfg.supports_decode:
        log(f"{arch}: encoder-only, no decode (skipped)")
        return None
    if cfg.input_mode != "tokens":
        log(f"{arch}: stub-frontend input; decode-only demo")
    dev = torch.device(device)
    if params is None:
        params = model_api.init_params(seeded_generator(dev, 0), cfg, dev)
    else:
        params = tree_map(lambda x: x.to(dev), params)
    if prompt is None:
        prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                               generator=seeded_generator(dev, 1),
                               device=dev, dtype=torch.int32)
    else:
        prompt = prompt.to(dev)
    cache_len = prompt_len + new_tokens + 8
    with torch.no_grad():
        if cfg.input_mode == "tokens":
            logits, cache = model_api.prefill(params, cfg,
                                              {"tokens": prompt}, cache_len)
        else:  # vlm: decode from an empty cache for the demo
            cache = model_api.init_cache(cfg, batch, cache_len, device=dev)
            logits = torch.zeros((batch, cfg.vocab_size), device=dev)
        toks = []
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(new_tokens):
            nxt = torch.argmax(logits, -1).to(torch.int32)
            toks.append(nxt)
            logits, cache = model_api.decode_step(params, cfg, cache, nxt)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    log(f"{arch}: {batch} seqs x {new_tokens} tokens in {dt:.2f}s "
        f"({batch * new_tokens / dt:.1f} tok/s), cache pos "
        f"{int(cache['pos'])}")
    return torch.stack(toks, dim=1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="default: every decode-capable arch")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else ARCH_IDS
    return {a: serve(a, args.batch, args.prompt_len, args.tokens,
                     device=args.device) for a in archs}


if __name__ == "__main__":
    main()
