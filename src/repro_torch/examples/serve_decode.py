"""Serving example: prefill a batch of prompts, then decode tokens
autoregressively against the KV / SSM caches.

The port of ``examples/serve_decode.py``:

  python -m repro_torch.examples.serve_decode [--arch mixtral-8x22b]
      [--prompt-len 48] [--new-tokens 16] [--device cpu]

Runs the reduced (-smoke) variant of ``--arch`` with random weights from
seed 0, greedy, through ``models.transformer.prefill`` / ``decode_step``:
token prompts for the token archs, frames for the audio stub (a fresh
frame each step), a patch prefix before the prompt for the VLM stub.  The
inputs are a numpy stream of the example's own (seed 0).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.train import resolve_device
from repro_torch.models import transformer as T


def main(arch: str = "mixtral-8x22b", prompt_len: int = 48,
         new_tokens: int = 16, device: str = "cuda") -> torch.Tensor:
    """Returns the generated tokens (B, new_tokens + 1), the first from the
    prefill."""
    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    T.check_serving(cfg)
    rng = np.random.default_rng(0)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    b, s = 2, prompt_len

    def frames(n):
        return torch.from_numpy(rng.standard_normal(
            (b, n, cfg.d_model)).astype(np.float32)).to(dev)

    if cfg.embed_kind == "embeddings":
        prompt = {"embeddings": frames(s)}
    else:
        prompt = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (b, s)).astype(np.int32)).to(dev)}
    n_pre = 0
    if cfg.embed_kind == "prefix":
        n_pre = cfg.n_prefix
        prompt["patch_embeds"] = frames(n_pre)
    with torch.inference_mode():
        logits, caches = T.prefill(params, prompt, cfg,
                                   cache_len=n_pre + s + new_tokens)
        n_leaves = sum(len(c) for c in caches.values())
        print(f"prefilled {s} tokens; cache leaves: {n_leaves}")
        tok = logits[:, :cfg.vocab].argmax(dim=-1)
        generated = [tok]
        for i in range(new_tokens):
            step_in = {"embeddings": frames(1)} \
                if cfg.embed_kind == "embeddings" else {"tokens": tok[:, None]}
            logits, caches = T.decode_step(params, step_in, caches,
                                           n_pre + s + i, cfg)
            tok = logits[:, :cfg.vocab].argmax(dim=-1)
            generated.append(tok)
    out = torch.stack(generated, dim=1).cpu()
    print(f"decoded {new_tokens} tokens per sequence:")
    for i in range(b):
        print(f"  seq {i}: {out[i].tolist()}")
    return out


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mixtral-8x22b")
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    main(args.arch, args.prompt_len, args.new_tokens, args.device)


if __name__ == "__main__":
    cli()
