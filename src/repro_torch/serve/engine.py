"""Batched serving engine: prefill + autoregressive decode with KV / SSM
caches, temperature / top-k sampling and per-sequence stop handling, as
``repro/serve/engine.py`` on one device.

The engine drives ``models.transformer.prefill`` / ``decode_step`` for
every decoding family with token prompts (the VLM stub with its patch
prefix); the audio stub, whose inputs are frames, is driven through
``decode_step`` directly, as in the reference.  With
``attn_impl="pallas"`` the prefill's attention runs the flash-attention
kernel.  On the card everything runs on the card: ``device="cuda"``
without one raises, and nothing falls back to the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.train import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.ssm import F32_LEAVES

# leaves the reference reads in f32 whatever the compute dtype: the norm
# scales, the MoE router and the SSM's decay, skip and dt bias
_KEEP_F32 = ("norm1", "norm2", "norm_f", "router") + F32_LEAVES


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0        # 0 => greedy
    top_k: int = 0                  # 0 => full softmax
    eos_id: Optional[int] = None


def _sample(logits: torch.Tensor, gen: torch.Generator,
            gc: GenerationConfig, vocab: int) -> torch.Tensor:
    """logits (B, V_pad) -> token ids (B,) int32.  Sampling is the
    Gumbel-max draw of ``jax.random.categorical``, from ``gen``'s bits."""
    logits = logits[:, :vocab].to(torch.float32)
    if gc.temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits / gc.temperature
    if gc.top_k > 0:
        kth = torch.topk(logits, gc.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, -1e30, logits)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1).to(
        torch.int32)


class _Clock:
    """Marks on the device's timeline: CUDA events on the card (no host
    sync until :meth:`intervals_ms`), the host clock on the CPU, where
    every operation has finished when it returns."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in
                    zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


class ServeEngine:
    """Holds the params on the serving device; serves batches of token
    prompts.

    The weight matrices and the embedding table are cast to the compute
    dtype once, here, instead of at every call: that gives the same
    numbers as the reference's per-call ``.astype(dtype)``.  The leaves
    the reference reads uncast stay f32: the norm scales, the MoE router,
    and the SSM's ``A_log``, ``D`` and ``dt_bias``.
    """

    def __init__(self, cfg: ArchConfig, params: Dict[str, torch.Tensor],
                 device: str = "cuda"):
        T.check_serving(cfg)
        if cfg.embed_kind not in ("tokens", "prefix"):
            raise ValueError(
                f"the engine serves token prompts; {cfg.name!r} takes "
                f"{cfg.embed_kind!r} (drive models.transformer.decode_step "
                "directly)")
        self.cfg = cfg
        self.device = resolve_device(device)
        dtype = getattr(torch, cfg.compute_dtype)
        self.params = {
            path: t.to(self.device, torch.float32
                       if path.rsplit(".", 1)[-1] in _KEEP_F32 else dtype)
            for path, t in params.items()}

    def generate(self, prompts: torch.Tensor, gc: GenerationConfig,
                 generator: Optional[torch.Generator] = None,
                 prefix_embeds: Optional[torch.Tensor] = None) -> dict:
        """prompts: (B, S) int (equal-length prompts, no padding);
        ``prefix_embeds`` (B, n_prefix, d): the VLM's patch prefix, which
        the prompt follows.

        Returns {"tokens": (B, max_new_tokens) int32, "n_valid": (B,)
        int32, "prefill_ms": time to the first token, "decode_ms": one
        entry per decode step}; the times are on the device's timeline."""
        if gc.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        cfg = self.cfg
        prompts = prompts.to(self.device)
        b, s = prompts.shape
        batch = {"tokens": prompts}
        n_pre = 0
        if cfg.embed_kind == "prefix":
            n_pre = cfg.n_prefix
            if prefix_embeds is None or tuple(prefix_embeds.shape) != (
                    b, n_pre, cfg.d_model):
                raise ValueError(f"{cfg.name!r} needs prefix_embeds of "
                                 f"shape {(b, n_pre, cfg.d_model)}")
            batch["patch_embeds"] = prefix_embeds.to(self.device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        clock = _Clock(self.device)
        with torch.inference_mode():
            clock.mark()
            logits, caches = T.prefill(self.params, batch, cfg,
                                       cache_len=n_pre + s
                                       + gc.max_new_tokens)
            tok = _sample(logits, generator, gc, cfg.vocab)
            clock.mark()
            out = [tok]
            alive = torch.ones(b, dtype=torch.bool, device=self.device)
            if gc.eos_id is not None:
                alive = alive & (tok != gc.eos_id)
            for i in range(gc.max_new_tokens - 1):
                logits, caches = T.decode_step(
                    self.params, {"tokens": tok[:, None]}, caches,
                    n_pre + s + i, cfg)
                nxt = _sample(logits, generator, gc, cfg.vocab)
                if gc.eos_id is not None:
                    nxt = torch.where(alive, nxt, gc.eos_id).to(torch.int32)
                    alive = alive & (nxt != gc.eos_id)
                out.append(nxt)
                tok = nxt
                clock.mark()
            tokens = torch.stack(out, dim=1)
            if gc.eos_id is not None:
                n_valid = torch.cumprod((tokens != gc.eos_id).to(
                    torch.int32), dim=1).sum(dim=1).to(torch.int32)
            else:
                n_valid = torch.full((b,), gc.max_new_tokens,
                                     dtype=torch.int32, device=self.device)
        times = clock.intervals_ms()
        return {"tokens": tokens, "n_valid": n_valid,
                "prefill_ms": times[0], "decode_ms": times[1:]}
