"""Architecture, input-shape and optimizer-recipe configuration.

The port's copy of ``repro/configs/base.py``: every family's fields (MoE,
Mamba-1 SSM, the Jamba hybrid layout, the audio and VLM input stubs), the
derived sizes (``d_inner``, ``dt_rank``, ``padded_vocab``,
``padded_heads``), the layer rules (``is_attn_layer`` with the hybrid
layout, ``is_moe_layer``), ``param_count`` and ``active_param_count``
(the MoE rule), ``reduced()`` (the CPU smoke variant, derived exactly as
the reference derives it),
``supports_long_decode``, ``InputShape`` and the reference's ``SHAPES``,
``OptimSpec`` and the training recipes of the optimizer
family, with the reference's ``onebit_adam_autotopo`` and
``onebit_adam_pipelined``, whose ``topology`` / ``pipeline`` the plan
tuner resolves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm", "encoder")
ATTN_IMPLS = ("auto", "full", "chunked", "pallas")
MOE_DISPATCH = ("einsum", "gather")
# "capacity": the reference's softmax-routed layer with a capacity;
# "dropless": DeepSeek-V3's sigmoid-routed layer (selection bias,
# renormalised and scaled gates, shared experts, the experts this chip
# holds)
MOE_KINDS = ("capacity", "dropless")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int                   # query heads
    n_kv_heads: int
    d_ff: int
    vocab: int
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1             # MoE FFN every k-th layer (Jamba: 2)
    capacity_factor: float = 1.25
    # "einsum": one-hot (t, capacity) dispatch matmuls;
    # "gather": index dispatch and scatter-add
    moe_dispatch: str = "einsum"
    # DeepSeek-V3's expert layer (``moe_kind="dropless"``): the expert
    # width (0: d_ff), the shared experts (one SwiGLU of
    # n_shared_experts * moe_d_ff on every token), the scale of the
    # renormalised gates, and the experts this chip holds: experts
    # expert_first .. expert_first + experts_held - 1 (0: all of them)
    moe_kind: str = "capacity"
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    moe_gate_scale: float = 1.0
    experts_held: int = 0
    expert_first: int = 0
    # leading dense layers before the MoE layers (first_k_dense_replace)
    n_dense_lead: int = 0
    # multi-head latent attention (DeepSeek-V2/V3) when kv_lora_rank > 0:
    # the latent width, and per head the q/k dims without and with rope
    # and the v dims
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # SSM (Mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    # hybrid (Jamba): one attention layer per `attn_every` layers
    attn_every: int = 0
    window: Optional[int] = None   # sliding-window size (Mixtral: 4096)
    rope_theta: float = 10_000.0
    causal: bool = True            # False for encoder-only (BERT)
    mlp_kind: str = "swiglu"       # "swiglu" | "gelu"
    # input modality: "tokens" (LM), "embeddings" (audio stub: frames are
    # given), "prefix" (VLM stub: patch-embedding prefix + text tokens)
    embed_kind: str = "tokens"
    n_prefix: int = 256            # VLM: patch embeddings per sample
    norm_eps: float = 1e-5
    compute_dtype: str = "bfloat16"
    remat: bool = True             # activation-checkpoint each block
    # "block": recompute everything inside the block on backward (min mem)
    # "dots":  the reference's dots_with_no_batch_dims_saveable — matmul
    #          outputs without batch dims are saved, everything else
    #          recomputed (trades memory for ~25% fewer backward FLOPs)
    remat_policy: str = "block"
    attn_chunk: int = 2048         # KV chunk of the reference's online softmax
    # "full" (plain masked softmax), "pallas" (the flash-attention kernel,
    # forward only), "chunked" (online softmax over KV chunks), "auto"
    # (chunked past 4 * attn_chunk for causal models, else full)
    attn_impl: str = "auto"
    source: str = ""               # citation

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.n_heads and self.d_model % self.n_heads:
            raise ValueError("d_model must split over the heads")
        if self.moe_dispatch not in MOE_DISPATCH:
            raise ValueError(f"unknown moe_dispatch {self.moe_dispatch!r}")
        if self.moe_kind not in MOE_KINDS:
            raise ValueError(f"unknown moe_kind {self.moe_kind!r}")
        if self.expert_first + self.n_held > self.n_experts:
            raise ValueError(f"experts {self.expert_first} .. "
                             f"{self.expert_first + self.n_held - 1} are "
                             f"not among the {self.n_experts}")

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def n_held(self) -> int:
        """Routed experts this chip holds of each MoE layer."""
        return self.experts_held or self.n_experts

    @property
    def moe_ff(self) -> int:
        """An expert's width."""
        return self.moe_d_ff or self.d_ff

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(math.ceil(self.d_model / 16), 1)

    def padded_vocab(self, tp: int = 1) -> int:
        q = 8 * tp  # keep byte-alignment for the vocab-parallel shard
        return ((self.vocab + q - 1) // q) * q

    def padded_heads(self, tp: int = 1) -> int:
        """Query heads padded up to a multiple of tp."""
        if not self.n_heads:
            return 0
        return ((self.n_heads + tp - 1) // tp) * tp

    def is_attn_layer(self, i: int) -> bool:
        """Hybrid layout: within each attn_every-block the middle layer
        attends (Jamba: 1 attention layer per 8), the others are Mamba."""
        if self.family != "hybrid":
            return self.n_heads > 0
        return (i % self.attn_every) == self.attn_every // 2

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 0 and i >= self.n_dense_lead and \
            (i % self.moe_every) == self.moe_every - 1

    @property
    def supports_long_decode(self) -> bool:
        """True if decode over a 500k context is sub-quadratic in memory:
        an SSM / hybrid state or a sliding window bounds the live KV."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    def param_count(self, tp: int = 1) -> int:
        """Parameter count of the global tree at ``tp`` (its padded heads
        and vocab, duplicated kv heads and MoE ff slices included)."""
        from repro_torch.models.transformer import global_leaf_shapes
        return sum(math.prod(s) for _, s in global_leaf_shapes(self, tp))

    def active_param_count(self, tp: int = 1) -> int:
        """Parameters touched a token (MoE: only the top_k experts of the
        ones held)."""
        total = self.param_count(tp)
        if not self.n_experts:
            return total
        n_moe = sum(self.is_moe_layer(i) for i in range(self.n_layers))
        one = 3 * self.d_model * self.moe_ff
        return total - n_moe * max(self.n_held - self.moe_top_k, 0) * one

    def reduced(self) -> "ArchConfig":
        """The CPU-smoke variant: 2 layers (a hybrid: one attn_every
        period), d_model 256, <= 4 heads, <= 4 experts, top-k <= 2, a
        16-patch prefix.  A dropless MLA arch keeps its mechanism: its
        leading dense layers and two MoE layers, 16 experts (the same
        share of them held) top-4 of width 64, and the latent attention
        at rank 64 with q/k heads of 32 + 16 dims and v heads of 32."""
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        if self.moe_kind == "dropless":
            n_exp = min(self.n_experts, 16)
            return dataclasses.replace(
                self, name=self.name + "-smoke",
                n_layers=self.n_dense_lead + 2, d_model=256,
                n_heads=n_heads, n_kv_heads=n_heads, d_ff=512, vocab=512,
                n_experts=n_exp, moe_top_k=min(self.moe_top_k, 4),
                moe_d_ff=64,
                experts_held=self.experts_held * n_exp // self.n_experts,
                expert_first=self.expert_first * n_exp // self.n_experts,
                kv_lora_rank=64 if self.is_mla else 0,
                qk_nope_dim=32 if self.is_mla else 0,
                qk_rope_dim=16 if self.is_mla else 0,
                v_head_dim=32 if self.is_mla else 0,
                compute_dtype="float32", attn_chunk=64)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2 if self.family != "hybrid" else self.attn_every,
            d_model=256,
            n_heads=n_heads,
            n_kv_heads=min(self.n_kv_heads, max(n_heads // 2, 1)),
            d_ff=512,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            moe_top_k=min(self.moe_top_k, 2),
            n_prefix=16,
            window=min(self.window, 64) if self.window else None,
            compute_dtype="float32",
            attn_chunk=64,
        )


@dataclasses.dataclass(frozen=True)
class OptimSpec:
    """Named training recipe: registry names of the optimizer and the
    compressor, their extra keyword arguments, and the warmup switch
    policy ("steps" = manual T_w, "auto" = the Sec. 7.1 variance-ratio
    rule)."""

    name: str = "onebit_adam"
    optimizer: str = "onebit_adam"
    compressor: str = "onebit"
    block_size: int = 4096
    switch_mode: str = "steps"
    var_freeze_threshold: float = 0.96
    optimizer_kwargs: Optional[dict] = None
    compressor_kwargs: Optional[dict] = None
    # the collective schedule: "flat" | "hier" | "auto" (the plan tuner
    # picks per the run's cluster and device spec), and the bucket count
    # of the pipelined exchange: "off" | N | "auto"
    topology: str = "flat"
    pipeline: object = "off"


_OPTIM_RECIPES: Dict[str, OptimSpec] = {}


def register_optim_recipe(spec: OptimSpec) -> OptimSpec:
    _OPTIM_RECIPES[spec.name] = spec
    return spec


def get_optim_recipe(name: str) -> OptimSpec:
    if name not in _OPTIM_RECIPES:
        raise KeyError(f"unknown optim recipe {name!r}; "
                       f"registered: {sorted(_OPTIM_RECIPES)}")
    return _OPTIM_RECIPES[name]


def list_optim_recipes():
    return sorted(_OPTIM_RECIPES)


# one per registered optimizer, plus the paper's ablations (32-bit
# identity schedule, EF top-k) and the auto-warmup rule
for _spec in (
    OptimSpec(name="onebit_adam"),
    OptimSpec(name="onebit_adam_auto", switch_mode="auto"),
    OptimSpec(name="onebit_adam_32bit", compressor="identity"),
    OptimSpec(name="onebit_adam_topk", compressor="topk"),
    OptimSpec(name="zerone_adam", optimizer="zerone_adam",
              optimizer_kwargs={"var_update_interval": 16,
                                "var_freeze_step": 1000,
                                "sync_double_every": 0}),
    OptimSpec(name="zerone_adam_local", optimizer="zerone_adam",
              optimizer_kwargs={"var_update_interval": 16,
                                "var_freeze_step": 1000,
                                "sync_base_interval": 1,
                                "sync_double_every": 64,
                                "sync_max_interval": 4}),
    OptimSpec(name="onebit_lamb", optimizer="onebit_lamb"),
    # the topology picked by the plan tuner for the run's cluster (flat on
    # uniform fabrics, hier when cross-pod bandwidth is the bottleneck)
    OptimSpec(name="onebit_adam_autotopo", topology="auto"),
    # ...and the bucket count searched with it
    OptimSpec(name="onebit_adam_pipelined", topology="auto",
              pipeline="auto"),
):
    register_optim_recipe(_spec)

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return get_config(name[:-len("-smoke")]).reduced()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; registered: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    return sorted(_REGISTRY)
