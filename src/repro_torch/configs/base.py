"""Architecture, input-shape and optimizer-recipe configuration.

The port's copy of ``repro/configs/base.py``: the fields the BERT encoder
training path (slice 1) and the dense-decoder serving path (slice 2)
read, ``padded_vocab`` and ``reduced()`` (the CPU smoke variant, derived
exactly as the reference derives it), ``InputShape``, ``OptimSpec`` and
the training recipes of the optimizer family.  The reference's
``onebit_adam_autotopo`` and ``onebit_adam_pipelined`` recipes need the
plan tuner and the pipelined exchange, which the port does not have yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm", "encoder")
ATTN_IMPLS = ("auto", "full", "chunked", "pallas")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


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
    window: Optional[int] = None   # sliding-window size (Mixtral: 4096)
    rope_theta: float = 10_000.0
    causal: bool = True            # False for encoder-only (BERT)
    mlp_kind: str = "swiglu"       # "swiglu" | "gelu"
    # input modality; the port serves "tokens" only
    embed_kind: str = "tokens"
    norm_eps: float = 1e-5
    compute_dtype: str = "bfloat16"
    remat: bool = True             # activation-checkpoint each block
    attn_chunk: int = 2048         # KV chunk of the reference's online softmax
    # "full" (plain masked softmax), "pallas" (the flash-attention kernel,
    # forward only), "chunked" (not ported), "auto" (chunked past
    # 4 * attn_chunk for causal models, else full)
    attn_impl: str = "auto"
    source: str = ""               # citation

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.n_heads and self.d_model % self.n_heads:
            raise ValueError("d_model must split over the heads")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads if self.n_heads else 0

    def padded_vocab(self, tp: int = 1) -> int:
        q = 8 * tp  # keep byte-alignment for the vocab-parallel shard
        return ((self.vocab + q - 1) // q) * q

    def reduced(self) -> "ArchConfig":
        """The CPU-smoke variant: 2 layers, d_model 256, <= 4 heads."""
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            d_model=256,
            n_heads=n_heads,
            n_kv_heads=min(self.n_kv_heads, max(n_heads // 2, 1)),
            d_ff=512,
            vocab=512,
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
