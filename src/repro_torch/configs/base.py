"""Model/config registry of the port: plain data, a copy of the JAX
package's ``configs/base.py`` (which imports no JAX).

Every architecture is a ``ModelConfig``; ``repro_torch.configs.get(name)``
returns it and ``tiny()`` derives the reduced smoke-test variant of the same
family.  Only the architectures whose family the port runs are registered
(``recurrentgemma-9b``); the others come with their families.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

_REGISTRY: Dict[str, "ModelConfig"] = {}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    group_size: int = 2048          # dispatch-einsum token group
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    act: str = "swiglu"             # swiglu | geglu | sqrelu | gelu
    norm: str = "rmsnorm"
    moe: Optional[MoEConfig] = None
    window: Optional[int] = None    # sliding-window attention size
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # hybrid (griffin): repeating block pattern, e.g. ("rec","rec","attn")
    block_pattern: Optional[Tuple[str, ...]] = None
    rnn_width: Optional[int] = None       # RG-LRU recurrence width
    conv_width: int = 4                   # temporal conv width (griffin)
    local_window: Optional[int] = None    # griffin local-attn window
    # ssm (xlstm)
    slstm_every: Optional[int] = None     # one sLSTM block every N layers
    chunk: int = 256                      # chunkwise-recurrence chunk length
    # enc-dec (whisper)
    n_enc_layers: Optional[int] = None
    n_dec_layers: Optional[int] = None
    # vlm (pixtral)
    n_prefix_tokens: int = 0              # patch-embedding prefix (stub)
    # numerics / perf knobs
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    remat_policy: str = "full"      # full | dots (save matmul outputs)
    attn_chunk: Optional[int] = None      # blockwise-attention KV chunk
    logits_chunk: Optional[int] = None    # vocab-chunked loss (hillclimb)
    scan_layers: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers is not None

    # Exact parameter counts are computed from the real init shape-tree by
    # ``repro_torch.models.api.param_count(cfg)`` — no duplicate bookkeeping here.


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ModelConfig:
    # import the arch modules lazily so `get` works without preimports
    from repro_torch import configs as _c  # noqa: F401  (triggers registration)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names():
    from repro_torch import configs as _c  # noqa: F401
    return sorted(_REGISTRY)


def tiny(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-tiny",
        n_layers=(4 if cfg.slstm_every
                  else min(cfg.n_layers, 2 * len(cfg.block_pattern or (1,)))),
        slstm_every=2 if cfg.slstm_every else None,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        head_dim=16,
        window=min(cfg.window, 32) if cfg.window else None,
        local_window=min(cfg.local_window, 16) if cfg.local_window else None,
        rnn_width=64 if cfg.rnn_width else None,
        # capacity_factor = n_experts ⇒ dropless in both the training and
        # decode groupings, so decode-vs-forward equivalence is exact
        moe=dataclasses.replace(cfg.moe, n_experts=4, top_k=2, group_size=64,
                                capacity_factor=4.0)
        if cfg.moe else None,
        n_enc_layers=2 if cfg.n_enc_layers else None,
        n_dec_layers=2 if cfg.n_dec_layers else None,
        n_prefix_tokens=8 if cfg.n_prefix_tokens else 0,
        chunk=16,
        attn_chunk=None,
        remat=False,
    )
    return dataclasses.replace(cfg, **kw)
