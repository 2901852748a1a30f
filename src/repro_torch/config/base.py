"""Config system (counterpart of ``src/repro/config/base.py``).

``ModelConfig`` describes an architecture, ``KernelConfig`` the kernel
dispatch policy, ``ServeConfig`` the serving engine, ``OptimizerConfig``
and ``TrainConfig`` the trainer, ``RunConfig`` the bundle a user builds
and trains an adapter from. Field names and defaults follow the JAX
package; dtypes are torch dtypes. The port implements the serving slices
(paged and dense cache, fp and int8, the live / lora / merged runtimes)
and adapter training with checkpoints (MetaTT 4d / 5d / 4+1d / 4+ed, LoRA,
VeRA, LoTR) on attention decoders with a dense or a MoE FFN: the engine
and the trainer raise ``NotImplementedError`` for any field value outside
them instead of ignoring it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

MIXERS = ("attn", "mamba", "mlstm", "slstm", "none")
FFNS = ("dense", "moe", "none")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | vlm | audio | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    block_pattern: tuple = (("attn", "dense"),)
    mlp: str = "swiglu"            # swiglu | geglu | gelu
    norm_kind: str = "rmsnorm"     # rmsnorm | layernorm
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.0
    # --- mamba ---
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_dt_rank: int = 0
    mamba_conv: int = 4
    # --- enc-dec ---
    encoder_layers: int = 0
    encoder_seq: int = 0
    # --- frontends ---
    frontend: str = "none"
    frontend_seq: int = 0
    # --- dtypes ---
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 128 (as in the JAX
        package, so converted weights keep their shape); padded ids are
        never produced by a real token."""
        return -(-self.vocab_size // 128) * 128

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def pattern_len(self) -> int:
        return len(self.block_pattern)

    @property
    def num_super_blocks(self) -> int:
        if self.num_layers % self.pattern_len:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern length {self.pattern_len}")
        return self.num_layers // self.pattern_len

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def total_layers(self) -> int:
        """Adapter L axis: encoder layers (if any) + decoder layers."""
        return self.encoder_layers + self.num_layers

    def validate(self) -> "ModelConfig":
        for mixer, ffn in self.block_pattern:
            if mixer not in MIXERS or ffn not in FFNS:
                raise ValueError(f"bad block pattern entry {(mixer, ffn)}")
        _ = self.num_super_blocks
        if any(f == "moe" for _, f in self.block_pattern):
            if not (self.num_experts and self.experts_per_token):
                raise ValueError(f"{self.name}: moe blocks need num_experts")
        return self


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Serving-side int8 of the frozen half of the model
    (``kernels/quant.py``).

    weights: "none" | "int8" — symmetric int8 of the base matrices
        (attention q/k/v/o, dense-FFN up/gate/down), one f32 scale per
        output channel, or per K group when ``group_size`` > 0; the rank-r
        adapter term stays full precision.
    kv: "none" | "int8" — int8 paged KV cells with one f32 scale per
        (token, kv head), in the same block layout as the cells (paged
        cache mode only).
    group_size: K rows per weight-scale group, a multiple of 128; 0 = one
        scale per output channel. A matrix whose K it does not divide is
        quantized per output channel.
    """
    weights: str = "none"          # none | int8
    kv: str = "none"               # none | int8
    group_size: int = 0

    @property
    def any(self) -> bool:
        return self.weights != "none" or self.kv != "none"

    def validate(self) -> "QuantConfig":
        for name in ("weights", "kv"):
            v = getattr(self, name)
            if v not in ("none", "int8"):
                raise ValueError(
                    f"QuantConfig.{name}={v!r}; want none | int8")
        if self.group_size and self.group_size % 128 != 0:
            raise ValueError(
                f"QuantConfig.group_size={self.group_size} must be a "
                "multiple of 128 (a scale group spans whole kernel K tiles)")
        return self


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Kernel-dispatch policy, resolved by ``kernels/dispatch.resolve``.

    backend: "auto" — the CUDA kernels for CUDA tensors, the plain
        versions for CPU tensors (a wrapper picks by its input's device);
        "cuda" — the same, but a CPU tensor raises; "ref" — the plain
        PyTorch versions everywhere (the comparison leg on the card).
    fuse_linear: route adapted linears through the fused K1/K2 kernels
        whenever the adapter folds to lora-form (A, B).
    flash: route attention through the K3/K4 kernels.
    interpret / bm / bn / bk / bq / bkv: the JAX package's Pallas knobs.
        The CUDA kernels have fixed tiles and no interpret mode, so
        anything but the defaults raises ``NotImplementedError``.
    quant: frozen-base / KV quantization; the serving engine merges it
        with ``ServeConfig.quant`` (int8 wins).
    """
    backend: str = "auto"          # auto | cuda | ref
    interpret: Optional[bool] = None
    fuse_linear: bool = True
    flash: bool = True
    bm: int = 0
    bn: int = 0
    bk: int = 0
    bq: int = 0
    bkv: int = 0
    quant: QuantConfig = QuantConfig()

    def validate(self) -> "KernelConfig":
        self.quant.validate()
        if self.backend not in ("auto", "cuda", "ref"):
            raise ValueError(f"unknown kernel backend {self.backend!r}; "
                             "want auto | cuda | ref")
        if self.interpret:
            raise NotImplementedError(
                "interpret mode is a Pallas feature; the CUDA kernels have "
                "none (CPU tensors run the plain versions)")
        tiles = {n: getattr(self, n) for n in ("bm", "bn", "bk", "bq", "bkv")
                 if getattr(self, n)}
        if tiles:
            raise NotImplementedError(
                f"tile overrides {tiles}: the CUDA kernels use fixed tiles")
        return self


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative multi-token decode (``serving/speculative.py``). The
    drafter is a rank-truncated slice of the shared TT cores — the leading
    ``draft_rank`` bond columns of G1 / C / G4 (or of the lora-form A) —
    over every ``draft_layer_stride``-th super-block of the frozen base.
    Each engine step the drafter proposes ``spec_k`` tokens from its own
    KV region, the target scores all spec_k + 1 columns in one pass, and
    the accept rule commits the longest valid prefix: exact argmax match
    under greedy sampling (tokens identical to the non-speculative
    engine), rejection sampling otherwise (the output distribution
    unchanged).

    spec_k: drafts per engine step; 0 disables speculation.
    draft_rank: the drafter's bond rank; 0 keeps the full rank. Applies
        to metatt (live and lora-form) and plain lora runtimes; other
        kinds keep their full-rank factors.
    draft_layer_stride: the drafter keeps every stride-th super-block (1:
        all); its KV region shrinks by the same factor.
    """
    spec_k: int = 0
    draft_rank: int = 0
    draft_layer_stride: int = 1

    @property
    def enabled(self) -> bool:
        return self.spec_k > 0

    def validate(self) -> "SpecConfig":
        if self.spec_k < 0:
            raise ValueError(f"SpecConfig.spec_k={self.spec_k} must be >= 0")
        if self.draft_rank < 0:
            raise ValueError(
                f"SpecConfig.draft_rank={self.draft_rank} must be >= 0 "
                "(0 = full rank)")
        if self.draft_layer_stride < 1:
            raise ValueError(
                f"SpecConfig.draft_layer_stride={self.draft_layer_stride} "
                "must be >= 1")
        return self


@dataclasses.dataclass(frozen=True)
class RegistryConfig:
    """Paged adapter registry (``serving/adapter_registry.py``). MetaTT's
    task mode makes each task's marginal footprint one core column, so the
    engine can serve an open-ended task population from a fixed device
    pool of ``max_resident_tasks`` slots, writing task columns from a
    host copy of the factors into a slot on demand (one in-place copy, the
    pool's shape never changes) and evicting idle residents —
    S-LoRA-style paging, with a TT core column as the unit instead of a
    whole adapter stack.

    max_resident_tasks: device task-slot pool size K. 0 (default) keeps
        the whole ``num_tasks`` axis on the device — registry off, the
        engine as without it. K may be smaller than the in-flight batch's
        distinct-task count only at the price of admission backpressure:
        a request whose task cannot get a slot waits until a harvest
        unpins one.
    eviction: idle-resident replacement policy — "lru" (default; recency
        refreshed on every admission hit) or "fifo" (load order only —
        cheaper bookkeeping, worse under skewed reuse).

    Requires a task-routed runtime (metatt 4+1d, live or lora); the
    engine rejects the combination otherwise. Works in both cache modes
    and composes with quantization and speculative decode (the drafter's
    truncated columns page together with their target columns, at the
    same slot).
    """
    max_resident_tasks: int = 0
    eviction: str = "lru"          # lru | fifo

    @property
    def enabled(self) -> bool:
        return self.max_resident_tasks > 0

    def validate(self) -> "RegistryConfig":
        if self.max_resident_tasks < 0:
            raise ValueError(
                f"RegistryConfig.max_resident_tasks="
                f"{self.max_resident_tasks} must be >= 0 (0 = all tasks "
                "device-resident)")
        if self.eviction not in ("lru", "fifo"):
            raise ValueError(
                f"RegistryConfig.eviction={self.eviction!r}; want "
                "lru | fifo")
        return self


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-engine knobs (``serving/engine.py``), the JAX package's
    fields and defaults. The port serves both cache modes on one device:
    ``cache_mode="paged"`` (the default: flat pools of ``num_blocks``
    blocks of ``page_size`` cells, block tables, the prefix cache with
    copy-on-write, and ``prefill_chunk`` prompt tokens per slot and step
    in the decode loop) and ``cache_mode="dense"`` (max_batch slots of
    cache_len cells each, power-of-two or ``prompt_buckets`` prefill
    buckets). ``quant`` int8-quantizes the base weights (both modes) and
    the KV cells (paged mode only); ``spec`` turns on speculative decode
    in both modes; ``registry`` pages task columns through a fixed pool of
    device slots (both modes); ``preempt_after`` > 0 turns on recompute
    preemption (paged mode: after that many consecutive host-loop
    iterations with the FIFO head blocked, the youngest running request
    is re-queued with its generated tokens). ``mesh_shape`` (data, model)
    with a data axis of 1 serves tensor-parallel over the ``tp_axis``:
    one process a rank over an initialised ``torch.distributed`` group of
    that size (``serving/engine.py``); ``row_parallel`` row-slices the
    second matmul of each attention / FFN pair and all-reduces its
    partial sums. A data axis above 1 (replicas, the router) and
    ``disagg`` raise ``NotImplementedError``.
    """
    max_batch: int = 4
    cache_len: int = 64
    out_cap: int = 32
    cache_mode: str = "paged"      # paged | dense
    page_size: int = 16
    num_blocks: int = 0
    prefill_chunk: int = 8
    prefix_cache: bool = True
    prompt_buckets: tuple = ()
    quant: QuantConfig = QuantConfig()
    mesh_shape: tuple = ()
    tp_axis: str = "model"
    router: str = "least_loaded"
    disagg: bool = False
    row_parallel: bool = False
    spec: SpecConfig = SpecConfig()
    registry: RegistryConfig = RegistryConfig()
    preempt_after: int = 0

    @property
    def pages_per_request(self) -> int:
        """Block-table width: worst-case pages one request can touch."""
        return -(-self.cache_len // self.page_size)

    @property
    def resolved_num_blocks(self) -> int:
        return self.num_blocks or self.max_batch * self.pages_per_request

    @property
    def tp_size(self) -> int:
        """Ranks of the tensor-parallel axis (1 without a mesh)."""
        if not self.mesh_shape:
            return 1
        return int(self.mesh_shape[("data", "model").index(self.tp_axis)])

    @property
    def dp_size(self) -> int:
        """Length of the other mesh axis (data replicas; 1 without a
        mesh)."""
        if not self.mesh_shape:
            return 1
        return int(self.mesh_shape[("data", "model").index(self.tp_axis)
                                   ^ 1])

    def validate(self) -> "ServeConfig":
        if self.cache_mode not in ("paged", "dense"):
            raise ValueError(f"unknown cache_mode {self.cache_mode!r}; "
                             "want paged | dense")
        self.quant.validate()
        self.spec.validate()
        self.registry.validate()
        if self.spec.enabled and self.spec.spec_k + 1 > self.cache_len:
            raise ValueError(
                f"SpecConfig.spec_k={self.spec.spec_k}: the verifier "
                f"scores spec_k+1 positions per step, which must fit in "
                f"cache_len={self.cache_len}")
        if self.quant.kv == "int8" and self.cache_mode != "paged":
            raise ValueError(
                "kv=int8 quantization is implemented for the paged cache "
                "layout only (per-cell scale pools); use cache_mode='paged'")
        for name in ("max_batch", "cache_len", "out_cap", "page_size",
                     "prefill_chunk"):
            if getattr(self, name) < 1:
                raise ValueError(f"ServeConfig.{name} must be >= 1")
        if self.cache_mode == "paged" and self.page_size % 8 != 0:
            raise ValueError(
                f"page_size={self.page_size} must be a multiple of 8 (the "
                "paged-attention kernels tile (page, head_dim) blocks)")
        if self.cache_mode == "paged" \
                and self.resolved_num_blocks < self.pages_per_request:
            raise ValueError(
                f"num_blocks={self.resolved_num_blocks} cannot hold even "
                f"one worst-case request ({self.pages_per_request} pages "
                f"of {self.page_size} for cache_len={self.cache_len})")
        if self.preempt_after < 0:
            raise ValueError(
                f"ServeConfig.preempt_after={self.preempt_after} must be "
                ">= 0 (0 disables recompute preemption)")
        if self.preempt_after and self.cache_mode != "paged":
            raise ValueError(
                "recompute preemption frees paged KV blocks; it needs "
                "cache_mode='paged'")
        if self.mesh_shape:
            if len(self.mesh_shape) != 2 \
                    or any(int(n) < 1 for n in self.mesh_shape):
                raise ValueError(
                    f"ServeConfig.mesh_shape={self.mesh_shape!r} must be "
                    "a (data, model) pair of positive ints (empty for "
                    "single-device serving)")
            if self.tp_axis not in ("data", "model"):
                raise ValueError(
                    f"ServeConfig.tp_axis={self.tp_axis!r} must name a "
                    "serve-mesh axis (data | model)")
            if self.dp_size > 1:
                raise NotImplementedError(
                    f"ServeConfig.mesh_shape={self.mesh_shape!r}: the "
                    "port serves tensor-parallel only; data replicas and "
                    "the router are not ported yet")
        if self.disagg:
            raise NotImplementedError(
                "ServeConfig.disagg: disaggregated prefill is not ported "
                "yet")
        if self.row_parallel:
            if not self.mesh_shape:
                raise ValueError(
                    "row_parallel is a serve-TP variant; set mesh_shape")
            if self.quant.group_size:
                raise ValueError(
                    "row_parallel row-slices the K axis of wo/wd, which "
                    f"grouped quant scales (group_size="
                    f"{self.quant.group_size}) tile; use per-channel "
                    "scales (group_size=0)")
        return self


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One cell of the input-shape grid (launcher metadata)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 1e-3               # paper's MetaTT grid: {1e-3, 5e-4}
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0      # paper App. D: weight_decay = 0.0
    warmup_ratio: float = 0.06     # paper App. A.3
    grad_clip: float = 3.0         # paper App. B: max grad norm 3.0
    schedule: str = "linear"       # linear | cosine | constant


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer knobs (the JAX TrainConfig's fields). ``grad_compression``
    int8 / topk round-trips the adapter gradients before AdamW;
    ``train_base`` marks the full fine-tuning baseline, which
    ``train_step.make_full_ft_step`` runs (the adapter Trainer ignores it,
    as the JAX one does); ``ckpt_dir`` turns on checkpoints and
    auto-resume."""
    steps: int = 100
    microbatch: int = 0            # 0 -> no gradient accumulation
    remat: str = "block"           # none | block (checkpoint each super-block)
    seed: int = 42                 # one of the paper's seeds (App. D)
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = ""
    ckpt_keep: int = 3
    grad_compression: str = "none"  # none | int8 | topk
    train_base: bool = False       # True -> full fine-tuning baseline (FT row)
    # DMRG-in-training: transport AdamW moments through each sweep (warm
    # carry, core/dmrg.py) instead of the paper's cold re-initialization
    dmrg_warm_moments: bool = True


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """The adapter a model carries and how it is trained (the JAX
    RunConfig's fields)."""
    model: ModelConfig
    shape: Optional[ShapeConfig] = None
    adapter_kind: str = "metatt"   # metatt | lora | vera | lotr | none
    adapter_variant: str = "4d"    # metatt: 4d | 5d | 4+1d | 4+ed
    adapter_rank: int = 8
    adapter_alpha: float = 4.0
    adapter_matrices: tuple = ()   # () -> arch default
    num_tasks: int = 0
    optimizer: OptimizerConfig = OptimizerConfig()
    train: TrainConfig = TrainConfig()
    kernels: KernelConfig = KernelConfig()
