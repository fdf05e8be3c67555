"""Architecture configuration schema.

One ``ArchConfig`` describes any assigned architecture; family-specific
fields are ignored by other families. ``reduced()`` produces the smoke-test
variant (same family/topology, tiny dims). Exact assigned configs live in
``repro_torch.configs.<id>``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None       # default d_model // n_heads

    # --- attention flavor ---------------------------------------------------
    rope_theta: float = 10000.0
    sliding_window: int | None = None        # window for local layers
    local_global_alternating: bool = False   # gemma2: even layers local
    attn_softcap: float | None = None        # gemma2: 50.0
    final_softcap: float | None = None       # gemma2: 30.0

    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1                # apply MoE on layers where i % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.5
    router_aux_weight: float = 0.01

    # --- SSM (Mamba1) ----------------------------------------------------------
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2

    # --- hybrid (jamba): within each block of ``hybrid_period`` layers,
    #     layer index ``hybrid_attn_index`` is attention, the rest Mamba.
    hybrid_period: int = 8
    hybrid_attn_index: int = 4

    # --- encoder-decoder (whisper) ----------------------------------------------
    enc_layers: int = 0
    enc_ctx: int = 0                  # precomputed frame embeddings length
    enc_dim: int = 0                  # frontend stub output dim

    # --- VLM (llava) --------------------------------------------------------------
    n_patches: int = 0                # precomputed patch embeddings (anyres)

    # --- execution policy -----------------------------------------------------------
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: str = "none"               # none | dots | full
    grad_accum: int = 1               # training microbatches (MoE memory)
    prefill_chunk: int | None = None  # chunked prefill (vLLM-style)
    logits_fp32: bool = True
    loss_chunk: int = 512             # sequence-chunked cross-entropy
    scan_layers: bool = True          # lax.scan over stacked layer params
    opt_state_dtype: str = "fp32"     # fp32 | bf16 | int8 (Adam moments)

    # --- metadata ----------------------------------------------------------------------
    source: str = ""                  # provenance tag from the assignment
    notes: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(1, self.n_heads))
        if self.family == "moe" and (self.n_experts <= 0 or self.moe_top_k <= 0):
            raise ValueError(f"{self.name}: moe family needs experts/top_k")
        if self.family in ("dense", "moe", "vlm") and self.n_heads % max(1, self.n_kv_heads):
            raise ValueError(f"{self.name}: n_heads must divide by n_kv_heads")

    # -- derived ------------------------------------------------------------------
    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def layer_kinds(self) -> list[str]:
        """Static per-layer structure: 'attn' or 'mamba'."""
        if self.family == "ssm":
            return ["mamba"] * self.n_layers
        if self.family == "hybrid":
            return ["attn" if i % self.hybrid_period == self.hybrid_attn_index
                    else "mamba" for i in range(self.n_layers)]
        return ["attn"] * self.n_layers

    def mlp_kinds(self) -> list[str]:
        """Static per-layer MLP structure: 'dense' or 'moe' ('none' for ssm)."""
        if self.family == "ssm":
            return ["none"] * self.n_layers    # mamba block subsumes the MLP
        if self.n_experts > 0:
            return ["moe" if i % self.moe_every == self.moe_offset else "dense"
                    for i in range(self.n_layers)]
        return ["dense"] * self.n_layers

    def window_for_layer(self, i: int) -> int | None:
        if self.local_global_alternating:
            return self.sliding_window if i % 2 == 0 else None
        return self.sliding_window

    def param_count(self) -> int:
        """Analytic parameter count (drives 6·N·D MODEL_FLOPS)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        n = 0
        n += V * d * 2                                        # embed + head
        kinds = self.layer_kinds()
        mlps = self.mlp_kinds()
        for i in range(self.n_layers):
            if kinds[i] == "attn":
                n += d * self.attn_dim + 2 * d * self.kv_dim + self.attn_dim * d
            else:
                di = self.ssm_d_inner
                ns = self.ssm_d_state
                n += d * 2 * di + di * self.ssm_d_conv + di * (2 * ns + 1) \
                     + di * ns + di + di * d                  # in,conv,proj,A,D,out
            if mlps[i] == "dense":
                n += 3 * d * ff
            elif mlps[i] == "moe":
                n += 3 * d * self.d_ff_expert * self.n_experts + d * self.n_experts
            n += 2 * d                                        # norms
        if self.family == "encdec":
            for _ in range(self.enc_layers):
                n += 4 * d * d + 3 * d * ff + 2 * d           # enc self-attn + mlp
                n += 4 * d * d + d                            # dec cross-attn
            n += self.enc_dim * d                             # frontend projector
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        moe_layers = sum(1 for k in self.mlp_kinds() if k == "moe")
        all_exp = 3 * self.d_model * self.d_ff_expert * self.n_experts * moe_layers
        act_exp = 3 * self.d_model * self.d_ff_expert * self.moe_top_k * moe_layers
        return full - all_exp + act_exp

    def reduced(self, **overrides) -> "ArchConfig":
        """Smoke-test variant: same family/pattern, tiny dims."""
        kv = max(1, min(self.n_kv_heads, 2))
        heads = max(kv, 4)
        kw = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, self.hybrid_period if self.family == "hybrid" else 4),
            d_model=128, n_heads=heads, n_kv_heads=kv, head_dim=32,
            d_ff=256, vocab_size=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            d_ff_expert=64 if self.n_experts else 0,
            sliding_window=64 if self.sliding_window else None,
            enc_layers=min(self.enc_layers, 2),
            enc_ctx=16 if self.family == "encdec" else 0,
            enc_dim=48 if self.family == "encdec" else 0,
            n_patches=8 if self.family == "vlm" else 0,
            ssm_d_state=8, ssm_expand=2,
            grad_accum=1, prefill_chunk=None, loss_chunk=64,
        )
        kw.update(overrides)
        return replace(self, **kw)
