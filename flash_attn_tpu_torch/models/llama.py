"""Llama-family causal LM over the port's flash attention (port of
``flash_attn_tpu/models/llama.py``: config, rotary, modules, the
full-sequence forward, the training step and HF interop).

RMSNorm, rotary position embeddings in the HF half-split layout,
grouped-query attention (``n_kv_head`` < ``n_head``, served by the kernels'
GQA group axis), SwiGLU MLP and an untied LM head. Submodules are named
after the flax parameter tree (``wte``, ``layers.{i}.input_layernorm``,
``layers.{i}.attn.{q,k,v,o}_proj``, ``layers.{i}.post_attention_layernorm``,
``layers.{i}.mlp.{gate,up,down}_proj``, ``norm``, ``lm_head``) so
``convert.llama_from_jax_params`` maps one onto the other.

Numerics follow the flax model: parameters stored in ``cfg.param_dtype``,
every projection computed in ``cfg.dtype`` from a cast of them, RMSNorm
statistics and rotary in fp32, and the head bf16 x bf16 -> fp32 (the
product GPT-2's tied head computes). ``remat`` recomputes each block in the
backward (``torch.utils.checkpoint``). ``window`` is Mistral's sliding
window: every attention runs with ``window_size=(window, 0)`` (the
kernels walk the band only); ``window_sinks`` keeps StreamingLLM sink
tokens visible in paged decode only (``llama_decode``).

Qwen3-MoE (no counterpart in the JAX package): ``head_dim`` may differ
from ``n_embd // n_head``; ``qk_norm`` adds a per-head RMSNorm of q and k
before rotary (``attn.q_norm``, ``attn.k_norm``); ``num_experts`` makes
every block's MLP routed SwiGLU experts (``models/moe.py``:
``mlp.router``, ``mlp.gate_up_proj``, ``mlp.down_proj``).

HF interop: ``load_hf_llama`` / ``convert_hf_llama_state_dict`` map a
``transformers`` ``LlamaForCausalLM`` (or Mistral) state dict onto this
module's parameters, ``load_hf_qwen3_moe`` /
``convert_hf_qwen3_moe_state_dict`` a ``Qwen3MoeForCausalLM``'s (every
layer sparse). ``transformers`` is imported only to load a checkpoint by
name or path.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from flash_attn_tpu_torch.models.gpt2 import (
    chunked_lm_loss,
    cross_entropy_loss,
    tied_logits,
)
from flash_attn_tpu_torch.models.modules import linear
from flash_attn_tpu_torch.models.moe import MoeMlp
from flash_attn_tpu_torch.ops.attention import flash_attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 32  # < n_head => GQA (Llama-2-70B / Llama-3 / Mistral)
    n_embd: int = 4096
    intermediate_size: int = 11008
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    window: Any = None  # Mistral-style sliding-window attention
    window_sinks: int = 0  # StreamingLLM sinks, paged decode only
    dtype: Any = torch.bfloat16  # compute: activations and the KV cache
    param_dtype: Any = torch.float32  # stored weights
    remat: bool = False  # per-block recompute in the backward
    head_dim: Any = None  # None: n_embd // n_head (Qwen3: 128 at 2048 / 32)
    qk_norm: bool = False  # per-head RMSNorm of q and k before rotary
    num_experts: int = 0  # > 0: every block's MLP is routed experts
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.n_embd // self.n_head)

    @property
    def n_kv_heads(self) -> int:  # the engine's name (GPT2Config parity)
        return self.n_kv_head

    @classmethod
    def tiny(cls, **kw):
        base = dict(
            vocab_size=512, n_layer=2, n_head=4, n_kv_head=2, n_embd=128,
            intermediate_size=352, max_position_embeddings=256,
            dtype=torch.float32, param_dtype=torch.float32,
        )
        base.update(kw)
        return cls(**base)


def llama_rope_tables(positions, dim: int, base: float):
    """fp32 cos/sin of shape positions.shape + (dim,), half-split layout."""
    inv_freq = 1.0 / (base ** (
        torch.arange(0, dim, 2, dtype=torch.float32,
                     device=positions.device) / dim))
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_llama_rope(x, cos, sin):
    """x (b, s, h, d); cos/sin (s, d) or (b, s, d). Rotates in fp32 and
    returns x's dtype."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None], sin[:, :, None]  # (b, s, 1, d)
    xf = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rotated * sin).to(x.dtype)


class RMSNorm(nn.Module):
    """y = x / rms(x) * weight, statistics in fp32, cast to ``out_dtype``."""

    def __init__(self, dim: int, eps: float, out_dtype, **factory):
        super().__init__()
        self.eps, self.out_dtype = eps, out_dtype
        self.weight = nn.Parameter(torch.ones(dim, **factory))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(self.out_dtype)


def window_size(cfg) -> tuple | None:
    """The ``flash_attention`` band of ``cfg.window`` (JAX llama.py:140):
    (window, 0), or None for full causal attention."""
    return None if cfg.window is None else (cfg.window, 0)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        self.config = cfg
        hd = cfg.head_dim
        self.q_proj = nn.Linear(cfg.n_embd, cfg.n_head * hd, bias=False,
                                **factory)
        self.k_proj = nn.Linear(cfg.n_embd, cfg.n_kv_head * hd, bias=False,
                                **factory)
        self.v_proj = nn.Linear(cfg.n_embd, cfg.n_kv_head * hd, bias=False,
                                **factory)
        self.o_proj = nn.Linear(cfg.n_head * hd, cfg.n_embd, bias=False,
                                **factory)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, cfg.rms_norm_eps, cfg.dtype, **factory)
            self.k_norm = RMSNorm(hd, cfg.rms_norm_eps, cfg.dtype, **factory)

    def qkv(self, x, positions):
        """x (b, s, n_embd), positions (b, s) -> rotary-applied q (b, s,
        n_head, hd), k and v (b, s, n_kv_head, hd)."""
        cfg = self.config
        b, s, _ = x.shape
        hd = cfg.head_dim
        q = linear(x, self.q_proj, cfg.dtype).reshape(b, s, cfg.n_head, hd)
        k = linear(x, self.k_proj, cfg.dtype).reshape(b, s, cfg.n_kv_head,
                                                      hd)
        v = linear(x, self.v_proj, cfg.dtype).reshape(b, s, cfg.n_kv_head,
                                                      hd)
        if cfg.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        cos, sin = llama_rope_tables(positions, hd, cfg.rope_theta)
        return apply_llama_rope(q, cos, sin), apply_llama_rope(k, cos, sin), v

    def forward(self, x, positions):
        q, k, v = self.qkv(x, positions)
        ctx = flash_attention(q, k, v, causal=True,
                              window_size=window_size(self.config))
        return linear(ctx.flatten(2), self.o_proj, self.config.dtype)


class LlamaMlp(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        self.config = cfg
        self.gate_proj = nn.Linear(cfg.n_embd, cfg.intermediate_size,
                                   bias=False, **factory)
        self.up_proj = nn.Linear(cfg.n_embd, cfg.intermediate_size,
                                 bias=False, **factory)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.n_embd,
                                   bias=False, **factory)

    def forward(self, x, live=None):
        """``live``: routed experts' argument, unused by a dense MLP."""
        dt = self.config.dtype
        # SwiGLU: silu(gate) * up -> down
        h = torch.nn.functional.silu(linear(x, self.gate_proj, dt)) \
            * linear(x, self.up_proj, dt)
        return linear(h, self.down_proj, dt)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        self.config = cfg
        self.input_layernorm = RMSNorm(cfg.n_embd, cfg.rms_norm_eps,
                                       cfg.dtype, **factory)
        self.attn = LlamaAttention(cfg, **factory)
        self.post_attention_layernorm = RMSNorm(
            cfg.n_embd, cfg.rms_norm_eps, cfg.dtype, **factory)
        self.mlp = (MoeMlp(cfg, **factory) if cfg.num_experts
                    else LlamaMlp(cfg, **factory))

    def forward(self, x, positions):
        x = x + self.attn(self.input_layernorm(x), positions)
        return x + self.mlp(self.post_attention_layernorm(x))

    def qkv(self, x, positions):
        """Serving: the normed input's rotary-applied q, k and v."""
        return self.attn.qkv(self.input_layernorm(x), positions)

    def finish(self, x, ctx, live=None):
        """Serving: residual stream after attention context ``ctx``
        (..., n_head * hd): output projection, then the MLP. ``live`` (...)
        bool marks the real tokens for routed experts (the rest route
        nowhere and add zeros); a dense MLP ignores it."""
        x = x + linear(ctx, self.attn.o_proj, self.config.dtype)
        return x + self.mlp(self.post_attention_layernorm(x), live)


class LlamaForCausalLM(nn.Module):
    """Llama with an untied LM head. Weights are drawn from ``generator``:
    normal(0.02) for ``wte``, ``lm_head``, the projections and the experts,
    ones for the norms; stored in ``cfg.param_dtype`` on ``device``. With
    ``generator=None`` nothing is drawn (the weights are left as made, and
    on ``device="meta"`` nothing is allocated): the caller assigns every
    parameter."""

    def __init__(self, cfg: LlamaConfig, *,
                 generator: torch.Generator | None, device="cuda"):
        super().__init__()
        self.config = cfg
        factory = dict(device=device, dtype=cfg.param_dtype)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd, **factory)
        self.layers = nn.ModuleList(LlamaBlock(cfg, **factory)
                                    for _ in range(cfg.n_layer))
        self.norm = RMSNorm(cfg.n_embd, cfg.rms_norm_eps, cfg.dtype,
                            **factory)
        self.lm_head = nn.Linear(cfg.n_embd, cfg.vocab_size, bias=False,
                                 **factory)
        if generator is not None:
            self._init_weights(generator)

    @torch.no_grad()
    def _init_weights(self, generator):
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                continue  # ones, as made
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=generator.device) * 0.02)

    def embed(self, input_ids):
        return self.wte(input_ids).to(self.config.dtype)

    def logits(self, x):
        """Serving: final RMSNorm and the head, fp32 logits."""
        return tied_logits(self.norm(x), self.lm_head.weight,
                           self.config.dtype)

    def forward(self, input_ids, positions=None, return_hidden: bool = False):
        """Full-sequence causal forward: (b, s) ids -> (b, s, vocab) fp32
        logits, or with ``return_hidden`` the final norm's output and the
        head's weight (for ``chunked_lm_loss``)."""
        b, s = input_ids.shape
        if positions is None:
            positions = torch.arange(s, device=input_ids.device).expand(b, s)
        x = self.embed(input_ids)
        for block in self.layers:
            if self.config.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, positions, use_reentrant=False)
            else:
                x = block(x, positions)
        if return_hidden:
            return self.norm(x), self.lm_head.weight
        return self.logits(x)


def make_train_step(model: LlamaForCausalLM,
                    optimizer: torch.optim.Optimizer,
                    lm_loss_chunk: int | None = None):
    """Returns ``step(batch, generator=None) -> loss``: one forward,
    backward and optimizer step on ``batch = {"input_ids", "labels"}``
    (b, s) int64 (the model has no dropout; ``generator`` is accepted for
    the GPT-2 step's signature). The JAX step's ``optax.adamw(lr)`` is
    ``torch.optim.AdamW(params, lr, weight_decay=1e-4)`` here.

    ``lm_loss_chunk``: stream the head + CE over chunks of this many tokens
    (``chunked_lm_loss``) instead of holding the (b, s, vocab) logits."""
    dtype = model.config.dtype

    def step(batch, generator: torch.Generator | None = None):
        optimizer.zero_grad(set_to_none=True)
        if lm_loss_chunk is not None:
            x, head = model(batch["input_ids"], return_hidden=True)
            loss = chunked_lm_loss(x, head, batch["labels"],
                                   chunk=lm_loss_chunk, dtype=dtype)
        else:
            loss = cross_entropy_loss(model(batch["input_ids"]),
                                      batch["labels"])
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


# ---------------------------------------------------------- HF interop


def llama_config_from_hf(hf_cfg, **overrides) -> LlamaConfig:
    """A ``LlamaConfig`` from a ``transformers`` Llama or Mistral config.
    A Mistral ``sliding_window`` becomes ``window``."""
    kw = dict(
        vocab_size=hf_cfg.vocab_size,
        n_layer=hf_cfg.num_hidden_layers,
        n_head=hf_cfg.num_attention_heads,
        n_kv_head=getattr(hf_cfg, "num_key_value_heads", None)
        or hf_cfg.num_attention_heads,
        n_embd=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
        rms_norm_eps=hf_cfg.rms_norm_eps,
        window=getattr(hf_cfg, "sliding_window", None),
    )
    kw.update(overrides)
    return LlamaConfig(**kw)


def convert_hf_llama_state_dict(sd, cfg: LlamaConfig, dtype=torch.float32
                                ) -> dict[str, torch.Tensor]:
    """A ``transformers`` state dict (torch tensors or numpy arrays) -> the
    state dict of the port's ``LlamaForCausalLM(cfg)``, in ``dtype`` on the
    CPU. HF's ``nn.Linear`` weights are (out, in), as the port's. Without
    ``lm_head.weight`` the head is tied to the embedding (e.g. TinyLlama
    1.1B). A missing layer raises ``KeyError``, as in JAX."""

    def a(name):
        return torch.as_tensor(sd[name]).detach().to("cpu", dtype)

    out = {"wte.weight": a("model.embed_tokens.weight"),
           "norm.weight": a("model.norm.weight"),
           "lm_head.weight": a("lm_head.weight" if "lm_head.weight" in sd
                               else "model.embed_tokens.weight")}
    names = {"input_layernorm": "input_layernorm",
             "post_attention_layernorm": "post_attention_layernorm",
             **{f"self_attn.{n}": f"attn.{n}"
                for n in ("q_proj", "k_proj", "v_proj", "o_proj")},
             **{f"mlp.{n}": f"mlp.{n}"
                for n in ("gate_proj", "up_proj", "down_proj")}}
    for i in range(cfg.n_layer):
        for hf, port in names.items():
            out[f"layers.{i}.{port}.weight"] = a(
                f"model.layers.{i}.{hf}.weight")
    return out


def load_hf_llama(name_or_model, dtype=torch.float32, device="cuda"
                  ) -> tuple[LlamaConfig, LlamaForCausalLM]:
    """A ``transformers`` model, or a checkpoint name or local directory
    for ``AutoModelForCausalLM.from_pretrained``, -> ``(cfg, model)``: the
    port's ``LlamaForCausalLM`` on ``device`` with its weights stored in
    ``dtype`` (``cfg.param_dtype``)."""
    if isinstance(name_or_model, str):
        from transformers import AutoModelForCausalLM

        hf = AutoModelForCausalLM.from_pretrained(name_or_model)
    else:
        hf = name_or_model
    cfg = llama_config_from_hf(hf.config, param_dtype=dtype)
    model = LlamaForCausalLM(cfg, device=device,
                             generator=torch.Generator().manual_seed(0))
    model.load_state_dict(convert_hf_llama_state_dict(hf.state_dict(), cfg,
                                                      dtype))
    return cfg, model


def qwen3_moe_config_from_hf(hf_cfg, **overrides) -> LlamaConfig:
    """A ``LlamaConfig`` from a ``transformers`` ``Qwen3MoeConfig`` whose
    layers are all sparse (``decoder_sparse_step`` 1, no
    ``mlp_only_layers``); ``intermediate_size`` (the dense MLP's) is kept
    but unused."""
    if hf_cfg.decoder_sparse_step != 1 or hf_cfg.mlp_only_layers:
        raise NotImplementedError("dense layers among sparse ones")
    if getattr(hf_cfg, "use_sliding_window", False) or hf_cfg.attention_bias:
        raise NotImplementedError("sliding window or attention bias")
    kw = dict(
        head_dim=hf_cfg.head_dim, qk_norm=True,
        num_experts=hf_cfg.num_experts,
        num_experts_per_tok=hf_cfg.num_experts_per_tok,
        moe_intermediate_size=hf_cfg.moe_intermediate_size,
        norm_topk_prob=hf_cfg.norm_topk_prob, window=None)
    kw.update(overrides)
    return llama_config_from_hf(hf_cfg, **kw)


def convert_hf_qwen3_moe_state_dict(sd, cfg: LlamaConfig,
                                    dtype=torch.float32
                                    ) -> dict[str, torch.Tensor]:
    """A ``transformers`` ``Qwen3MoeForCausalLM`` state dict -> the state
    dict of the port's ``LlamaForCausalLM(cfg)``, in ``dtype`` on the CPU:
    the attention as in ``convert_hf_llama_state_dict`` plus
    ``self_attn.{q,k}_norm``; ``mlp.gate`` becomes ``mlp.router``, and each
    layer's ``mlp.experts.{e}.{gate,up,down}_proj`` are stacked into
    ``mlp.gate_up_proj`` (E, 2 I, n_embd: gate rows, then up rows) and
    ``mlp.down_proj`` (E, n_embd, I)."""

    def a(name):
        return torch.as_tensor(sd[name]).detach().to("cpu", dtype)

    out = {"wte.weight": a("model.embed_tokens.weight"),
           "norm.weight": a("model.norm.weight"),
           "lm_head.weight": a("lm_head.weight" if "lm_head.weight" in sd
                               else "model.embed_tokens.weight")}
    names = {"input_layernorm": "input_layernorm",
             "post_attention_layernorm": "post_attention_layernorm",
             "mlp.gate": "mlp.router",
             **{f"self_attn.{n}": f"attn.{n}"
                for n in ("q_proj", "k_proj", "v_proj", "o_proj", "q_norm",
                          "k_norm")}}
    for i in range(cfg.n_layer):
        p = f"model.layers.{i}."
        for hf, port in names.items():
            out[f"layers.{i}.{port}.weight"] = a(f"{p}{hf}.weight")
        ex = [f"{p}mlp.experts.{e}." for e in range(cfg.num_experts)]
        out[f"layers.{i}.mlp.gate_up_proj"] = torch.stack([torch.cat(
            [a(x + "gate_proj.weight"), a(x + "up_proj.weight")]) for x in ex])
        out[f"layers.{i}.mlp.down_proj"] = torch.stack(
            [a(x + "down_proj.weight") for x in ex])
    return out


def load_hf_qwen3_moe(name_or_model, dtype=torch.float32, device="cuda"
                      ) -> tuple[LlamaConfig, LlamaForCausalLM]:
    """``load_hf_llama`` for a ``Qwen3MoeForCausalLM`` (a model, or a
    checkpoint name or directory): ``(cfg, model)`` on ``device`` with
    its weights stored in ``dtype``."""
    if isinstance(name_or_model, str):
        from transformers import AutoModelForCausalLM

        hf = AutoModelForCausalLM.from_pretrained(name_or_model)
    else:
        hf = name_or_model
    cfg = qwen3_moe_config_from_hf(hf.config, param_dtype=dtype)
    model = LlamaForCausalLM(cfg, device=device, generator=None)
    model.load_state_dict(convert_hf_qwen3_moe_state_dict(hf.state_dict(),
                                                          cfg, dtype))
    return cfg, model
