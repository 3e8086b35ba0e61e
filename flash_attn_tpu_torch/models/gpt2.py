"""GPT-2 language model over the port's flash attention (port of
``flash_attn_tpu/models/gpt2.py``: config and full-sequence forward).

Submodules are named after the flax parameter tree (``wte``, ``wpe``,
``h.{i}.ln_1/ln_2``, ``h.{i}.attn.Wqkv/out_proj``, ``h.{i}.mlp.c_fc/c_proj``,
``ln_f``) so ``convert.gpt2_from_jax_params`` maps one onto the other. The
LM head is tied to ``wte``. The module holds the weights the serving path
(``gpt2_decode``) runs, and its forward is the teacher-forcing reference.
Training is a later port item.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from flash_attn_tpu_torch.ops.attention import flash_attention


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    max_position_embeddings: int = 1024
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    layer_norm_epsilon: float = 1e-5
    dtype: Any = torch.bfloat16  # weights, activations and the KV cache
    # Sliding-window attention: ROADMAP port item P2; must stay None.
    window: Any = None

    @property
    def n_kv_heads(self) -> int:
        return self.n_head

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=512, max_position_embeddings=256, n_layer=2,
                 n_head=8, n_embd=128)
        d.update(kw)
        return cls(**d)


def layer_norm(x, ln: nn.LayerNorm, dtype):
    """LayerNorm in fp32, cast to ``dtype`` (as the JAX decode path does)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(dtype)


def gelu(x):
    # flax nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


class Attention(nn.Module):
    def __init__(self, cfg: GPT2Config, **factory):
        super().__init__()
        self.Wqkv = nn.Linear(cfg.n_embd, 3 * cfg.n_embd, **factory)
        self.out_proj = nn.Linear(cfg.n_embd, cfg.n_embd, **factory)


class Mlp(nn.Module):
    def __init__(self, cfg: GPT2Config, **factory):
        super().__init__()
        self.c_fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd, **factory)
        self.c_proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd, **factory)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, **factory):
        super().__init__()
        self.config = cfg
        eps = cfg.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(cfg.n_embd, eps=eps, **factory)
        self.attn = Attention(cfg, **factory)
        self.ln_2 = nn.LayerNorm(cfg.n_embd, eps=eps, **factory)
        self.mlp = Mlp(cfg, **factory)

    def qkv(self, x):
        """(..., n_embd) -> q, k, v (..., n_head, head_dim), split as flax
        splits the fused projection (reshape to (..., 3, n_head, hd))."""
        cfg = self.config
        h = layer_norm(x, self.ln_1, cfg.dtype)
        qkv = self.attn.Wqkv(h).unflatten(-1, (3, cfg.n_head, cfg.head_dim))
        return qkv.unbind(dim=-3)

    def finish(self, x, ctx):
        """Residual stream after attention context ``ctx`` (..., n_embd):
        output projection, then the MLP."""
        x = x + self.attn.out_proj(ctx)
        h = layer_norm(x, self.ln_2, self.config.dtype)
        return x + self.mlp.c_proj(gelu(self.mlp.c_fc(h)))


class GPT2LMHeadModel(nn.Module):
    """GPT-2 with a tied LM head. Weights are drawn from ``generator`` as
    fp32 normals at the flax initialisers' scales and stored in
    ``cfg.dtype`` on ``device``."""

    def __init__(self, cfg: GPT2Config, *, generator: torch.Generator,
                 device="cpu"):
        super().__init__()
        if cfg.window is not None:
            raise NotImplementedError(
                "GPT2Config.window: sliding windows are ROADMAP port item P2")
        self.config = cfg
        factory = dict(device=device, dtype=cfg.dtype)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd, **factory)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.n_embd,
                                **factory)
        self.h = nn.ModuleList(Block(cfg, **factory)
                               for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon,
                                 **factory)
        self._init_weights(generator)
        # Inference only: the backward kernel and training are later port
        # items (ROADMAP P1, P8), and flash_attention refuses grad on CUDA.
        self.requires_grad_(False)

    @torch.no_grad()
    def _init_weights(self, generator):
        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=generator.device) * std)

        normal(self.wte.weight, 0.02)
        normal(self.wpe.weight, 0.01)
        for block in self.h:
            for lin in (block.attn.Wqkv, block.attn.out_proj,
                        block.mlp.c_fc, block.mlp.c_proj):
                # flax Dense default: lecun_normal kernel, zero bias
                normal(lin.weight, lin.in_features ** -0.5)
                lin.bias.zero_()
            for ln in (block.ln_1, block.ln_2):
                ln.weight.fill_(1.0)
                ln.bias.zero_()
        self.ln_f.weight.fill_(1.0)
        self.ln_f.bias.zero_()

    def embed(self, input_ids, positions):
        return (self.wte(input_ids) + self.wpe(positions)).to(
            self.config.dtype)

    def lm_head(self, x):
        """Final LayerNorm and the tied head, in fp32."""
        x = layer_norm(x, self.ln_f, torch.float32)
        return x @ self.wte.weight.float().T

    def forward(self, input_ids):
        """Full-sequence causal forward: (b, s) ids -> (b, s, vocab) fp32
        logits."""
        b, s = input_ids.shape
        x = self.embed(input_ids, torch.arange(s, device=input_ids.device))
        for block in self.h:
            q, k, v = block.qkv(x)
            ctx = flash_attention(q, k, v, causal=True)
            x = block.finish(x, ctx.reshape(b, s, -1))
        return self.lm_head(x)
