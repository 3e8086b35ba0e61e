"""Vision Transformer over ``FlashMHA`` (port of
``flash_attn_tpu/models/vit.py``).

Patch embedding (a convolution with stride equal to the patch size) ->
pre-LN blocks with non-causal ``FlashMHA`` and 2-D rotary over the
sqrt(S) x sqrt(S) patch grid (``use_rotary_emb="2d"``) and a GELU MLP ->
mean pooling (no CLS token, so the grid stays square) -> classification
head. With ``use_rotary=False`` a learned ``pos_embed`` is added instead.

Images arrive as (b, H, W, C), as in JAX, and are permuted for the
convolution. Submodules are named after the flax parameter tree
(``patch_embed``, ``pos_embed``, ``block_{i}.{ln1, attn.Wqkv,
attn.out_proj, ln2, fc1, fc2}``, ``ln_final``, ``head``) so
``convert.vit_from_jax_params`` maps one onto the other.

Numerics follow flax's dtype promotion. Parameters are stored in
``param_dtype`` (fp32: the AdamW master copy). With ``ViTConfig(dtype=
bf16)`` the modules built with ``dtype=c.dtype`` compute in bf16: the
patch convolution, ``FlashMHA`` and ``fc1``/``fc2`` (gelu between them in
bf16). The LayerNorms, built without a dtype, compute in fp32 and emit
fp32, and so does ``head``. The residual stream keeps the patch
embedding's dtype: both of a block's branches emit ``c.dtype``, so with
bf16 the stream is bf16, as it is in the flax model.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from flash_attn_tpu_torch.models.bert import layer_norm
from flash_attn_tpu_torch.models.gpt2 import dropout, gelu
from flash_attn_tpu_torch.models.modules import FlashMHA, draw_seeds, linear


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    num_classes: int = 1000
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    mlp_ratio: int = 4
    dropout: float = 0.0
    use_rotary: bool = True  # 2D rotary over the patch grid
    dtype: Any = None  # compute dtype of the convolution, FlashMHA and MLP
    param_dtype: Any = torch.float32

    @property
    def grid(self) -> int:
        if self.image_size % self.patch_size:
            raise ValueError(f"image_size {self.image_size} is not a "
                             f"multiple of patch_size {self.patch_size}")
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid

    @classmethod
    def tiny(cls, **kw):
        d = dict(image_size=32, patch_size=4, num_classes=10, n_layer=2,
                 n_head=4, n_embd=128)
        d.update(kw)
        return cls(**d)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, **factory):
        super().__init__()
        self.config = cfg
        self.ln1 = nn.LayerNorm(cfg.n_embd, eps=1e-6, **factory)
        self.attn = FlashMHA(
            cfg.n_embd, cfg.n_head, attention_dropout=cfg.dropout,
            causal=False, use_rotary_emb="2d" if cfg.use_rotary else None,
            dtype=cfg.dtype, param_dtype=factory["dtype"],
            device=factory["device"])
        self.ln2 = nn.LayerNorm(cfg.n_embd, eps=1e-6, **factory)
        self.fc1 = nn.Linear(cfg.n_embd, cfg.mlp_ratio * cfg.n_embd,
                             **factory)
        self.fc2 = nn.Linear(cfg.mlp_ratio * cfg.n_embd, cfg.n_embd,
                             **factory)

    def forward(self, x, seeds=None):
        """``seeds`` (attention, after attention, after the MLP) turn
        dropout on."""
        cfg = self.config
        gen = None if seeds is None else torch.Generator().manual_seed(
            seeds[0])
        h = self.attn(layer_norm(x, self.ln1), deterministic=seeds is None,
                      generator=gen)
        if seeds is not None:
            h = dropout(h, cfg.dropout, seeds[1])
        x = x + h
        h = layer_norm(x, self.ln2)
        dtype = cfg.dtype or torch.promote_types(h.dtype,
                                                 self.fc1.weight.dtype)
        h = linear(gelu(linear(h, self.fc1, dtype)), self.fc2, dtype)
        if seeds is not None:
            h = dropout(h, cfg.dropout, seeds[2])
        return x + h


class ViTClassifier(nn.Module):
    """(b, H, W, C) images -> (b, num_classes) fp32 logits. Weights are
    drawn from ``generator`` at flax's initialisers' scales (convolution
    and Denses lecun normal with zero bias, ``pos_embed`` normal(0.02),
    LayerNorms 1 and 0) and stored in ``cfg.param_dtype`` on ``device``."""

    def __init__(self, cfg: ViTConfig, *, generator: torch.Generator,
                 device="cuda"):
        super().__init__()
        self.config = cfg
        factory = dict(device=device, dtype=cfg.param_dtype)
        p = cfg.patch_size
        self.patch_embed = nn.Conv2d(cfg.num_channels, cfg.n_embd, p,
                                     stride=p, **factory)
        self.pos_embed = None if cfg.use_rotary else nn.Parameter(
            torch.empty(1, cfg.seq_len, cfg.n_embd, **factory))
        for i in range(cfg.n_layer):
            self.add_module(f"block_{i}", ViTBlock(cfg, **factory))
        self.ln_final = nn.LayerNorm(cfg.n_embd, eps=1e-6, **factory)
        self.head = nn.Linear(cfg.n_embd, cfg.num_classes, **factory)
        self._init_weights(generator)

    def blocks(self):
        return [getattr(self, f"block_{i}")
                for i in range(self.config.n_layer)]

    @torch.no_grad()
    def _init_weights(self, generator):
        def normal(t, std):
            t.copy_(torch.randn(t.shape, generator=generator,
                                device=generator.device) * std)

        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                normal(mod.weight, mod.weight[0].numel() ** -0.5)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        if self.pos_embed is not None:
            normal(self.pos_embed, 0.02)

    def forward(self, images, deterministic: bool = True,
                generator: torch.Generator | None = None):
        """Dropout runs when ``deterministic`` is False and ``cfg.dropout``
        > 0, with its seeds drawn from ``generator``."""
        cfg = self.config
        b, hh, ww, _ = images.shape
        if not hh == ww == cfg.image_size:
            raise ValueError(f"images {tuple(images.shape)}, need (b, "
                             f"{cfg.image_size}, {cfg.image_size}, C)")
        conv = self.patch_embed
        dtype = cfg.dtype or torch.promote_types(images.dtype,
                                                 conv.weight.dtype)
        x = F.conv2d(images.permute(0, 3, 1, 2).to(dtype),
                     conv.weight.to(dtype), conv.bias.to(dtype),
                     stride=conv.stride)
        x = x.permute(0, 2, 3, 1).reshape(b, cfg.seq_len, cfg.n_embd)
        if self.pos_embed is not None:
            x = x + self.pos_embed.to(x.dtype)
        seeds = [None] * cfg.n_layer
        if not deterministic and cfg.dropout > 0.0:
            drawn = draw_seeds(generator, 1 + 3 * cfg.n_layer)
            x = dropout(x, cfg.dropout, drawn[0])
            seeds = [drawn[1 + 3 * i: 4 + 3 * i] for i in range(cfg.n_layer)]
        for block, s in zip(self.blocks(), seeds):
            x = block(x, s)
        x = layer_norm(x, self.ln_final).mean(dim=1)
        return linear(x, self.head, torch.float32)


def classification_loss(logits, labels):
    """Mean cross entropy of (b, classes) logits in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def make_train_step(model: ViTClassifier, optimizer: torch.optim.Optimizer):
    """Returns ``step(batch, generator) -> loss``: one forward, backward and
    optimizer step on ``batch = {"images", "labels"}``, with dropout (when
    ``cfg.dropout`` > 0) seeded from ``generator``. The JAX step's
    ``optax.adamw(lr)`` is ``torch.optim.AdamW(params, lr,
    weight_decay=1e-4)`` here."""
    cfg = model.config

    def step(batch, generator: torch.Generator | None = None):
        optimizer.zero_grad(set_to_none=True)
        logits = model(batch["images"], deterministic=cfg.dropout == 0.0,
                       generator=generator)
        loss = classification_loss(logits, batch["labels"])
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
