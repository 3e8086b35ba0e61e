"""BERT encoder and masked-LM head over ``FlashMHA`` (port of
``flash_attn_tpu/models/bert.py``).

The reference's flagship deployment is BERT, with padded batches of
sequences of different lengths. As in the JAX model, the batch stays padded
and attention masks the padding inside K1/K2 by segment ids made from the
``attention_mask`` (0 for real tokens, -1 for padding; positions arange,
non-causal): ``FlashMHA(key_padding_mask=...)``. Post-LayerNorm BERT: each
sublayer, dropout, add, LayerNorm.

Submodules are named after the flax parameter tree (``bert.embeddings``,
``bert.layer_{i}.attention.Wqkv``, ..., ``transform``, ``decoder``) so
``convert.bert_from_jax_params`` maps one onto the other.

Numerics follow flax's dtype promotion. Parameters are stored in
``param_dtype`` (fp32: the AdamW master copy). With ``BertConfig(dtype=
bf16)`` only the modules built with ``dtype=c.dtype`` compute in bf16:
``FlashMHA`` (Wqkv, attention, out_proj) and the ``intermediate`` and
``output`` Denses (gelu between them in bf16). Everything else computes in
fp32: the embeddings, every LayerNorm, the residual stream (x + a promotes
to fp32), ``pooler``, ``transform``, ``decoder`` and ``mlm_loss``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from flash_attn_tpu_torch.models.gpt2 import dropout
from flash_attn_tpu_torch.models.modules import FlashMHA, draw_seeds, linear


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    dtype: Any = None  # compute dtype of FlashMHA and the MLP Denses
    param_dtype: Any = torch.float32

    @classmethod
    def base(cls, **kw):
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=1024, n_layer=2, n_head=4, n_embd=128,
                 intermediate_size=256, max_position_embeddings=256)
        d.update(kw)
        return cls(**d)


def layer_norm(x, ln: nn.LayerNorm):
    """flax ``LayerNorm()`` without a dtype: fp32 in, fp32 out."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, **factory):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.n_embd,
                                            **factory)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.n_embd, **factory)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.n_embd, **factory)
        self.LayerNorm = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_eps,
                                      **factory)

    def forward(self, input_ids, token_type_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = (self.word_embeddings(input_ids).float()
             + self.position_embeddings(pos).float()[None]
             + self.token_type_embeddings(token_type_ids).float())
        return layer_norm(x, self.LayerNorm)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, **factory):
        super().__init__()
        self.config = cfg
        self.attention = FlashMHA(
            cfg.n_embd, cfg.n_head, attention_dropout=cfg.dropout,
            causal=False, dtype=cfg.dtype, param_dtype=factory["dtype"],
            device=factory["device"])
        eps = cfg.layer_norm_eps
        self.attention_ln = nn.LayerNorm(cfg.n_embd, eps=eps, **factory)
        self.intermediate = nn.Linear(cfg.n_embd, cfg.intermediate_size,
                                      **factory)
        self.output = nn.Linear(cfg.intermediate_size, cfg.n_embd, **factory)
        self.output_ln = nn.LayerNorm(cfg.n_embd, eps=eps, **factory)

    def forward(self, x, attention_mask, seeds=None):
        """``seeds`` (attention, after attention, after the MLP) turn
        dropout on."""
        cfg = self.config
        gen = None if seeds is None else torch.Generator().manual_seed(
            seeds[0])
        a = self.attention(x, key_padding_mask=attention_mask,
                           deterministic=seeds is None, generator=gen)
        if seeds is not None:
            a = dropout(a, cfg.dropout, seeds[1])
        x = layer_norm(x + a, self.attention_ln)
        dtype = cfg.dtype or x.dtype
        h = F.gelu(linear(x, self.intermediate, dtype))
        h = linear(h, self.output, dtype)
        if seeds is not None:
            h = dropout(h, cfg.dropout, seeds[2])
        return layer_norm(x + h, self.output_ln)


class BertModel(nn.Module):
    """Encoder stack; returns (sequence_output, pooled_output), fp32."""

    def __init__(self, cfg: BertConfig, **factory):
        super().__init__()
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg, **factory)
        for i in range(cfg.n_layer):
            self.add_module(f"layer_{i}", BertLayer(cfg, **factory))
        self.pooler = nn.Linear(cfg.n_embd, cfg.n_embd, **factory)

    def layers(self):
        return [getattr(self, f"layer_{i}")
                for i in range(self.config.n_layer)]

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic: bool = True, generator=None):
        cfg = self.config
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask is not None:
            attention_mask = attention_mask.bool()
        x = self.embeddings(input_ids, token_type_ids)
        seeds = [None] * cfg.n_layer
        if not deterministic and cfg.dropout > 0.0:
            drawn = draw_seeds(generator, 1 + 3 * cfg.n_layer)
            x = dropout(x, cfg.dropout, drawn[0])
            seeds = [drawn[1 + 3 * i: 4 + 3 * i] for i in range(cfg.n_layer)]
        for layer, s in zip(self.layers(), seeds):
            x = layer(x, attention_mask, s)
        pooled = torch.tanh(linear(x[:, 0], self.pooler, torch.float32))
        return x, pooled


class BertForMaskedLM(nn.Module):
    """The encoder with the MLM transform and decoder head: (b, s) ids ->
    (b, s, vocab) fp32 logits. Weights are drawn from ``generator`` as
    fp32 normals at flax's initialisers' scales (embeddings 1 / sqrt(n_embd),
    Denses lecun normal with zero bias, LayerNorms 1 and 0) and stored in
    ``cfg.param_dtype`` on ``device``."""

    def __init__(self, cfg: BertConfig, *, generator: torch.Generator,
                 device="cuda"):
        super().__init__()
        self.config = cfg
        factory = dict(device=device, dtype=cfg.param_dtype)
        self.bert = BertModel(cfg, **factory)
        self.transform = nn.Linear(cfg.n_embd, cfg.n_embd, **factory)
        self.transform_ln = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_eps,
                                         **factory)
        self.decoder = nn.Linear(cfg.n_embd, cfg.vocab_size, **factory)
        self._init_weights(generator)

    @torch.no_grad()
    def _init_weights(self, generator):
        for mod in self.modules():
            if isinstance(mod, nn.Embedding):
                std = mod.embedding_dim ** -0.5
            elif isinstance(mod, nn.Linear):
                std = mod.in_features ** -0.5
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                continue
            else:
                continue
            mod.weight.copy_(torch.randn(mod.weight.shape,
                                         generator=generator,
                                         device=generator.device) * std)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic: bool = True, generator=None):
        x, _ = self.bert(input_ids, attention_mask, token_type_ids,
                         deterministic, generator)
        x = F.gelu(linear(x, self.transform, torch.float32))
        x = layer_norm(x, self.transform_ln)
        return linear(x, self.decoder, torch.float32)


def mlm_loss(logits, labels, label_mask):
    """Cross entropy over the positions where ``label_mask`` is 1, in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels.long()[..., None])[..., 0]
    w = label_mask.float()
    return -(ll * w).sum() / w.sum().clamp(min=1.0)


def make_train_step(model: BertForMaskedLM, optimizer: torch.optim.Optimizer):
    """Returns ``step(batch, generator) -> loss``: one MLM forward,
    backward and optimizer step on ``batch = {"input_ids",
    "attention_mask", "labels", "label_mask"}``, with dropout (when
    ``cfg.dropout`` > 0) seeded from ``generator``. The JAX step's
    ``optax.adamw(lr)`` is ``torch.optim.AdamW(params, lr,
    weight_decay=1e-4)`` here."""
    cfg = model.config

    def step(batch, generator: torch.Generator | None = None):
        optimizer.zero_grad(set_to_none=True)
        logits = model(batch["input_ids"],
                       attention_mask=batch.get("attention_mask"),
                       deterministic=cfg.dropout == 0.0, generator=generator)
        loss = mlm_loss(logits, batch["labels"], batch["label_mask"])
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
