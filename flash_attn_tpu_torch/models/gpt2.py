"""GPT-2 language model over the port's flash attention (port of
``flash_attn_tpu/models/gpt2.py``: config, full-sequence forward, losses
and the training step).

Submodules are named after the flax parameter tree (``wte``, ``wpe``,
``h.{i}.ln_1/ln_2``, ``h.{i}.attn.Wqkv/out_proj``, ``h.{i}.mlp.c_fc/c_proj``,
``ln_f``) so ``convert.gpt2_from_jax_params`` maps one onto the other. The
LM head is tied to ``wte``.

Numerics follow the flax model: parameters are stored in
``cfg.param_dtype`` (fp32 by default: the AdamW master copy) and every
Linear computes in ``cfg.dtype`` from a cast of them; LayerNorm takes its
statistics in fp32 and emits ``cfg.dtype``; gelu is the tanh form. The tied
head multiplies ``cfg.dtype`` operands into fp32 logits. Dropout acts after
the embedding, inside attention (the kernels' coordinate hash) and after
the MLP's ``c_proj``; there is none after ``out_proj``.

The serving path (``gpt2_decode``) runs ``Block.qkv`` / ``Block.finish`` and
``lm_head`` (an fp32 head, as the JAX decode path has); it wants the weights
stored in ``cfg.dtype``, so that its casts are no-ops. The training block
is the same three steps with the attention op between them.

``remat`` recomputes each block in the backward (``torch.utils.checkpoint``)
and ``remat_policy`` chooses what it keeps (JAX ``_resolve_remat_policy``):
None keeps only the block's input; "dots" also every matmul's output
(selective checkpointing), so the norms, gelu, dropout and attention
recompute; "dots_flash" also the attention output and its lse, so the
forward kernel does not run again in the backward. The attention op is a
ctypes launch that the selective-checkpoint dispatch cannot see, so
"dots_flash" runs it between two recomputed regions, the projection before
it and the rest of the block after, and its autograd node keeps what the
backward kernel reads.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from flash_attn_tpu_torch.models.modules import FlashMHA, draw_seeds, linear


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    max_position_embeddings: int = 1024
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    dtype: Any = torch.bfloat16  # compute: activations and the KV cache
    param_dtype: Any = torch.float32  # stored weights
    # Sliding-window (local causal) attention: each token attends the last
    # `window` tokens only (None = full causal; GPT-2 checkpoints use None).
    # Honored by training (FlashMHA window_size), prefill, chunks and
    # decode.
    window: Any = None
    # StreamingLLM attention sinks, DECODE-ONLY: with a window, the first
    # `window_sinks` positions stay visible during paged decode (the
    # softmax anchor for long rolling generation). Prefill and training
    # keep the pure band (JAX gpt2.py:55-60).
    window_sinks: int = 0
    # Per-block recompute in the backward (torch.utils.checkpoint), and
    # what it keeps with remat=True: None (the block's input only),
    # "dots" (and every matmul output) or "dots_flash" (and the attention
    # output and lse: the forward kernel does not run again).
    remat: bool = False
    remat_policy: str | None = None

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
    """LayerNorm in fp32, cast to ``dtype`` (flax LayerNorm(dtype=...))."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(dtype)


def gelu(x):
    # flax nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def dropout(x, p: float, seed: int):
    """flax ``nn.Dropout``: keep with probability 1 - p, scale the kept by
    1 / (1 - p). The mask comes from a device generator seeded with
    ``seed``, so a recompute with the same seed gives the same mask."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0)


class _TiedHead(torch.autograd.Function):
    """logits = x @ w^T with ``x.dtype`` operands and fp32 output
    (gpt2.py:267-272 there). On the card one cuBLAS call emits fp32 from
    bf16 operands; the backward casts the fp32 cotangent to the operand
    dtype for its two products (JAX keeps it fp32 and rounds the results
    instead)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x2.is_cuda and x2.dtype != torch.float32:
            y = torch.mm(x2, w.t(), out_dtype=torch.float32)
        else:
            y = x2.float() @ w.float().t()
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
        dx = (g2 @ w).reshape(x.shape)
        dw = g2.t() @ x.reshape(-1, x.shape[-1])
        return dx, dw


def tied_logits(x, wte, dtype):
    """fp32 logits of the tied head from ``dtype`` operands."""
    return _TiedHead.apply(x.to(dtype), wte.to(dtype))


class Mlp(nn.Module):
    def __init__(self, cfg: GPT2Config, **factory):
        super().__init__()
        self.config = cfg
        self.c_fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd, **factory)
        self.c_proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd, **factory)

    def forward(self, x, seed: int | None = None):
        cfg = self.config
        x = linear(gelu(linear(x, self.c_fc, cfg.dtype)), self.c_proj,
                   cfg.dtype)
        return x if seed is None else dropout(x, cfg.dropout, seed)


def window_size(cfg) -> tuple | None:
    """The ``flash_attention`` band of ``cfg.window`` (JAX gpt2.py:161):
    (window, 0), or None for full causal attention."""
    return None if cfg.window is None else (cfg.window, 0)


class Block(nn.Module):
    """One transformer block. ``attn_impl``, when given, replaces the flash
    attention op between the block's own ``attn.Wqkv`` and
    ``attn.out_proj`` (JAX ``_MhaWithImpl``, gpt2.py:180): a callable
    ``(q, k, v, dropout_seed=None) -> ctx`` on (b, s, n_head, head_dim)."""

    def __init__(self, cfg: GPT2Config, attn_impl=None, **factory):
        super().__init__()
        self.config = cfg
        self.attn_impl = attn_impl
        eps = cfg.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(cfg.n_embd, eps=eps, **factory)
        self.attn = FlashMHA(cfg.n_embd, cfg.n_head, causal=True,
                             attention_dropout=cfg.dropout, dtype=cfg.dtype,
                             param_dtype=factory["dtype"],
                             window_size=window_size(cfg),
                             device=factory["device"])
        self.ln_2 = nn.LayerNorm(cfg.n_embd, eps=eps, **factory)
        self.mlp = Mlp(cfg, **factory)

    def forward(self, x, seeds: tuple[int, int] | None = None):
        """Training / full-sequence block. ``seeds`` (attention, MLP) turn
        dropout on; the attention seed comes from a generator seeded here,
        so a recompute under checkpoint draws the same one."""
        ctx = self.attend(*self.qkv(x), seeds)
        return self.finish(x, ctx, None if seeds is None else seeds[1])

    def remat_forward(self, x, seeds, policy: str | None):
        """``forward`` under ``torch.utils.checkpoint`` with ``policy``
        (``GPT2Config.remat_policy``)."""
        if policy is None:
            return checkpoint(self, x, seeds, use_reentrant=False)
        kw = dict(use_reentrant=False, context_fn=_save_dots)
        if policy == "dots":
            return checkpoint(self, x, seeds, **kw)
        q, k, v = checkpoint(self.qkv, x, **kw)
        ctx = self.attend(q, k, v, seeds)
        return checkpoint(self.finish, x, ctx,
                          None if seeds is None else seeds[1], **kw)

    def attend(self, q, k, v, seeds):
        """The attention op on (b, s, n_head, head_dim) q, k, v -> (b, s,
        n_embd) context; dropout is on when ``seeds`` is given."""
        gen = None if seeds is None else torch.Generator().manual_seed(
            seeds[0])
        if self.attn_impl is None:
            ctx = self.attn.inner_attn.attend(q, k, v, causal=True,
                                              deterministic=gen is None,
                                              generator=gen)
        else:
            seed = None if gen is None else draw_seeds(gen, 1)[0]
            ctx = self.attn_impl(q, k, v, dropout_seed=seed)
        return ctx.flatten(2)

    def qkv(self, x):
        """ln_1 and the fused projection: (..., n_embd) -> q, k, v (...,
        n_head, head_dim), split as flax splits it (reshape to (..., 3,
        n_head, hd))."""
        cfg = self.config
        h = layer_norm(x, self.ln_1, cfg.dtype)
        qkv = linear(h, self.attn.Wqkv, cfg.dtype).unflatten(
            -1, (3, cfg.n_head, cfg.head_dim))
        return qkv.unbind(dim=-3)

    def finish(self, x, ctx, mlp_seed: int | None = None):
        """Residual stream after attention context ``ctx`` (..., n_embd):
        output projection, then the MLP (dropout after it with
        ``mlp_seed``)."""
        x = x + linear(ctx, self.attn.out_proj, self.config.dtype)
        return x + self.mlp(layer_norm(x, self.ln_2, self.config.dtype),
                            mlp_seed)


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _keep_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep every matmul's output (JAX
    ``dots_saveable``), recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_dots():
    return create_selective_checkpoint_contexts(_keep_matmuls)


class GPT2LMHeadModel(nn.Module):
    """GPT-2 with a tied LM head. Weights are drawn from ``generator`` as
    fp32 normals at the flax initialisers' scales and stored in
    ``cfg.param_dtype`` on ``device``. ``attn_impl`` replaces every block's
    attention op (``Block``; JAX ``GPT2LMHeadModel.attn_impl``) and leaves
    the parameters as they are."""

    def __init__(self, cfg: GPT2Config, *, generator: torch.Generator,
                 device="cuda", attn_impl=None):
        super().__init__()
        if cfg.remat and cfg.remat_policy not in (None, "dots", "dots_flash"):
            raise ValueError("remat_policy must be None, 'dots', or "
                             f"'dots_flash'; got {cfg.remat_policy!r}")
        self.config = cfg
        factory = dict(device=device, dtype=cfg.param_dtype)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd, **factory)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.n_embd,
                                **factory)
        self.h = nn.ModuleList(Block(cfg, attn_impl, **factory)
                               for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon,
                                 **factory)
        self._init_weights(generator)

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
        """Serving: final LayerNorm and the tied head, in fp32."""
        x = layer_norm(x, self.ln_f, torch.float32)
        return x @ self.wte.weight.float().T

    def forward(self, input_ids, *, deterministic: bool = True,
                generator: torch.Generator | None = None,
                return_hidden: bool = False):
        """Full-sequence causal forward: (b, s) ids -> (b, s, vocab) fp32
        logits, or with ``return_hidden`` the final LayerNorm's output and
        ``wte`` (for ``chunked_lm_loss``). Dropout runs when
        ``deterministic`` is False and ``cfg.dropout`` > 0, with its seeds
        drawn from ``generator``."""
        cfg = self.config
        b, s = input_ids.shape
        train = not deterministic and cfg.dropout > 0.0
        x = self.embed(input_ids, torch.arange(s, device=input_ids.device))
        block_seeds = [None] * cfg.n_layer
        if train:
            seeds = draw_seeds(generator, 2 * cfg.n_layer + 1)
            x = dropout(x, cfg.dropout, seeds[0])
            block_seeds = list(zip(seeds[1::2], seeds[2::2]))
        for block, seeds in zip(self.h, block_seeds):
            if cfg.remat and torch.is_grad_enabled():
                x = block.remat_forward(x, seeds, cfg.remat_policy)
            else:
                x = block(x, seeds)
        x = layer_norm(x, self.ln_f, cfg.dtype)
        if return_hidden:
            return x, self.wte.weight
        return tied_logits(x, self.wte.weight, cfg.dtype)


def cross_entropy_loss(logits, labels):
    """Next-token CE; labels == -100 are ignored."""
    labels = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -100)],
                       dim=1)  # the last position predicts nothing
    valid = (labels != -100).sum()
    total = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                            labels.reshape(-1), ignore_index=-100,
                            reduction="sum")
    return total / valid.clamp(min=1)


def _chunk_nll(x, wte, labels, dtype):
    logits = tied_logits(x, wte, dtype)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1), ignore_index=-100,
                           reduction="sum")


def chunked_lm_loss(x, wte, labels, *, chunk=512, dtype=torch.bfloat16):
    """Next-token CE that never holds the (b, s, vocab) logits: the tied
    head and CE run over sequence chunks of ``chunk`` tokens, each under
    ``torch.utils.checkpoint`` so the backward recomputes its logits. Equals
    ``cross_entropy_loss(logits, labels)`` on the same head."""
    x, labels = x[:, :-1], labels[:, 1:]
    total = sum(
        checkpoint(_chunk_nll, x[:, c:c + chunk], wte, labels[:, c:c + chunk],
                   dtype, use_reentrant=False)
        for c in range(0, x.shape[1], chunk))
    return total / (labels != -100).sum().clamp(min=1)


def make_train_step(model: GPT2LMHeadModel, optimizer: torch.optim.Optimizer,
                    lm_loss_chunk: int | None = None):
    """Returns ``step(batch, generator) -> loss``: one forward, backward and
    optimizer step on ``batch = {"input_ids", "labels"}`` (b, s) int64,
    with dropout (when ``cfg.dropout`` > 0) seeded from ``generator``. The
    JAX step's ``optax.adamw(lr)`` is ``torch.optim.AdamW(params, lr,
    weight_decay=1e-4)`` here (optax's default decay; torch's is 1e-2).

    ``lm_loss_chunk``: stream the LM head + CE over chunks of this many
    tokens (``chunked_lm_loss``) instead of holding the full logits."""
    cfg = model.config

    def loss_fn(batch, generator):
        kw = dict(deterministic=cfg.dropout == 0.0, generator=generator)
        if lm_loss_chunk is not None:
            x, wte = model(batch["input_ids"], return_hidden=True, **kw)
            return chunked_lm_loss(x, wte, batch["labels"],
                                   chunk=lm_loss_chunk, dtype=cfg.dtype)
        return cross_entropy_loss(model(batch["input_ids"], **kw),
                                  batch["labels"])

    def step(batch, generator: torch.Generator | None = None):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch, generator)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
