"""Plain Llama / Mistral in float32, the benchmark's reference.

Written from the published description (Touvron et al. 2023; Jiang et
al. 2023, "Mistral 7B", section 2): RMSNorm, rotary position embeddings
in the half-split layout of the published checkpoints, grouped-query
attention (query head i reads key/value head i // (heads / kv heads)),
a sliding window in which position i attends to positions i - W .. i,
a SwiGLU MLP and an untied head. Plain torch operations only, TF32 off,
computed layer by layer and in blocks of 1,024 query rows so that
Mistral-7B's sizes fit beside nothing else on one card. It imports nothing
of the program and takes only the benchmark's weights and inputs.

``mode="fp8"`` is the lower-precision control: every product's operands
are rounded to float8 e4m3 (rows of activations and of weights each with
their own scale in the forward, one scale per tensor in the backward),
the rest as in float32.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

F = torch.nn.functional
Q_BLOCK = 1024
FP8_MAX = 448.0


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def round_fp8(x, dim=None):
    """x rounded to float8 e4m3 with an amax scale along ``dim`` (one
    scale for the whole tensor with None), returned in float32."""
    a = x.detach().abs()
    amax = a.amax() if dim is None else a.amax(dim=dim, keepdim=True)
    s = amax.clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def ste_fp8(x, dim=-1):
    """Rounded to fp8 in the forward, gradient passed straight through."""
    return x + (round_fp8(x, dim) - x).detach()


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return round_fp8(x, -1) @ round_fp8(w, -1).t()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g8 = round_fp8(g)
        gx = g8 @ round_fp8(w)
        gw = g8.reshape(-1, g.shape[-1]).t() @ round_fp8(x).reshape(
            -1, x.shape[-1])
        return gx, gw


def linear(x, w, mode):
    if mode == "fp8":
        return _Fp8Linear.apply(x, w)
    return x @ w.t()


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """x (b, s, h, d) at positions pos (s,): half-split rotary, angles in
    float64."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = pos.double()[:, None] * inv
    cos = ang.cos().float()[None, :, None]
    sin = ang.sin().float()[None, :, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend_block(qb, kb, vb, q0, k0, window, mode):
    """Query rows q0.. of (b, sq, h, d) against keys k0.. of (b, sk, hkv,
    d): causal, with the window when given."""
    h, hkv, d = qb.shape[2], kb.shape[2], qb.shape[3]
    kb = kb.repeat_interleave(h // hkv, dim=2)
    vb = vb.repeat_interleave(h // hkv, dim=2)
    if mode == "fp8":
        qb, kb, vb = ste_fp8(qb), ste_fp8(kb), ste_fp8(vb)
    scores = torch.einsum("bqhd,bkhd->bhqk", qb, kb) / math.sqrt(d)
    qpos = torch.arange(q0, q0 + qb.shape[1], device=qb.device)[:, None]
    kpos = torch.arange(k0, k0 + kb.shape[1], device=qb.device)[None]
    visible = kpos <= qpos
    if window is not None:
        visible &= kpos >= qpos - window
    p = torch.softmax(scores.masked_fill(~visible, float("-inf")), dim=-1)
    if mode == "fp8":
        p = ste_fp8(p)
    return torch.einsum("bhqk,bkhd->bqhd", p, vb)


def attention(q, k, v, window, mode, remat=False):
    """Causal (windowed) attention of (b, s, h, d) queries over (b, s,
    hkv, d) keys and values at positions 0..s-1, in query blocks; with
    ``remat`` each block is recomputed in the backward."""
    s, out = q.shape[1], []
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(s, q0 + Q_BLOCK)
        k0 = 0 if window is None else max(0, q0 - window)
        args = (q[:, q0:q1], k[:, k0:q1], v[:, k0:q1], q0, k0, window, mode)
        out.append(checkpoint(_attend_block, *args, use_reentrant=False)
                   if remat else _attend_block(*args))
    return torch.cat(out, dim=1)


def block(x, w, n, c, mode, remat=False):
    """Decoder layer n on x (b, s, e) in float32; ``w(name)`` gives a
    float32 weight."""
    p = f"layers.{n}."
    b, s, e = x.shape
    H, Hkv = c["num_attention_heads"], c["num_key_value_heads"]
    hd, eps = e // H, c["rms_norm_eps"]
    pos = torch.arange(s, device=x.device)
    h = rms_norm(x, w(p + "input_layernorm.weight"), eps)
    q = linear(h, w(p + "attn.q_proj.weight"), mode).view(b, s, H, hd)
    k = linear(h, w(p + "attn.k_proj.weight"), mode).view(b, s, Hkv, hd)
    v = linear(h, w(p + "attn.v_proj.weight"), mode).view(b, s, Hkv, hd)
    q, k = rope(q, pos, c["rope_theta"]), rope(k, pos, c["rope_theta"])
    a = attention(q, k, v, c.get("sliding_window"), mode, remat)
    x = x + linear(a.reshape(b, s, H * hd), w(p + "attn.o_proj.weight"),
                   mode)
    h = rms_norm(x, w(p + "post_attention_layernorm.weight"), eps)
    g = F.silu(linear(h, w(p + "mlp.gate_proj.weight"), mode))
    u = linear(h, w(p + "mlp.up_proj.weight"), mode)
    return x + linear(g * u, w(p + "mlp.down_proj.weight"), mode)


@torch.no_grad()
def served_logits(weights: dict, c: dict, seqs, mode="fp32"):
    """Teacher-forced logits. ``seqs``: [(ids (n,) int64, first)]; returns
    for each the float32 logits (n - first, vocab) of positions first ..
    n-1 (position t predicts token t + 1). Layer-major over all sequences:
    each layer's weights are cast to float32 once."""
    xs = [weights["wte.weight"][ids].float()[None] for ids, _ in seqs]
    for n in range(c["num_hidden_layers"]):
        cache = {}

        def w(name):
            if name not in cache:
                cache[name] = weights[name].float()
            return cache[name]

        xs = [block(x, w, n, c, mode) for x in xs]
    norm = weights["norm.weight"].float()
    head = weights["lm_head.weight"].float()
    return [linear(rms_norm(x[0, first:], norm, c["rms_norm_eps"]), head,
                   mode) for x, (_, first) in zip(xs, seqs)]


def lm_loss(params: dict, c: dict, ids, mode="fp32", chunk=2048):
    """Mean next-token cross entropy of (b, s) ids, each layer and each
    chunk of the head recomputed in the backward."""
    x = params["wte.weight"][ids]
    for n in range(c["num_hidden_layers"]):
        x = checkpoint(lambda x, n=n: block(x, params.__getitem__, n, c,
                                            mode, remat=True),
                       x, use_reentrant=False)
    h = rms_norm(x, params["norm.weight"], c["rms_norm_eps"])[:, :-1]
    labels = ids[:, 1:]

    def nll(hc, lc):
        logits = linear(hc, params["lm_head.weight"], mode)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               lc.reshape(-1), reduction="sum")

    total = sum(checkpoint(nll, h[:, a:a + chunk], labels[:, a:a + chunk],
                           use_reentrant=False)
                for a in range(0, h.shape[1], chunk))
    return total / labels.numel()


def train(weights: dict, c: dict, batches, opt: dict, mode="fp32"):
    """len(batches) AdamW steps from ``weights`` (float32, left as they
    are). Returns the losses, the first step's gradient norm of each leaf
    and each leaf's change after the last step. AdamW as torch defines
    it: decoupled decay p *= 1 - lr wd, then the bias-corrected step."""
    lr, wd = opt["lr"], opt["weight_decay"]
    b1, b2 = opt.get("betas", (0.9, 0.999))
    eps = opt.get("eps", 1e-8)
    params = {n: w.detach().clone().requires_grad_() for n, w in
              weights.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, grad_norms = [], None
    for t, ids in enumerate(batches, start=1):
        loss = lm_loss(params, c, ids, mode)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if grad_norms is None:
                grad_norms = {n: float(g.norm()) for n, g in
                              zip(params, grads)}
            for (n, p), g in zip(params.items(), grads):
                p.mul_(1 - lr * wd)
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
        del grads, loss
    with torch.no_grad():
        change = {n: float((p - weights[n]).norm()) for n, p in
                  params.items()}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
