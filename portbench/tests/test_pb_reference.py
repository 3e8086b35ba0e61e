"""The plain reference against a float64 evaluation written out position
by position at a tiny size, and against the port's own forward."""

import math

import pytest
import torch

from portbench.families import llama as family
from portbench.harness.common import make_weights
from portbench.reference import llama as ref
from portbench.tests.tiny import tiny_config

C = dict(tiny_config(), sliding_window=5, num_hidden_layers=2)


def weights(dtype=torch.float32, seed=3):
    return make_weights(family.param_spec(C), seed, dtype,
                        torch.device("cpu"))


def f64_logits(w, ids):
    """Every position's logits in float64, one query at a time."""
    w = {k: v.double() for k, v in w.items()}
    e, H, Hkv = C["hidden_size"], C["num_attention_heads"], \
        C["num_key_value_heads"]
    d, eps, W = e // H, C["rms_norm_eps"], C["sliding_window"]
    n = len(ids)

    def norm(x, g):
        return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * g

    def rot(x, pos):  # (h, d) at one position
        out = torch.empty_like(x)
        for i in range(d // 2):
            a = pos / C["rope_theta"] ** (2 * i / d)
            c, s = math.cos(a), math.sin(a)
            out[:, i] = x[:, i] * c - x[:, i + d // 2] * s
            out[:, i + d // 2] = x[:, i + d // 2] * c + x[:, i] * s
        return out

    x = w["wte.weight"][ids]
    for layer in range(C["num_hidden_layers"]):
        p = f"layers.{layer}."
        h = norm(x, w[p + "input_layernorm.weight"])
        q = (h @ w[p + "attn.q_proj.weight"].T).view(n, H, d)
        k = (h @ w[p + "attn.k_proj.weight"].T).view(n, Hkv, d)
        v = (h @ w[p + "attn.v_proj.weight"].T).view(n, Hkv, d)
        q = torch.stack([rot(q[t], t) for t in range(n)])
        k = torch.stack([rot(k[t], t) for t in range(n)])
        a = torch.zeros(n, H, d, dtype=torch.float64)
        for t in range(n):
            keys = [j for j in range(t + 1) if t - j <= W]
            for hh in range(H):
                kv = hh // (H // Hkv)
                s = torch.stack([q[t, hh] @ k[j, kv] for j in keys]) \
                    / math.sqrt(d)
                pr = torch.softmax(s, 0)
                a[t, hh] = sum(pr[i] * v[j, kv] for i, j in enumerate(keys))
        x = x + a.reshape(n, H * d) @ w[p + "attn.o_proj.weight"].T
        h = norm(x, w[p + "post_attention_layernorm.weight"])
        g = h @ w[p + "mlp.gate_proj.weight"].T
        u = h @ w[p + "mlp.up_proj.weight"].T
        x = x + (g * torch.sigmoid(g) * u) @ w[p + "mlp.down_proj.weight"].T
    return norm(x, w["norm.weight"]) @ w["lm_head.weight"].T


def test_served_logits_match_float64():
    w = weights()
    ids = torch.randint(0, C["vocab_size"], (14,),
                        generator=torch.Generator().manual_seed(1))
    got = ref.served_logits(w, C, [(ids, 3)])[0]
    want = f64_logits(w, ids)[3:]
    assert got.dtype == torch.float32
    assert (got.double() - want).abs().max() < 1e-4


def test_reference_matches_the_ports_forward():
    w = weights()
    model = family.build(family.port_config(C, train=False), w,
                         torch.device("cpu"), train=False)
    ids = torch.randint(0, C["vocab_size"], (2, 40),
                        generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        port = model(ids)
    mine = ref.served_logits(w, C, [(ids[0], 0), (ids[1], 0)])
    for a, b in zip(port, mine):
        assert (a - b).abs().max() < 1e-4


def test_training_step_matches_float64():
    w = weights(seed=5)
    ids = torch.randint(0, C["vocab_size"], (2, 12),
                        generator=torch.Generator().manual_seed(3))
    out = ref.train(w, C, [ids], {"lr": 1e-3, "weight_decay": 0.1})
    params = {k: v.double().requires_grad_() for k, v in w.items()}
    losses = []
    for row in ids:
        lg = f64_logits(params, row)[:-1]
        losses.append(torch.nn.functional.cross_entropy(lg, row[1:],
                                                        reduction="sum"))
    loss = sum(losses) / (ids.shape[0] * (ids.shape[1] - 1))
    grads = torch.autograd.grad(loss, list(params.values()))
    assert out["losses"][0] == pytest.approx(float(loss.detach()), rel=1e-5)
    for (name, _), g in zip(params.items(), grads):
        assert out["grad_norms"][name] == pytest.approx(float(g.norm()),
                                                        rel=1e-4, abs=1e-9)
    # one AdamW step from zero moments moves each element by lr (sign of
    # its gradient) plus the decay, where the gradient is well above eps
    lr, wd = 1e-3, 0.1
    for (name, p), g in zip(params.items(), grads):
        step = lr * torch.sign(g) * (g.abs() > 1e-6) + lr * wd * p.detach()
        assert out["change_norms"][name] == pytest.approx(
            float(step.norm()), rel=1e-2)


def test_fp8_control_differs_from_float32():
    w = weights()
    ids = torch.randint(0, C["vocab_size"], (30,),
                        generator=torch.Generator().manual_seed(4))
    a = ref.served_logits(w, C, [(ids, 0)])[0]
    b = ref.served_logits(w, C, [(ids, 0)], mode="fp8")[0]
    err = (a - b).abs().max()
    assert 1e-3 < err < 0.5 * a.abs().max()
