"""GPT-2's remat policies (``GPT2Config.remat_policy`` None, "dots",
"dots_flash") against no remat, full remat and the JAX package's.

One flax init of ``GPT2Config.tiny(dtype=float32)`` is converted into the
port's model for every setting. A policy only chooses what the backward
keeps and what it recomputes, so under dropout 0.1 (the recompute draws
the same masks) the loss must equal the no-remat loss exactly and every
gradient must equal the no-remat and the full-remat gradients within
atol = rtol = 1e-6 (the same fp32 operations, in the same order, on the
CPU). The forward attention kernel's twin must run once per layer in a
"dots_flash" step and twice (forward and recompute) under None and "dots".
At dropout 0 each setting's gradients and AdamW step loss are held to
the JAX model with the same ``remat_policy`` at atol = rtol = 1e-4 (fp32
sums in different orders, as in test_torch_gpt2_train.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flash_attn_tpu.models import gpt2 as jax_gpt2
from flash_attn_tpu_torch.models.convert import gpt2_from_jax_params
from flash_attn_tpu_torch.models.gpt2 import (
    GPT2Config,
    cross_entropy_loss,
    make_train_step,
)
from flash_attn_tpu_torch.ops import attention as ops_attention

ATOL = RTOL = 1e-4
POLICIES = [None, "dots", "dots_flash"]


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_gpt2.GPT2Config.tiny(dtype=jnp.float32)
    ids = np.random.default_rng(11).integers(0, jcfg.vocab_size, (2, 128))
    params = jax_gpt2.GPT2LMHeadModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(ids, jnp.int32))
    return jcfg, params, jax.tree_util.tree_map(np.asarray, params), ids


def _port(np_params, **kw):
    return gpt2_from_jax_params(
        np_params, GPT2Config.tiny(dtype=torch.float32, **kw), device="cpu")


def _grads(model, ids, generator=None):
    t = torch.from_numpy(ids)
    model.zero_grad(set_to_none=True)
    loss = cross_entropy_loss(model(t, deterministic=generator is None,
                                    generator=generator), t)
    loss.backward()
    return loss.item(), {n: p.grad.clone()
                         for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_remat_policy_grads_match(setup, policy, monkeypatch):
    """Under dropout: the same loss and gradients as no remat and as full
    remat; the forward kernel runs again in the backward except under
    "dots_flash"."""
    *_, np_params, ids = setup
    calls = []
    fwd = ops_attention.flash_attention_fwd

    def counted(*args, **kwargs):
        calls.append(1)
        return fwd(*args, **kwargs)

    def run(**kw):
        return _grads(_port(np_params, dropout=0.1, **kw), ids,
                      torch.Generator().manual_seed(5))

    loss0, grads0 = run()
    loss_full, grads_full = run(remat=True)
    monkeypatch.setattr(ops_attention, "flash_attention_fwd", counted)
    loss, grads = run(remat=True, remat_policy=policy)
    n_layer = GPT2Config.tiny().n_layer
    assert len(calls) == n_layer * (1 if policy == "dots_flash" else 2)
    assert loss == loss0 == loss_full
    for name, g in grads.items():
        for want, what in ((grads0[name], "no remat"),
                           (grads_full[name], "full remat")):
            torch.testing.assert_close(g, want, atol=1e-6, rtol=1e-6,
                                       msg=f"{name} vs {what}")


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_remat_policy_step_matches_jax(setup, policy):
    """Every gradient, and the loss of one AdamW step, against the JAX
    model with the same remat policy (tests/test_gpt2.py's check)."""
    jcfg, params, np_params, ids = setup
    jmodel = jax_gpt2.GPT2LMHeadModel(
        dataclasses.replace(jcfg, remat=True, remat_policy=policy))
    jids = jnp.asarray(ids, jnp.int32)
    grads_j = jax.jit(jax.grad(lambda p: jax_gpt2.cross_entropy_loss(
        jmodel.apply(p, jids), jids)))(params)
    opt = optax.adamw(1e-4)
    _, _, loss_j = jax.jit(jax_gpt2.make_train_step(jmodel, opt))(
        params, opt.init(params), {"input_ids": jids, "labels": jids},
        jax.random.PRNGKey(0))

    model = _port(np_params, remat=True, remat_policy=policy)
    _, grads = _grads(model, ids)
    leaves = jax.tree_util.tree_flatten_with_path(grads_j["params"])[0]
    assert len(leaves) == len(grads)
    for path, leaf in leaves:
        keys = [k.key for k in path]
        name = (".".join(keys).replace("h_", "h.")
                .replace(".kernel", ".weight").replace(".scale", ".weight")
                .replace("wte", "wte.weight").replace("wpe", "wpe.weight"))
        want = np.asarray(leaf)
        if keys[-1] == "kernel":
            want = want.T
        np.testing.assert_allclose(grads[name].numpy(), want, atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    step = make_train_step(model, torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4))
    t = torch.from_numpy(ids)
    np.testing.assert_allclose(float(step({"input_ids": t, "labels": t})),
                               float(loss_j), atol=ATOL, rtol=RTOL)
