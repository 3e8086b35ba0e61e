"""The port's Llama training step against the JAX package's.

One flax init of ``LlamaConfig.tiny(dtype=float32)`` (GQA group 2,
head_dim 32, untied head) is converted into the port's model. The hidden
state and head of ``return_hidden``, the loss, every gradient, and the
losses of two AdamW steps (``optax.adamw(1e-3)`` there,
``torch.optim.AdamW(lr=1e-3, weight_decay=1e-4)`` here: the second loss
sees the first update) must agree with the JAX package's, with and without
``lm_loss_chunk``. Both sides compute in fp32 on the CPU: atol = rtol =
1e-4 (two layers of fp32 sums and fp32 rotary in different orders).
``chunked_lm_loss`` must equal the full loss within 1e-5 (the same
products summed by chunk), and ``remat=True`` must give the no-remat loss
and gradients within atol = rtol = 1e-6 (the same fp32 operations
recomputed in the same order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flash_attn_tpu.models import gpt2 as jax_gpt2
from flash_attn_tpu.models import llama as jax_llama
from flash_attn_tpu_torch.models.convert import llama_from_jax_params
from flash_attn_tpu_torch.models.gpt2 import (
    chunked_lm_loss,
    cross_entropy_loss,
)
from flash_attn_tpu_torch.models.llama import LlamaConfig, make_train_step

ATOL = RTOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32)
    jmodel = jax_llama.LlamaForCausalLM(jcfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jcfg.vocab_size, (2, 96))
    labels = ids.copy()
    labels[:, 30:40] = -100  # ignored positions
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids, jnp.int32))
    return jmodel, params, jax.tree_util.tree_map(np.asarray, params), ids, \
        labels


def _port(np_params, **kw):
    return llama_from_jax_params(np_params, LlamaConfig.tiny(**kw),
                                 device="cpu")


def _batch(ids, labels):
    return {"input_ids": torch.from_numpy(ids),
            "labels": torch.from_numpy(labels)}


def _port_name(path):
    keys = [k.key for k in path]
    name = ".".join(keys).replace("layers_", "layers.")
    name = name.replace(".kernel", ".weight").replace(".scale", ".weight")
    return name + ".weight" if name in ("wte", "lm_head") else name


def test_hidden_loss_and_grads_match_jax(setup):
    jmodel, params, np_params, ids, labels = setup
    jids, jlabels = jnp.asarray(ids, jnp.int32), jnp.asarray(labels)
    x_j, head_j = jmodel.apply(params, jids, return_hidden=True)

    def loss_fn(p):
        return jax_gpt2.cross_entropy_loss(jmodel.apply(p, jids), jlabels)

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    model = _port(np_params)
    b = _batch(ids, labels)
    with torch.no_grad():
        x, head = model(b["input_ids"], return_hidden=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), atol=ATOL,
                               rtol=RTOL)
    assert head is model.lm_head.weight
    np.testing.assert_array_equal(head.detach().numpy(), np.asarray(head_j))
    loss = cross_entropy_loss(model(b["input_ids"]), b["labels"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=ATOL,
                               rtol=RTOL)
    sd = dict(model.named_parameters())
    leaves = jax.tree_util.tree_flatten_with_path(grads_j["params"])[0]
    assert len(leaves) == len(sd)
    for path, leaf in leaves:
        name = _port_name(path)
        want = np.asarray(leaf)
        if path[-1].key == "kernel":
            want = want.T
        np.testing.assert_allclose(sd[name].grad.numpy(), want, atol=ATOL,
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("lm_loss_chunk", [None, 32])
def test_adamw_steps_match_jax(setup, lm_loss_chunk):
    """Two AdamW steps: the first loss, and the second after the first
    update."""
    jmodel, params, np_params, ids, labels = setup
    opt = optax.adamw(1e-3)
    jstep = jax.jit(jax_llama.make_train_step(jmodel, opt,
                                              lm_loss_chunk=lm_loss_chunk))
    jb = {"input_ids": jnp.asarray(ids, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    jp, state, want = params, opt.init(params), []
    for _ in range(2):
        jp, state, loss = jstep(jp, state, jb)
        want.append(float(loss))
    model = _port(np_params)
    step = make_train_step(model, torch.optim.AdamW(
        model.parameters(), lr=1e-3, weight_decay=1e-4),
        lm_loss_chunk=lm_loss_chunk)
    got = [float(step(_batch(ids, labels))) for _ in range(2)]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert got[1] < got[0]


def test_chunked_loss_equals_full(setup):
    *_, np_params, ids, labels = setup
    model = _port(np_params)
    b = _batch(ids, labels)
    with torch.no_grad():
        full = cross_entropy_loss(model(b["input_ids"]), b["labels"])
        x, head = model(b["input_ids"], return_hidden=True)
        for chunk in (16, 40, 95, 128):
            got = chunked_lm_loss(x, head, b["labels"], chunk=chunk,
                                  dtype=torch.float32)
            np.testing.assert_allclose(float(got), float(full), atol=1e-5,
                                       rtol=1e-5, err_msg=f"chunk {chunk}")


def _grads(model, b, lm_loss_chunk=None):
    model.zero_grad(set_to_none=True)
    if lm_loss_chunk is None:
        loss = cross_entropy_loss(model(b["input_ids"]), b["labels"])
    else:
        x, head = model(b["input_ids"], return_hidden=True)
        loss = chunked_lm_loss(x, head, b["labels"], chunk=lm_loss_chunk,
                               dtype=torch.float32)
    loss.backward()
    return loss.item(), {n: p.grad.clone()
                         for n, p in model.named_parameters()}


@pytest.mark.parametrize("lm_loss_chunk", [None, 32])
def test_remat_gives_the_same_grads(setup, lm_loss_chunk):
    *_, np_params, ids, labels = setup
    b = _batch(ids, labels)
    loss, grads = _grads(_port(np_params), b, lm_loss_chunk)
    model_r = _port(np_params, remat=True)
    assert model_r.config == dataclasses.replace(LlamaConfig.tiny(),
                                                 remat=True)
    loss_r, grads_r = _grads(model_r, b, lm_loss_chunk)
    np.testing.assert_allclose(loss_r, loss, atol=1e-6, rtol=1e-6)
    for name, g in grads.items():
        torch.testing.assert_close(grads_r[name], g, atol=1e-6, rtol=1e-6,
                                   msg=name)
