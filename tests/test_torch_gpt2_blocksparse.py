"""GPT-2 with blocksparse attention through ``attn_impl``, the port against
the JAX package.

A flax ``GPT2LMHeadModel(cfg, attn_impl=...)`` whose attention op is the
JAX ``blocksparse_attention`` (its Pallas kernels in interpret mode) is
initialised once; ``gpt2_from_jax_params`` carries the same parameter tree
into the port's model, whose ``attn_impl`` is the port's
``blocksparse_attention`` (its plain twins on the CPU). 2 layers, n_embd
128, 2 heads, s = 512, dropout 0, fp32 on both sides; the mask is
``LocalGlobalSparsityConfig(window=128, num_global_rows=2)``, causal: the
first 32 rows see every cell, all rows the first 256 keys, rows 128..384
also the second 256 (no band; at s = 512 a window of 256 would cover every
cell). Logits, loss and every gradient are held to atol = rtol = 1e-4,
and the parameters after one AdamW step to atol 1e-6 (2e-4 where the
gradient is below 1e-6: Adam's first step turns fp32 noise there into a
step anywhere in [-lr, lr]), as in test_torch_gpt2_train.py. JAX's band
routing is off (the mask is no band; see test_torch_blocksparse.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flash_attn_tpu.ops.blocksparse as jax_ops
from flash_attn_tpu.kernels import blocksparse as jax_kernels
from flash_attn_tpu.models import gpt2 as jax_gpt2
from flash_attn_tpu_torch.kernels import blocksparse as bs
from flash_attn_tpu_torch.models.blocksparse_modules import (
    LocalGlobalSparsityConfig,
)
from flash_attn_tpu_torch.models.convert import gpt2_from_jax_params
from flash_attn_tpu_torch.models.gpt2 import (
    GPT2Config,
    cross_entropy_loss,
    make_train_step,
)
from flash_attn_tpu_torch.ops.blocksparse import blocksparse_attention

ATOL = RTOL = 1e-4
S = 512
CFG = dict(n_layer=2, n_embd=128, n_head=2, max_position_embeddings=S)


def _mask():
    return LocalGlobalSparsityConfig(window=128,
                                     num_global_rows=2).make_layout(S)


def _port_attn():
    layout = bs.build_layout(_mask(), sq=S, sk=S, causal=True)

    def attn(q, k, v, dropout_seed=None):
        return blocksparse_attention(q, k, v, layout, causal=True)

    return attn


@pytest.fixture(scope="module")
def setup():
    saved = jax_ops.ENABLE_BAND_ROUTE
    jax_ops.ENABLE_BAND_ROUTE = False
    layout = jax_kernels.build_layout(_mask(), sq=S, sk=S, causal=True)
    assert layout.band_route is None

    def jax_attn(q, k, v, dropout_seed=None):
        return jax_ops.blocksparse_attention(q, k, v, layout, causal=True)

    jcfg = jax_gpt2.GPT2Config.tiny(dtype=jnp.float32, **CFG)
    jmodel = jax_gpt2.GPT2LMHeadModel(jcfg, attn_impl=jax_attn)
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, S))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids, jnp.int32))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    yield jmodel, params, np_params, ids
    jax_ops.ENABLE_BAND_ROUTE = saved


def _port(np_params):
    cfg = GPT2Config.tiny(dtype=torch.float32, **CFG)
    return gpt2_from_jax_params(np_params, cfg, device="cpu",
                                attn_impl=_port_attn())


def _port_name(path):
    """flax parameter path -> (port state_dict name, transpose?)."""
    keys = [k.key for k in path]
    name = ".".join(keys).replace("h_", "h.")
    name = (name.replace(".kernel", ".weight").replace(".scale", ".weight")
            .replace("wte", "wte.weight").replace("wpe", "wpe.weight"))
    return name, keys[-1] == "kernel"


def _check_tree(model, tree, atol, rtol, what):
    sd = dict(model.named_parameters())
    leaves = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    assert len(leaves) == len(sd)
    for path, leaf in leaves:
        name, transpose = _port_name(path)
        got = getattr(sd[name], "grad" if what == "grad" else "data").numpy()
        want = np.asarray(leaf).T if transpose else np.asarray(leaf)
        tol = np.full(got.shape, atol, np.float32)
        if what == "param":  # ill-conditioned first Adam step, see above
            tol[np.abs(sd[name].grad.numpy()) < 1e-6] = 2e-4
        assert got.shape == want.shape, name
        bad = np.abs(got - want) > tol + rtol * np.abs(want)
        assert not bad.any(), (
            f"{what} {name}: {bad.sum()} of {bad.size} differ, max "
            f"{np.abs(got - want).max():.3e}")


def test_logits_loss_and_grads_match_jax(setup):
    jmodel, params, np_params, ids = setup
    jids = jnp.asarray(ids, jnp.int32)

    def loss_fn(p):
        return jax_gpt2.cross_entropy_loss(jmodel.apply(p, jids), jids)

    logits_j = jmodel.apply(params, jids)
    loss_j, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = _port(np_params)
    t_ids = torch.from_numpy(ids)
    logits = model(t_ids)
    loss = cross_entropy_loss(logits, t_ids)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               atol=ATOL, rtol=RTOL)
    _check_tree(model, grads, ATOL, RTOL, "grad")


def test_adamw_step_matches_jax(setup):
    jmodel, params, np_params, ids = setup
    opt = optax.adamw(1e-4)
    jids = jnp.asarray(ids, jnp.int32)
    new_params, _, loss_j = jax.jit(jax_gpt2.make_train_step(jmodel, opt))(
        params, opt.init(params), {"input_ids": jids, "labels": jids},
        jax.random.PRNGKey(0))
    model = _port(np_params)
    step = make_train_step(model, torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4))
    t_ids = torch.from_numpy(ids)
    loss = step({"input_ids": t_ids, "labels": t_ids})
    np.testing.assert_allclose(float(loss), float(loss_j), atol=ATOL,
                               rtol=RTOL)
    _check_tree(model, new_params, 1e-6, 0.0, "param")
