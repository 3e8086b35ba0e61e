"""The port's GPT-2 training step against the JAX package's.

One flax init of ``GPT2Config.tiny(dtype=float32)`` (dropout 0) is
converted into the port's model; logits, both losses, the gradient of every
parameter and the parameters after one AdamW step must agree with the JAX
package's (``optax.adamw(1e-4)`` there, ``torch.optim.AdamW(lr=1e-4,
weight_decay=1e-4)`` here). Both sides compute in fp32 on the CPU, so the
tolerance is atol = rtol = 1e-4 for logits, losses and gradients (two layers
of fp32 sums in different orders; observed: logits 9e-7, gradients 6e-8
apart), and atol = 1e-6 for the parameters
after one step (an AdamW step moves each by at most about lr = 1e-4).
Where a gradient is below 1e-6 in magnitude (zero in exact arithmetic, as
for the key bias, to which the softmax is blind) Adam's first step
g / (|g| + 1e-8) turns fp32 noise into a step anywhere in [-lr, lr]; those
parameters are held to atol = 2e-4 (twice the step) instead.

Dropout at the model level is held to itself only: flax draws the
embedding and MLP masks from JAX's RNG, which torch cannot replay; the
attention mask is the coordinate hash held bit for bit in
test_torch_prng.py and test_torch_attention_bwd.py.
"""

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
    GPT2LMHeadModel,
    chunked_lm_loss,
    cross_entropy_loss,
    make_train_step,
)

ATOL = RTOL = 1e-4


def _port_name(path):
    """flax parameter path -> (port state_dict name, transpose?)."""
    keys = [k.key for k in path]
    name = ".".join(keys).replace("h_", "h.")
    name = (name.replace(".kernel", ".weight").replace(".scale", ".weight")
            .replace("wte", "wte.weight").replace("wpe", "wpe.weight"))
    return name, keys[-1] == "kernel"


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_gpt2.GPT2Config.tiny(dtype=jnp.float32)
    jmodel = jax_gpt2.GPT2LMHeadModel(jcfg)
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 128))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids, jnp.int32))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, jmodel, params, np_params, ids


def _port(np_params, **cfg_kw):
    cfg = GPT2Config.tiny(dtype=torch.float32, **cfg_kw)
    return gpt2_from_jax_params(np_params, cfg, device="cpu")


def _batch(ids):
    t = torch.from_numpy(ids)
    return {"input_ids": t, "labels": t}


def test_logits_and_losses_match_jax(setup):
    jcfg, jmodel, params, np_params, ids = setup
    model = _port(np_params)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    jids = jnp.asarray(ids, jnp.int32)
    logits_j = jmodel.apply(params, jids)
    x_j, wte_j = jmodel.apply(params, jids, return_hidden=True)
    with torch.no_grad():
        logits = model(torch.from_numpy(ids))
        x, wte = model(torch.from_numpy(ids), return_hidden=True)
        labels = torch.from_numpy(ids)
        loss = cross_entropy_loss(logits, labels)
        chunked = chunked_lm_loss(x, wte, labels, chunk=64,
                                  dtype=torch.float32)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               atol=ATOL, rtol=RTOL)
    want = float(jax_gpt2.cross_entropy_loss(logits_j, jids))
    np.testing.assert_allclose(float(loss), want, atol=ATOL, rtol=RTOL)
    want_c = float(jax_gpt2.chunked_lm_loss(x_j, wte_j, jids, chunk=64,
                                            dtype=jnp.float32))
    np.testing.assert_allclose(float(chunked), want_c, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(chunked), float(loss), atol=1e-5)


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


def test_every_grad_matches_jax(setup):
    jcfg, jmodel, params, np_params, ids = setup
    jids = jnp.asarray(ids, jnp.int32)

    def loss_fn(p):
        return jax_gpt2.cross_entropy_loss(jmodel.apply(p, jids), jids)

    grads = jax.jit(jax.grad(loss_fn))(params)
    model = _port(np_params)
    batch = _batch(ids)
    cross_entropy_loss(model(batch["input_ids"]), batch["labels"]).backward()
    _check_tree(model, grads, ATOL, RTOL, "grad")


@pytest.mark.parametrize("lm_loss_chunk", [None, 64])
def test_adamw_step_matches_jax(setup, lm_loss_chunk):
    jcfg, jmodel, params, np_params, ids = setup
    opt = optax.adamw(1e-4)
    jstep = jax.jit(jax_gpt2.make_train_step(jmodel, opt,
                                             lm_loss_chunk=lm_loss_chunk))
    new_params, _, loss_j = jstep(params, opt.init(params),
                                  {"input_ids": jnp.asarray(ids, jnp.int32),
                                   "labels": jnp.asarray(ids, jnp.int32)},
                                  jax.random.PRNGKey(0))
    model = _port(np_params)
    step = make_train_step(
        model, torch.optim.AdamW(model.parameters(), lr=1e-4,
                                 weight_decay=1e-4),
        lm_loss_chunk=lm_loss_chunk)
    loss = step(_batch(ids))
    np.testing.assert_allclose(float(loss), float(loss_j), atol=ATOL,
                               rtol=RTOL)
    _check_tree(model, new_params, 1e-6, 0.0, "param")


def test_loss_falls_over_five_steps(setup):
    *_, np_params, ids = setup
    model = _port(np_params)
    step = make_train_step(model, torch.optim.AdamW(
        model.parameters(), lr=1e-3, weight_decay=1e-4))
    losses = [float(step(_batch(ids))) for _ in range(5)]
    assert losses[-1] < losses[0] - 0.5, losses


def _grads(model, ids, seed):
    batch = _batch(ids)
    model.zero_grad(set_to_none=True)
    loss = cross_entropy_loss(
        model(batch["input_ids"], deterministic=False,
              generator=torch.Generator().manual_seed(seed)),
        batch["labels"])
    loss.backward()
    return loss.item(), {n: p.grad.clone()
                         for n, p in model.named_parameters()}


def test_remat_gives_the_same_grads(setup):
    """Per-block recompute under dropout: the recomputed block must draw
    the same masks as the first pass."""
    *_, np_params, ids = setup
    loss, grads = _grads(_port(np_params, dropout=0.1), ids, 5)
    loss_r, grads_r = _grads(_port(np_params, dropout=0.1, remat=True), ids, 5)
    assert loss_r == loss
    for name, g in grads.items():
        torch.testing.assert_close(grads_r[name], g, atol=1e-6, rtol=1e-6,
                                   msg=name)


def test_dropout_is_seeded(setup):
    *_, np_params, ids = setup
    model = _port(np_params, dropout=0.1)
    a, _ = _grads(model, ids, 11)
    b, _ = _grads(model, ids, 11)
    c, _ = _grads(model, ids, 12)
    plain, _ = _grads(_port(np_params), ids, 11)
    assert a == b
    assert a != c and a != plain


@pytest.mark.parametrize("policy", ["dots", "dots_flash"])
def test_remat_policies_raise(policy):
    """Each policy builds; a name that is not one raises the JAX
    ValueError (with remat=False the policy is ignored, as in JAX)."""
    GPT2LMHeadModel(GPT2Config.tiny(remat=True, remat_policy=policy),
                    generator=torch.Generator(), device="cpu")
    bad = policy.upper()
    with pytest.raises(ValueError, match="remat_policy"):
        GPT2LMHeadModel(GPT2Config.tiny(remat=True, remat_policy=bad),
                        generator=torch.Generator(), device="cpu")
    GPT2LMHeadModel(GPT2Config.tiny(remat_policy=bad),
                    generator=torch.Generator(), device="cpu")


@pytest.mark.parametrize("num_kv_heads", [None, 2])
def test_flash_mha_matches_jax(num_kv_heads):
    """The port's FlashMHA (MHA, and GQA with its [q | k | v] split) against
    flax's, same weights: output and input gradient, fp32."""
    from flash_attn_tpu.models.modules import FlashMHA as JaxFlashMHA
    from flash_attn_tpu_torch.models.modules import FlashMHA

    e, h = 128, 4
    x = np.random.default_rng(7).standard_normal((2, 96, e)).astype(
        np.float32)
    jmha = JaxFlashMHA(embed_dim=e, num_heads=h, num_kv_heads=num_kv_heads,
                       causal=True, dtype=jnp.float32)
    params = jmha.init(jax.random.PRNGKey(1), jnp.asarray(x))
    out_j, vjp = jax.vjp(lambda x_: jmha.apply(params, x_), jnp.asarray(x))
    (dx_j,) = vjp(jnp.ones_like(out_j))
    mha = FlashMHA(e, h, num_kv_heads=num_kv_heads, causal=True,
                   dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for name in ("Wqkv", "out_proj"):
            tree = params["params"][name]
            lin = getattr(mha, name)
            lin.weight.copy_(torch.from_numpy(np.array(tree["kernel"]).T))
            lin.bias.copy_(torch.from_numpy(np.array(tree["bias"])))
    xt = torch.from_numpy(x).requires_grad_()
    out = mha(xt)
    out.backward(torch.ones_like(out))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), atol=ATOL,
                               rtol=RTOL)


def test_dropout_oracle_matches_jax_reference():
    """attention_ref with a dropout mask and the pre-dropout probabilities,
    against the JAX package's reference."""
    from flash_attn_tpu.kernels.prng import dropout_mask_dense as jax_mask
    from flash_attn_tpu.reference import attention_ref as jax_attention_ref
    from flash_attn_tpu_torch.reference import attention_ref

    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((1, 2, 70, 64)).astype(np.float32)
               for _ in range(3))
    keep = np.array(jax_mask(jnp.uint32(3), 1, 2, 70, 70, 0.2))
    out_j, probs_j = jax_attention_ref(
        *map(jnp.asarray, (q, k, v)), causal=True,
        dropout_mask=jnp.asarray(keep), dropout_p=0.2,
        return_attn_probs=True)
    out, probs = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=True,
                               dropout_mask=torch.from_numpy(keep),
                               dropout_p=0.2, return_attn_probs=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(probs.numpy(), np.asarray(probs_j), atol=1e-6)
