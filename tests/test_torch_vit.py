"""The port's ViT against the JAX package's.

One flax init of ``ViTConfig.tiny()`` (fp32; 2-D rotary over the 8 x 8
patch grid, or a learned ``pos_embed``) is converted into the port's
model by ``vit_from_jax_params``; logits, the fp32 cross entropy, and the
losses of two dropout-0 AdamW steps (``optax.adamw(1e-3)`` there,
``torch.optim.AdamW(lr=1e-3, weight_decay=1e-4)`` here: the second loss
sees the first update) must agree. Both sides compute in fp32 on the CPU
(the port's plain twins, JAX's Pallas kernels in interpret mode): atol =
rtol = 1e-4 (two layers of fp32 sums in different orders).

With ``dtype=bf16`` each of the port's intermediates must carry the dtype
of its counterpart in the flax model (``capture_intermediates``): the
patch convolution, attention and MLP in bf16, the LayerNorms and the head
in fp32. Dropout at the model level is held to itself only (flax draws
its masks from JAX's RNG).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flash_attn_tpu.models import vit as jvit
from flash_attn_tpu_torch.models import vit as tvit
from flash_attn_tpu_torch.models.bert import layer_norm
from flash_attn_tpu_torch.models.convert import vit_from_jax_params

ATOL = RTOL = 1e-4
B = 3


def _close(got, want, name=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL, err_msg=name)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (B, cfg.image_size, cfg.image_size, cfg.num_channels)).astype(
        np.float32)
    labels = rng.integers(0, cfg.num_classes, B).astype(np.int32)
    return {"images": images, "labels": labels}


@pytest.fixture(scope="module", params=[True, False],
                ids=["rotary-2d", "pos-embed"])
def setup(request):
    jcfg = jvit.ViTConfig.tiny(use_rotary=request.param)
    jmodel = jvit.ViTClassifier(jcfg)
    batch = _batch(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batch["images"]))
    cfg = tvit.ViTConfig.tiny(use_rotary=request.param)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return jmodel, params, np_params, cfg, batch


def _torch_batch(batch):
    return {"images": torch.from_numpy(batch["images"]),
            "labels": torch.from_numpy(batch["labels"]).long()}


def test_vit_logits_and_loss_match_jax(setup):
    jmodel, params, np_params, cfg, batch = setup
    model = vit_from_jax_params(np_params, cfg, device="cpu")
    assert (model.pos_embed is None) == cfg.use_rotary
    want = jmodel.apply(params, jnp.asarray(batch["images"]))
    tb = _torch_batch(batch)
    with torch.no_grad():
        got = model(tb["images"])
    assert got.dtype == torch.float32 and got.shape == (B, cfg.num_classes)
    _close(got, want, "logits")
    logp = jax.nn.log_softmax(want, axis=-1)
    want_loss = -jnp.mean(jnp.take_along_axis(
        logp, jnp.asarray(batch["labels"])[:, None], axis=-1))
    _close(tvit.classification_loss(got, tb["labels"]), want_loss, "loss")


def test_vit_train_steps_match_jax(setup):
    """Two dropout-0 AdamW steps: the first loss, and the second after the
    first update."""
    jmodel, params, np_params, cfg, batch = setup
    opt = optax.adamw(1e-3)
    jstep = jax.jit(jvit.make_train_step(jmodel, opt))
    jp, state = params, opt.init(params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = []
    for i in range(2):
        jp, state, loss = jstep(jp, state, jb, jax.random.PRNGKey(i))
        want.append(loss)
    model = vit_from_jax_params(np_params, cfg, device="cpu")
    step = tvit.make_train_step(model, torch.optim.AdamW(
        model.parameters(), lr=1e-3, weight_decay=1e-4))
    got = [step(_torch_batch(batch)) for _ in range(2)]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"loss {i}")


def test_vit_dtype_promotion():
    """ViTConfig(dtype=bf16): every intermediate has the dtype of its flax
    counterpart; dropout runs from a generator, the same seed giving the
    same logits."""
    jcfg = jvit.ViTConfig.tiny(dtype=jnp.bfloat16, n_layer=1)
    batch = _batch(jcfg, seed=1)
    images = jnp.asarray(batch["images"])
    jmodel = jvit.ViTClassifier(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), images)
    _, inter = jmodel.apply(params, images, capture_intermediates=True,
                            mutable=["intermediates"])
    inter = inter["intermediates"]

    def jdtype(*path):
        tree = inter
        for key in path:
            tree = tree[key]
        return str(tree["__call__"][0].dtype)

    cfg = tvit.ViTConfig.tiny(dtype=torch.bfloat16, n_layer=1, dropout=0.1)
    model = vit_from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                cfg, device="cpu")
    tb = _torch_batch(batch)
    with torch.no_grad():
        conv = model.patch_embed
        x = torch.nn.functional.conv2d(
            tb["images"].permute(0, 3, 1, 2).to(cfg.dtype),
            conv.weight.to(cfg.dtype), conv.bias.to(cfg.dtype),
            stride=conv.stride).flatten(2).transpose(1, 2)  # (b, S, E)
        block = model.block_0
        h = layer_norm(x, block.ln1)
        got = {("patch_embed",): x, ("block_0", "ln1"): h,
               ("block_0", "attn"): block.attn(h), ("block_0",): block(x),
               ("ln_final",): layer_norm(x, model.ln_final),
               (): model(tb["images"])}
    for path, t in got.items():
        want = jdtype(*path)
        assert str(t.dtype).removeprefix("torch.") == want, (path, t.dtype,
                                                              want)
    runs = [model(tb["images"], deterministic=False,
                  generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], got[()])
    assert all(p.dtype == torch.float32 for p in model.parameters())
