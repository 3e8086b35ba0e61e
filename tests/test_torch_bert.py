"""The port's BERT and attention modules against the JAX package's.

One flax init of ``BertConfig.tiny()`` (fp32) is converted into the port's
model by ``bert_from_jax_params``; with padding masks (rows of different
lengths, one of them full), logits and ``mlm_loss`` must agree, and so
must the losses of two dropout-0 AdamW steps (``optax.adamw(1e-3)`` there,
``torch.optim.AdamW(lr=1e-3, weight_decay=1e-4)`` here: the second loss
sees the first update). ``FlashMHA`` with ``key_padding_mask`` (MHA and
GQA) and with 1-D and 2-D rotary, and ``FlashAttention`` over packed qkv
with ``cu_seqlens``, against the flax modules on the same parameters. Both
sides compute in fp32 on the CPU (the port's plain twins, JAX's Pallas
kernels in interpret mode): atol = rtol = 1e-4 (two layers of fp32 sums in
different orders).

Dropout at the model level is held to itself only (flax draws its masks
from JAX's RNG); the attention masks are the coordinate hash, held bit for
bit in test_torch_varlen.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flash_attn_tpu.models import bert as jbert
from flash_attn_tpu.models import modules as jmod
from flash_attn_tpu_torch.models import bert as tbert
from flash_attn_tpu_torch.models.convert import (
    bert_from_jax_params,
    mha_from_jax_params,
)
from flash_attn_tpu_torch.models.modules import FlashAttention, FlashMHA
from flash_attn_tpu_torch.utils.testing import cu_seqlens

ATOL = RTOL = 1e-4
B, S = 3, 80
LENGTHS = [80, 37, 61]


def _close(got, want, name=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL, err_msg=name)


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, size=(B, S)).astype(np.int32)
    mask = (np.arange(S)[None] < np.asarray(LENGTHS)[:, None]).astype(
        np.int32)
    labels = rng.integers(3, vocab, size=(B, S)).astype(np.int32)
    label_mask = ((rng.random((B, S)) < 0.15) & (mask == 1)).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask, "labels": labels,
            "label_mask": label_mask}


@pytest.fixture(scope="module")
def setup():
    jcfg = jbert.BertConfig.tiny(dropout=0.0)
    jmodel = jbert.BertForMaskedLM(jcfg)
    batch = _batch(jcfg.vocab_size)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.asarray(batch["input_ids"]),
                         jnp.asarray(batch["attention_mask"]))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return jmodel, params, np_params, batch


def _port(np_params):
    return bert_from_jax_params(np_params, tbert.BertConfig.tiny(dropout=0.0),
                                device="cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def test_bert_logits_and_mlm_loss_match_jax(setup):
    jmodel, params, np_params, batch = setup
    model = _port(np_params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jmodel.apply(params, jb["input_ids"],
                        attention_mask=jb["attention_mask"])
    tb = _torch_batch(batch)
    with torch.no_grad():
        got = model(tb["input_ids"], attention_mask=tb["attention_mask"])
    assert got.dtype == torch.float32 and got.shape == (B, S, 1024)
    _close(got, want, "logits")
    _close(tbert.mlm_loss(got, tb["labels"], tb["label_mask"]),
           jbert.mlm_loss(want, jb["labels"], jb["label_mask"]), "mlm_loss")


def test_bert_train_steps_match_jax(setup):
    """Two dropout-0 AdamW steps: the first loss, and the second after the
    first update."""
    jmodel, params, np_params, batch = setup
    jstep = jax.jit(jbert.make_train_step(jmodel, optax.adamw(1e-3)))
    opt = optax.adamw(1e-3)
    jp, state = params, opt.init(params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = []
    for _ in range(2):
        jp, state, loss = jstep(jp, state, jb, jax.random.PRNGKey(1))
        want.append(loss)
    model = _port(np_params)
    step = tbert.make_train_step(
        model, torch.optim.AdamW(model.parameters(), lr=1e-3,
                                 weight_decay=1e-4))
    got = [step(_torch_batch(batch)) for _ in range(2)]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"loss {i}")


def test_bert_dtype_promotion():
    """BertConfig(dtype=bf16): FlashMHA and the MLP Denses compute in
    bf16, the embeddings, LayerNorms, residual stream and the head in
    fp32; dropout runs from a generator, the same seed giving the same
    logits."""
    cfg = tbert.BertConfig.tiny(dtype=torch.bfloat16, n_layer=1)
    model = tbert.BertForMaskedLM(cfg, generator=torch.Generator().manual_seed(
        0), device="cpu")
    tb = _torch_batch(_batch(cfg.vocab_size))
    runs = [model(tb["input_ids"], attention_mask=tb["attention_mask"],
                  deterministic=False,
                  generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert runs[0].dtype == torch.float32
    assert torch.equal(runs[0], runs[1])
    x = model.bert.embeddings(tb["input_ids"], torch.zeros_like(
        tb["input_ids"]))
    assert x.dtype == torch.float32
    a = model.bert.layer_0.attention(x, key_padding_mask=tb["attention_mask"]
                                     .bool())
    assert a.dtype == torch.bfloat16
    assert model.bert.layer_0(x, tb["attention_mask"].bool()).dtype \
        == torch.float32


def _mha_params(module, x, mask):
    return module.init(jax.random.PRNGKey(3), jnp.asarray(x),
                       key_padding_mask=jnp.asarray(mask))


@pytest.mark.parametrize("kw", [
    dict(num_heads=4), dict(num_heads=4, num_kv_heads=2),
    dict(num_heads=4, causal=True, use_rotary_emb="1d"),
    dict(num_heads=2, num_kv_heads=1, use_rotary_emb="2d"),
], ids=["mha", "gqa", "rotary-1d-causal", "rotary-2d-gqa"])
def test_flash_mha_matches_flax(kw):
    """key_padding_mask on both branches (MHA and GQA), 1-D and 2-D rotary
    (a 9 x 9 grid)."""
    rng = np.random.default_rng(4)
    s = 81
    x = rng.standard_normal((2, s, 128)).astype(np.float32)
    mask = np.arange(s)[None] < np.asarray([[s], [50]])
    jm = jmod.FlashMHA(embed_dim=128, **kw)
    params = _mha_params(jm, x, mask)
    want = jm.apply(params, jnp.asarray(x), key_padding_mask=jnp.asarray(mask))
    tm = mha_from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                             FlashMHA(128, device="cpu", **kw))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), key_padding_mask=torch.from_numpy(mask))
    _close(got, want)


def test_flash_attention_cu_seqlens_matches_flax():
    """FlashAttention over packed (nnz, 3, h, d) qkv with cu_seqlens and
    max_s, causal, against the flax module."""
    rng = np.random.default_rng(5)
    lengths = [30, 1, 0, 45]
    qkv = rng.standard_normal((sum(lengths), 3, 2, 64)).astype(np.float32)
    cu = cu_seqlens(lengths)
    want = jmod.FlashAttention().apply(
        {}, jnp.asarray(qkv), causal=True, cu_seqlens=jnp.asarray(cu),
        max_s=45)
    got = FlashAttention()(torch.from_numpy(qkv), causal=True,
                           cu_seqlens=torch.from_numpy(cu), max_s=45)
    _close(got, want)
    with pytest.raises(ValueError, match="max_s"):
        FlashAttention()(torch.from_numpy(qkv),
                         cu_seqlens=torch.from_numpy(cu))
