"""HF interop: ``transformers`` GPT-2 and Llama checkpoints loaded into the
port's models, against transformers' own logits and against the JAX
package's loaders.

The ``transformers`` models are built from in-code configs with random
weights (no download), as tests/test_hf_convert.py does. Everything runs
in fp32 on the CPU: the port's logits against transformers' at atol =
rtol = 2e-4 (GPT-2) and atol = 2e-4, rtol = 2e-3 (Llama), the tolerances
of the JAX package's own HF tests; against the JAX package's converted
model at atol = rtol = 1e-4 (two layers of fp32 sums in different
orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from flash_attn_tpu.models import convert as jax_convert  # noqa: E402
from flash_attn_tpu.models import gpt2 as jax_gpt2  # noqa: E402
from flash_attn_tpu.models import llama as jax_llama  # noqa: E402
from flash_attn_tpu_torch.models import (  # noqa: E402
    LlamaForCausalLM,
    convert_hf_gpt2_state_dict,
    convert_hf_llama_state_dict,
    gpt2_config_from_hf,
    llama_config_from_hf,
    load_hf_gpt2,
    load_hf_llama,
)
from flash_attn_tpu_torch.models.convert import (  # noqa: E402
    llama_from_jax_params,
)


def _hf_gpt2():
    hf_cfg = transformers.GPT2Config(
        vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(hf_cfg).eval()


def _hf_llama(tie=False):
    hf_cfg = transformers.LlamaConfig(
        vocab_size=512, hidden_size=128, intermediate_size=352,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
        attn_implementation="eager", tie_word_embeddings=tie)
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(hf_cfg).eval()


def _ids(vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (2, 64))


def test_gpt2_logits_match_transformers_and_jax():
    hf = _hf_gpt2()
    cfg = gpt2_config_from_hf(hf.config, dtype=torch.float32)
    _, model = load_hf_gpt2(hf, cfg, device="cpu")
    ids = _ids(cfg.vocab_size)
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).logits.numpy()
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    jcfg = jax_convert.gpt2_config_from_hf(hf.config, dtype=jnp.float32)
    params = jax_convert.convert_hf_gpt2_state_dict(hf.state_dict(), jcfg)
    want_j = jax_gpt2.GPT2LMHeadModel(jcfg).apply(
        params, jnp.asarray(ids, jnp.int32))
    np.testing.assert_allclose(got, np.asarray(want_j), atol=1e-4, rtol=1e-4)


def test_gpt2_state_dict_matches_jax_tree():
    """The converted state dict against JAX's tree, leaf by leaf (Conv1D
    kernels transposed into nn.Linear's (out, in)); the ``transformer.``
    prefix is optional."""
    hf = _hf_gpt2()
    cfg = gpt2_config_from_hf(hf.config)
    sd = convert_hf_gpt2_state_dict(hf.state_dict(), cfg)
    bare = convert_hf_gpt2_state_dict(
        {k.removeprefix("transformer."): v
         for k, v in hf.state_dict().items()}, cfg)
    tree = jax_convert.convert_hf_gpt2_state_dict(
        hf.state_dict(), jax_convert.gpt2_config_from_hf(hf.config))
    leaves = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    assert len(leaves) == len(sd) == len(bare)
    for path, leaf in leaves:
        keys = [k.key for k in path]
        name = ".".join(keys).replace("h_", "h.")
        name = (name.replace(".kernel", ".weight").replace(".scale", ".weight")
                .replace("wte", "wte.weight").replace("wpe", "wpe.weight"))
        want = np.asarray(leaf).T if keys[-1] == "kernel" else np.asarray(leaf)
        assert sd[name].dtype == torch.float32
        np.testing.assert_array_equal(sd[name].numpy(), want, err_msg=name)
        assert torch.equal(bare[name], sd[name])


def test_load_hf_gpt2_defaults():
    hf = _hf_gpt2()
    cfg, model = load_hf_gpt2(hf, device="cpu")
    jcfg, _ = jax_convert.load_hf_gpt2(hf)
    assert (cfg.vocab_size, cfg.n_layer, cfg.n_head, cfg.n_embd,
            cfg.max_position_embeddings, cfg.layer_norm_epsilon) == (
        jcfg.vocab_size, jcfg.n_layer, jcfg.n_head, jcfg.n_embd,
        jcfg.max_position_embeddings, jcfg.layer_norm_epsilon)
    assert cfg.dtype == torch.bfloat16
    assert model.h[1].attn.Wqkv.weight.shape == (384, 128)
    assert torch.equal(model.wte.weight,
                       hf.state_dict()["transformer.wte.weight"])
    _, again = load_hf_gpt2(hf.state_dict(), cfg, device="cpu")
    for (name, a), b in zip(model.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(a, b), name


def test_gpt2_state_dict_requires_cfg_and_every_layer():
    hf = _hf_gpt2()
    with pytest.raises(ValueError, match="explicit GPT2Config"):
        load_hf_gpt2(hf.state_dict())
    cfg = gpt2_config_from_hf(hf.config)
    partial = {k: v for k, v in hf.state_dict().items()
               if not k.startswith("transformer.h.1.")}
    with pytest.raises(ValueError, match="no layer 1"):
        convert_hf_gpt2_state_dict(partial, cfg)
    with pytest.raises(ValueError, match="is this a GPT-2"):
        convert_hf_gpt2_state_dict({"x": torch.zeros(1)}, cfg)


def test_llama_logits_match_transformers_and_jax():
    hf = _hf_llama()
    cfg = llama_config_from_hf(hf.config, dtype=torch.float32)
    model = LlamaForCausalLM(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    model.load_state_dict(convert_hf_llama_state_dict(hf.state_dict(), cfg))
    ids = _ids(cfg.vocab_size, seed=5)
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).logits.numpy()
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)
    jcfg = jax_llama.llama_config_from_hf(hf.config, dtype=jnp.float32)
    params = jax_llama.convert_hf_llama_state_dict(hf.state_dict(), jcfg)
    want_j = jax_llama.LlamaForCausalLM(jcfg).apply(
        params, jnp.asarray(ids, jnp.int32))
    np.testing.assert_allclose(got, np.asarray(want_j), atol=1e-4, rtol=1e-4)


def test_load_hf_llama_and_tied_head():
    """``load_hf_llama`` keeps JAX's config and stores the weights in
    ``dtype``; without ``lm_head.weight`` the head is the embedding."""
    hf = _hf_llama(tie=True)
    assert "lm_head.weight" not in hf.state_dict() or torch.equal(
        hf.state_dict()["lm_head.weight"],
        hf.state_dict()["model.embed_tokens.weight"])
    cfg, model = load_hf_llama(hf, device="cpu")
    jcfg, _ = jax_llama.load_hf_llama(hf)
    for f in dataclasses.fields(jcfg):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32
    emb = hf.state_dict()["model.embed_tokens.weight"]
    assert torch.equal(model.lm_head.weight, emb)
    sd = {k: v for k, v in hf.state_dict().items() if k != "lm_head.weight"}
    assert torch.equal(convert_hf_llama_state_dict(sd, cfg)["lm_head.weight"],
                       emb)
    _, half = load_hf_llama(hf, dtype=torch.bfloat16, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in half.parameters())
    assert half.config.param_dtype == torch.bfloat16


def test_llama_missing_layer_and_mistral_window():
    hf = _hf_llama()
    cfg = llama_config_from_hf(hf.config)
    partial = {k: v for k, v in hf.state_dict().items()
               if not k.startswith("model.layers.1.")}
    with pytest.raises(KeyError, match="model.layers.1"):
        convert_hf_llama_state_dict(partial, cfg)
    mistral = transformers.MistralConfig(
        vocab_size=512, hidden_size=128, intermediate_size=352,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        sliding_window=64)
    mcfg = llama_config_from_hf(mistral)
    jcfg = jax_llama.llama_config_from_hf(mistral)
    assert mcfg.window == jcfg.window == 64
    # The Mistral model runs: its forward, the band biting at s = 96 > 64,
    # against JAX's on the same weights (fp32, atol = rtol = 1e-4).
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    jmodel = jax_llama.LlamaForCausalLM(jcfg)
    ids = np.random.default_rng(3).integers(0, 512, (2, 96))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids, jnp.int32))
    model = llama_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params),
        dataclasses.replace(mcfg, dtype=torch.float32), device="cpu")
    want = jmodel.apply(params, jnp.asarray(ids, jnp.int32))
    got = model(torch.from_numpy(ids)).detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
