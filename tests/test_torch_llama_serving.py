"""The port's Llama serving slice against the JAX package, end to end.

One flax init of ``LlamaConfig.tiny(dtype=float32)`` (GQA group 2,
head_dim 32) is converted into the port's model; the full forward,
prefill, teacher-forced decode, chunked prefill and the engine's greedy
tokens (single-shot and chunked) must then agree with the JAX package's.
Both sides run fp32 here (the JAX package promotes its bf16 activations
times fp32 kernels to fp32; see the port's models/llama_decode.py), so
logits and cached keys are compared with atol = rtol = 1e-4: two layers of
128-wide fp32 sums and fp32 rotary in different orders, observed gap ~1e-6.
Caches are compared outside the scratch page 0, which padding rows write.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models import llama_decode as jax_decode
from flash_attn_tpu.models.llama import LlamaConfig as JaxConfig
from flash_attn_tpu.models.llama import LlamaForCausalLM as JaxModel
from flash_attn_tpu.serving import cache as jax_cache
from flash_attn_tpu.serving.engine import ServingEngine as JaxEngine
from flash_attn_tpu_torch.models import llama_decode
from flash_attn_tpu_torch.models.convert import llama_from_jax_params
from flash_attn_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from flash_attn_tpu_torch.serving import cache as torch_cache
from flash_attn_tpu_torch.serving.engine import ServingEngine

ATOL = RTOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig.tiny(dtype=jnp.float32)
    jmodel = JaxModel(jcfg)
    ids = jnp.asarray(np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (1, 64)), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(0), ids)
    cfg = LlamaConfig.tiny()
    model = llama_from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                  cfg, device="cpu")
    return jcfg, jmodel, params, cfg, model


def test_convert_round_trip(setup):
    """Every flax leaf lands in the matching port tensor (kernels
    transposed), and the full forwards agree."""
    jcfg, jmodel, params, cfg, model = setup
    sd = model.state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    assert len(leaves) == len(sd)
    for path, leaf in leaves:
        keys = [k.key for k in path]
        name = ".".join(keys).replace("layers_", "layers.")
        name = name.replace(".kernel", ".weight").replace(".scale", ".weight")
        if name in ("wte", "lm_head"):
            name += ".weight"
        want = np.asarray(leaf).T if keys[-1] == "kernel" else np.asarray(leaf)
        np.testing.assert_array_equal(sd[name].numpy(), want, err_msg=name)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    want = jmodel.apply(params, jnp.asarray(ids, jnp.int32))
    got = model(torch.from_numpy(ids)).detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_model_defaults_and_unported_options():
    """Defaults; ``window`` and ``window_sinks`` build a model whose full
    forward matches JAX's (the band bites at s = 40 > 16; sinks are
    decode-only, so the forward stays the band)."""
    cfg = LlamaConfig.tiny()
    assert cfg.head_dim == 32 and cfg.n_kv_heads == 2
    assert LlamaConfig().dtype == torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    model = LlamaForCausalLM(cfg, generator=gen, device="cpu")
    assert torch.equal(model.norm.weight, torch.ones(cfg.n_embd))
    assert abs(float(model.lm_head.weight.detach().std()) - 0.02) < 2e-3
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    for kw in ({"window": 16}, {"window": 16, "window_sinks": 4}):
        jcfg = JaxConfig.tiny(dtype=jnp.float32, **kw)
        jmodel = JaxModel(jcfg)
        params = jmodel.init(jax.random.PRNGKey(0),
                             jnp.asarray(ids, jnp.int32))
        model = llama_from_jax_params(
            jax.tree_util.tree_map(np.asarray, params),
            LlamaConfig.tiny(**kw), device="cpu")
        want = jmodel.apply(params, jnp.asarray(ids, jnp.int32))
        got = model(torch.from_numpy(ids)).detach()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL, err_msg=str(kw))


def test_prefill_matches_jax(setup):
    jcfg, _, params, cfg, model = setup
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 48))
    lens = np.asarray([48, 9, 30, 1], np.int32)
    lj, ksj, vsj = jax_decode.prefill(params, jcfg, jnp.asarray(ids, jnp.int32),
                                      jnp.asarray(lens))
    lt, kst, vst = llama_decode.prefill(model, cfg, torch.from_numpy(ids),
                                        torch.from_numpy(lens))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                               rtol=RTOL)
    for a, b in zip(kst + vst, ksj + vsj):
        assert a.shape == (4, 48, cfg.n_kv_head, cfg.head_dim)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)


def _caches(n_layer, num_pages, ps, cfg):
    jc = [jax_cache.init_cache(cfg.n_kv_head, num_pages, ps, cfg.head_dim,
                               dtype=jnp.float32) for _ in range(n_layer)]
    tc = [torch_cache.init_cache(cfg.n_kv_head, num_pages, ps, cfg.head_dim,
                                 dtype=torch.float32, device="cpu")
          for _ in range(n_layer)]
    return jc, tc


def test_teacher_forced_decode_matches_jax(setup):
    """prefill + 8 decode steps: logits equal JAX's decode_step at every
    step, and the port's own full forward (teacher forcing)."""
    jcfg, _, params, cfg, model = setup
    rng = np.random.default_rng(3)
    prompt_len, n_decode, ps = 40, 8, 16
    ids = rng.integers(0, cfg.vocab_size, (1, prompt_len + n_decode))
    full = model(torch.from_numpy(ids))
    table = np.asarray([[3, 1, 4, 0]], np.int32)
    jc, tc = _caches(cfg.n_layer, 6, ps, cfg)
    _, ksj, vsj = jax_decode.prefill(params, jcfg,
                                     jnp.asarray(ids[:, :prompt_len]))
    _, kst, vst = llama_decode.prefill(model, cfg,
                                       torch.from_numpy(ids[:, :prompt_len]))
    for li in range(cfg.n_layer):
        jc[li] = jax_cache.write_prompt(jc[li], ksj[li][0], vsj[li][0],
                                        jnp.asarray(table[0, :3]))
        torch_cache.write_prompt(tc[li], kst[li][0], vst[li][0],
                                 torch.from_numpy(table[0, :3]))
    jax_step = jax.jit(lambda p, c, tb, ln, tk: jax_decode.decode_step(
        p, jcfg, c, tb, ln, tk))
    for t in range(n_decode):
        lens = np.asarray([prompt_len + t], np.int32)
        tok = ids[:, prompt_len + t]
        lj, jc = jax_step(params, jc, jnp.asarray(table), jnp.asarray(lens),
                          jnp.asarray(tok, jnp.int32))
        lt, tc = llama_decode.decode_step(model, cfg, tc,
                                          torch.from_numpy(table),
                                          torch.from_numpy(lens),
                                          torch.from_numpy(tok))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   rtol=RTOL, err_msg=f"step {t}")
        torch.testing.assert_close(lt, full[:, prompt_len + t], atol=ATOL,
                                   rtol=RTOL)


def test_chunk_prefill_step_matches_jax(setup):
    """Two 32-token chunks of a 40- and a 20-token prompt, plus a padding
    row: logits where each prompt ends and the written caches equal
    JAX's, and the logits equal the port's full forward."""
    jcfg, _, params, cfg, model = setup
    rng = np.random.default_rng(4)
    lens, C, ps = [40, 20, 0], 32, 16
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    table = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    jc, tc = _caches(cfg.n_layer, 8, ps, cfg)
    for off in (0, C):
        ids = np.zeros((3, C), np.int64)
        pos0 = np.asarray([min(n, off) for n in lens], np.int32)
        cl = np.asarray([max(0, min(n - off, C)) for n in lens], np.int32)
        wtbl = np.zeros((3, C // ps), np.int32)
        for i, n in enumerate(lens):
            if cl[i]:
                ids[i, : cl[i]] = prompts[i][off: off + cl[i]]
                span = table[i, off // ps: off // ps + C // ps]
                wtbl[i, : len(span)] = span
        lj, jc = jax_decode.chunk_prefill_step(
            params, jcfg, jc, jnp.asarray(ids, jnp.int32), jnp.asarray(pos0),
            jnp.asarray(cl), jnp.asarray(wtbl), jnp.asarray(table))
        lt, tc = llama_decode.chunk_prefill_step(
            model, cfg, tc, torch.from_numpy(ids), torch.from_numpy(pos0),
            torch.from_numpy(cl), torch.from_numpy(wtbl),
            torch.from_numpy(table))
        for i, n in enumerate(lens):
            if off < n <= off + C:
                np.testing.assert_allclose(lt[i].numpy(), np.asarray(lj[i]),
                                           atol=ATOL, rtol=RTOL)
                full = model(torch.from_numpy(prompts[i][None]))
                torch.testing.assert_close(lt[i], full[0, -1], atol=ATOL,
                                           rtol=RTOL)
    for j, t in zip(jc, tc):
        for a, b in ((j.k_pages, t.k_pages), (j.v_pages, t.v_pages)):
            np.testing.assert_allclose(b.numpy()[:, 1:], np.asarray(a)[:, 1:],
                                       atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("prefill_chunk", [None, 16])
def test_engine_greedy_tokens_match_jax(setup, prefill_chunk):
    """The engine through ``model_fns=llama_decode``, single-shot and
    chunked: three requests on two slots (mid-flight admission), the
    same greedy tokens as the JAX engine."""
    jcfg, _, params, cfg, model = setup
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (9, 25, 17)]
    kw = dict(max_batch=2, num_pages=16, page_size=16, pages_per_seq=3,
              prefill_chunk=prefill_chunk)
    outs = []
    for eng in (JaxEngine(params, jcfg, model_fns=jax_decode, **kw),
                ServingEngine(model, cfg, model_fns=llama_decode, **kw)):
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        done = eng.run(max_steps=200)
        assert len(done) == len(prompts)
        outs.append({r.seq_id: r.generated for r in done})
    assert outs[1] == outs[0]
    assert all(len(g) == 6 for g in outs[1].values())
