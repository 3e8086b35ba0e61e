"""Sliding-window models of the port against the JAX package: Llama
(Mistral's form) and GPT-2 with ``window`` in training and in every
serving phase, ``window_sinks`` in decode, and the serving engine's
streaming page release.

One flax init of each tiny config (``window`` 16, ``window_sinks`` 4, fp32)
is converted into the port's model, so both sides hold the same weights.
The full forward and its gradients, prefill, chunked prefill and
teacher-forced decode (the band and the sinks biting: prompts of 40-56
tokens) must agree with JAX's at atol = rtol = 1e-4 (two 128-wide fp32
layers summed in different orders, as tests/test_torch_llama_serving.py).
The engines run the same requests: greedy tokens exactly equal, and with
``stream_free_pages`` the page tables equal JAX's after every step (the
same pages freed, the freed slots holding page 0), while the tokens equal
those of the run without the release. The kernels themselves are tested
on the card in test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models import gpt2 as jax_gpt2
from flash_attn_tpu.models import gpt2_decode as jax_gpt2_decode
from flash_attn_tpu.models import llama_decode as jax_llama_decode
from flash_attn_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from flash_attn_tpu.models.gpt2 import GPT2LMHeadModel as JaxGPT2
from flash_attn_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from flash_attn_tpu.models.llama import LlamaForCausalLM as JaxLlama
from flash_attn_tpu.serving import cache as jax_cache
from flash_attn_tpu.serving.engine import ServingEngine as JaxEngine
from flash_attn_tpu_torch.models import gpt2_decode, llama_decode
from flash_attn_tpu_torch.models.convert import (
    gpt2_from_jax_params,
    llama_from_jax_params,
)
from flash_attn_tpu_torch.models.gpt2 import (
    GPT2Config,
    GPT2LMHeadModel,
    cross_entropy_loss,
)
from flash_attn_tpu_torch.models.llama import LlamaConfig
from flash_attn_tpu_torch.serving import cache as torch_cache
from flash_attn_tpu_torch.serving.engine import ServingEngine
from flash_attn_tpu_torch.serving.speculative import speculative_decode

ATOL = RTOL = 1e-4
WINDOW, SINKS, PS = 16, 4, 16


def _llama():
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, window=WINDOW,
                               window_sinks=SINKS)
    cfg = LlamaConfig.tiny(window=WINDOW, window_sinks=SINKS)
    return (jcfg, JaxLlama(jcfg), cfg, llama_from_jax_params,
            jax_llama_decode, llama_decode)


def _gpt2():
    jcfg = JaxGPT2Config.tiny(dtype=jnp.float32, window=WINDOW,
                              window_sinks=SINKS)
    cfg = GPT2Config.tiny(dtype=torch.float32, window=WINDOW,
                          window_sinks=SINKS)
    return (jcfg, JaxGPT2(jcfg), cfg, gpt2_from_jax_params,
            jax_gpt2_decode, gpt2_decode)


@pytest.fixture(scope="module", params=["llama", "gpt2"])
def setup(request):
    jcfg, jmodel, cfg, convert, jfns, tfns = {"llama": _llama,
                                              "gpt2": _gpt2}[request.param]()
    ids = jnp.asarray(np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (1, 64)), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(0), ids)
    model = convert(jax.tree_util.tree_map(np.asarray, params), cfg,
                    device="cpu")
    return jcfg, jmodel, params, cfg, model, jfns, tfns


# Per family: the flax path and the port's name of the first layer's
# attention input projection.
QKV_WEIGHT = {"llama": (("layers_0", "attn", "q_proj", "kernel"),
                        "layers.0.attn.q_proj.weight"),
              "gpt2": (("h_0", "attn", "Wqkv", "kernel"),
                       "h.0.attn.Wqkv.weight")}


def test_training_loss_and_grads_match_jax(setup, request):
    """The training forward under the band: logits, the cross-entropy
    loss and the gradient of the first layer's attention projection
    against JAX's."""
    jcfg, jmodel, params, cfg, model, _, _ = setup
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (2, 48))
    jids = jnp.asarray(ids, jnp.int32)

    def loss_fn(p):
        return jax_gpt2.cross_entropy_loss(jmodel.apply(p, jids), jids)

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params)
    model.zero_grad()
    logits = model(torch.from_numpy(ids))
    loss = cross_entropy_loss(logits, torch.from_numpy(ids))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jmodel.apply(params, jids)),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=ATOL,
                               rtol=RTOL)
    path, name = QKV_WEIGHT[request.node.callspec.params["setup"]]
    want = grads_j["params"]
    for key in path:
        want = want[key]
    got = dict(model.named_parameters())[name].grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want).T, atol=ATOL,
                               rtol=RTOL)


def test_prefill_matches_jax(setup):
    jcfg, _, params, cfg, model, jfns, tfns = setup
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 48))
    lens = np.asarray([48, 9, 40], np.int32)
    lj, ksj, vsj = jfns.prefill(params, jcfg, jnp.asarray(ids, jnp.int32),
                                jnp.asarray(lens))
    lt, kst, vst = tfns.prefill(model, cfg, torch.from_numpy(ids),
                                torch.from_numpy(lens))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                               rtol=RTOL)
    for a, b in zip(kst + vst, ksj + vsj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)


def _caches(cfg, num_pages):
    jc = [jax_cache.init_cache(cfg.n_kv_heads, num_pages, PS, cfg.head_dim,
                               dtype=jnp.float32) for _ in range(cfg.n_layer)]
    tc = [torch_cache.init_cache(cfg.n_kv_heads, num_pages, PS, cfg.head_dim,
                                 dtype=torch.float32, device="cpu")
          for _ in range(cfg.n_layer)]
    return jc, tc


def test_chunked_prefill_and_sink_decode_match_jax(setup):
    """Two 32-token chunks of a 56- and a 20-token prompt (the band from
    each chunk's first row), then 6 decode steps with the band plus 4
    sinks: logits equal JAX's at every chunk end and step, and so do the
    written caches."""
    jcfg, _, params, cfg, model, jfns, tfns = setup
    rng = np.random.default_rng(4)
    lens, C = [56, 20], 32
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    table = np.asarray([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 0, 0]], np.int32)
    jc, tc = _caches(cfg, 12)
    jchunk = jax.jit(lambda c, *a: jfns.chunk_prefill_step(params, jcfg, c,
                                                           *a))
    jstep = jax.jit(lambda c, *a: jfns.decode_step(params, jcfg, c, *a))
    for off in (0, C):
        ids = np.zeros((2, C), np.int64)
        pos0 = np.asarray([min(n, off) for n in lens], np.int32)
        cl = np.asarray([max(0, min(n - off, C)) for n in lens], np.int32)
        wtbl = np.zeros((2, C // PS), np.int32)
        for i, n in enumerate(lens):
            if cl[i]:
                ids[i, : cl[i]] = prompts[i][off: off + cl[i]]
                wtbl[i] = table[i, off // PS: off // PS + C // PS]
        lj, jc = jchunk(jc, jnp.asarray(ids, jnp.int32), jnp.asarray(pos0),
                        jnp.asarray(cl), jnp.asarray(wtbl),
                        jnp.asarray(table))
        lt, tc = tfns.chunk_prefill_step(
            model, cfg, tc, torch.from_numpy(ids), torch.from_numpy(pos0),
            torch.from_numpy(cl), torch.from_numpy(wtbl),
            torch.from_numpy(table))
        for i, n in enumerate(lens):
            if off < n <= off + C:
                np.testing.assert_allclose(lt[i].numpy(), np.asarray(lj[i]),
                                           atol=ATOL, rtol=RTOL)
    lengths = np.asarray(lens, np.int32)
    for t in range(6):
        tok = rng.integers(0, cfg.vocab_size, 2)
        lj, jc = jstep(jc, jnp.asarray(table), jnp.asarray(lengths),
                       jnp.asarray(tok, jnp.int32))
        lt, tc = tfns.decode_step(model, cfg, tc, torch.from_numpy(table),
                                  torch.from_numpy(lengths),
                                  torch.from_numpy(tok))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   rtol=RTOL, err_msg=f"step {t}")
        lengths = lengths + 1
    for j, t in zip(jc, tc):
        for a, b in ((j.k_pages, t.k_pages), (j.v_pages, t.v_pages)):
            np.testing.assert_allclose(b.numpy()[:, 1:], np.asarray(a)[:, 1:],
                                       atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("prefill_chunk", [None, 16])
def test_engine_streaming_release_matches_jax(setup, prefill_chunk):
    """Three requests on two slots, prompts past the window: with
    stream_free_pages the page tables equal the JAX engine's after every
    step (the same pages freed mid-flight), the greedy tokens equal JAX's
    and those of the port's run without the release, which frees
    nothing."""
    jcfg, _, params, cfg, model, jfns, tfns = setup
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (50, 37, 20)]
    kw = dict(max_batch=2, num_pages=20, page_size=PS, pages_per_seq=6,
              prefill_chunk=prefill_chunk)
    jeng = JaxEngine(params, jcfg, model_fns=jfns, **kw)
    teng = ServingEngine(model, cfg, model_fns=tfns, **kw)
    plain = ServingEngine(model, cfg, model_fns=tfns,
                          stream_free_pages=False, **kw)
    for eng in (jeng, teng, plain):
        for p in prompts:
            eng.submit(p, max_new_tokens=14)
    steps = 0
    while jeng.has_work():
        for eng in (jeng, teng, plain):
            eng.step()
        np.testing.assert_array_equal(teng.page_table, jeng.page_table,
                                      err_msg=f"step {steps}")
        steps += 1
        assert steps < 200
    assert not teng.has_work() and not plain.has_work()
    outs = [{r.seq_id: r.generated for r in eng.finished}
            for eng in (jeng, teng, plain)]
    assert outs[1] == outs[0] == outs[2]
    assert all(len(g) == 14 for g in outs[1].values())
    assert teng.pages_freed > 0 and plain.pages_freed == 0
    assert teng.peak_pages <= plain.peak_pages


def test_windowed_speculative_decode_matches_greedy():
    """Speculative decoding of a windowed GPT-2 (no sinks) whose prompt is
    longer than the window: the chunk scoring attends through the band, so
    the tokens equal greedy decoding by the windowed full forward. With
    window_sinks (decode-only) it refuses."""
    cfg = GPT2Config.tiny(dtype=torch.float32, window=WINDOW)
    model = GPT2LMHeadModel(cfg, generator=torch.Generator().manual_seed(3),
                            device="cpu")
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                               40).tolist()
    new = 10
    generated, _ = speculative_decode(model, cfg, prompt, new, k=4,
                                      page_size=PS)
    ids = torch.tensor([prompt])
    with torch.no_grad():
        for _ in range(new):
            nxt = model(ids)[0, -1].argmax()
            ids = torch.cat([ids, nxt.reshape(1, 1)], dim=1)
    assert generated == ids[0, len(prompt):].tolist()
    sinks = GPT2Config.tiny(dtype=torch.float32, window=WINDOW,
                            window_sinks=SINKS)
    with pytest.raises(ValueError, match="decode-only"):
        speculative_decode(model, sinks, prompt, new, page_size=PS)
