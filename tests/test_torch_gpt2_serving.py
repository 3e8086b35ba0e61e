"""The port's GPT-2 serving slice against the JAX package, end to end.

One flax init of ``GPT2Config.tiny(dtype=float32)`` is converted into the
port's model; prefill, teacher-forced decode, chunked prefill and the
engine's greedy tokens (single-shot and chunked) must then agree with the
JAX package's. Caches are compared outside the scratch page 0, which
padding rows write. Both sides run fp32 here (the JAX
package computes its projections in fp32 whatever ``cfg.dtype`` says; see
the port's models/gpt2_decode.py), so logits are compared with atol = rtol
= 1e-4: two layers of 128-wide fp32 sums in different orders, observed gap
~1e-6.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models import gpt2_decode as jax_decode
from flash_attn_tpu.models.gpt2 import GPT2Config as JaxConfig
from flash_attn_tpu.models.gpt2 import GPT2LMHeadModel as JaxModel
from flash_attn_tpu.serving import cache as jax_cache
from flash_attn_tpu.serving.engine import ServingEngine as JaxEngine
from flash_attn_tpu_torch.models import gpt2_decode
from flash_attn_tpu_torch.models.convert import gpt2_from_jax_params
from flash_attn_tpu_torch.models.gpt2 import GPT2Config
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
    cfg = GPT2Config.tiny(dtype=torch.float32)
    model = gpt2_from_jax_params(jax.tree_util.tree_map(np.asarray, params),
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
        name = ".".join(keys).replace("h_", "h.")
        name = (name.replace(".kernel", ".weight").replace(".scale", ".weight")
                .replace("wte", "wte.weight").replace("wpe", "wpe.weight"))
        want = np.asarray(leaf).T if keys[-1] == "kernel" else np.asarray(leaf)
        np.testing.assert_array_equal(sd[name].numpy(), want, err_msg=name)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    want = jmodel.apply(params, jnp.asarray(ids, jnp.int32))
    got = model(torch.from_numpy(ids)).detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_prefill_matches_jax(setup):
    jcfg, _, params, cfg, model = setup
    rng = np.random.default_rng(2)
    ids = rng.integers(0, cfg.vocab_size, (4, 48))
    lens = np.asarray([48, 9, 30, 1], np.int32)
    lj, ksj, vsj = jax_decode.prefill(params, jcfg, jnp.asarray(ids, jnp.int32),
                                      jnp.asarray(lens))
    lt, kst, vst = gpt2_decode.prefill(model, cfg, torch.from_numpy(ids),
                                       torch.from_numpy(lens))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                               rtol=RTOL)
    assert len(kst) == cfg.n_layer
    for a, b in zip(kst + vst, ksj + vsj):
        assert a.shape == (4, 48, cfg.n_head, cfg.head_dim)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)


def test_teacher_forced_decode_matches_jax(setup):
    """prefill + 8 decode steps: logits equal JAX's decode_step at every
    step, and the port's own full forward (teacher forcing)."""
    jcfg, _, params, cfg, model = setup
    rng = np.random.default_rng(3)
    prompt_len, n_decode, ps = 40, 8, 16
    ids = rng.integers(0, cfg.vocab_size, (1, prompt_len + n_decode))
    full = model(torch.from_numpy(ids))
    table = np.asarray([[3, 1, 4, 0]], np.int32)
    jc = [jax_cache.init_cache(cfg.n_head, 6, ps, cfg.head_dim,
                               dtype=jnp.float32) for _ in range(cfg.n_layer)]
    tc = [torch_cache.init_cache(cfg.n_head, 6, ps, cfg.head_dim,
                                 dtype=torch.float32, device="cpu")
          for _ in range(cfg.n_layer)]
    _, ksj, vsj = jax_decode.prefill(params, jcfg,
                                     jnp.asarray(ids[:, :prompt_len]))
    _, kst, vst = gpt2_decode.prefill(model, cfg,
                                      torch.from_numpy(ids[:, :prompt_len]))
    for li in range(cfg.n_layer):
        jc[li] = jax_cache.write_prompt(jc[li], ksj[li][0], vsj[li][0],
                                        jnp.asarray(table[0, :3]))
        torch_cache.write_prompt(tc[li], kst[li][0], vst[li][0],
                                 torch.from_numpy(table[0, :3]))
    # One compile instead of eight interpreted eager steps.
    jax_step = jax.jit(lambda p, c, tb, ln, tk: jax_decode.decode_step(
        p, jcfg, c, tb, ln, tk))
    for t in range(n_decode):
        lens = np.asarray([prompt_len + t], np.int32)
        tok = ids[:, prompt_len + t]
        lj, jc = jax_step(params, jc, jnp.asarray(table), jnp.asarray(lens),
                          jnp.asarray(tok, jnp.int32))
        lt, tc = gpt2_decode.decode_step(model, cfg, tc,
                                         torch.from_numpy(table),
                                         torch.from_numpy(lens),
                                         torch.from_numpy(tok))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   rtol=RTOL, err_msg=f"step {t}")
        torch.testing.assert_close(lt, full[:, prompt_len + t], atol=ATOL,
                                   rtol=RTOL)


def _engine_tokens_match_jax(setup, prompt_lens, new, **kw):
    jcfg, _, params, cfg, model = setup
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in prompt_lens]
    outs = []
    for eng in (JaxEngine(params, jcfg, **kw), ServingEngine(model, cfg, **kw)):
        for p in prompts:
            eng.submit(p, max_new_tokens=new)
        done = eng.run(max_steps=200)
        assert len(done) == len(prompts)
        outs.append({r.seq_id: r.generated for r in done})
    assert outs[1] == outs[0]
    assert all(len(g) == new for g in outs[1].values())


@pytest.mark.parametrize("max_batch,num_pages,page_size,prompt_lens,new", [
    (2, 16, 16, (9, 25, 17), 6),   # 3 requests, 2 slots: mid-flight admission
    (2, 5, 16, (30, 29), 12),      # tight pool: decode growth preempts
])
def test_engine_greedy_tokens_match_jax(setup, max_batch, num_pages,
                                        page_size, prompt_lens, new):
    _engine_tokens_match_jax(setup, prompt_lens, new, max_batch=max_batch,
                             num_pages=num_pages, page_size=page_size,
                             pages_per_seq=3)


@pytest.mark.parametrize("prefill_chunk,prompt_lens", [
    (16, (9, 40, 17)),   # one to three chunks, mid-flight admission
    (32, (30, 29)),      # one chunk each, then preemption re-prefills
])
def test_engine_chunked_prefill_tokens_match_jax(setup, prefill_chunk,
                                                 prompt_lens):
    """``prefill_chunk``: the same greedy tokens as the JAX engine's
    chunked prefill."""
    _engine_tokens_match_jax(setup, prompt_lens, 6, max_batch=2,
                             num_pages=6 if prefill_chunk == 32 else 16,
                             page_size=16, pages_per_seq=3,
                             prefill_chunk=prefill_chunk)


def test_chunk_prefill_step_matches_jax(setup):
    """Two 32-token chunks of a 40- and a 20-token prompt, plus a padding
    row: logits where each prompt ends and the written caches equal JAX's,
    and the logits equal the port's full forward."""
    jcfg, _, params, cfg, model = setup
    rng = np.random.default_rng(5)
    lens, C, ps = [40, 20, 0], 32, 16
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    table = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    jc = [jax_cache.init_cache(cfg.n_head, 8, ps, cfg.head_dim,
                               dtype=jnp.float32) for _ in range(cfg.n_layer)]
    tc = [torch_cache.init_cache(cfg.n_head, 8, ps, cfg.head_dim,
                                 dtype=torch.float32, device="cpu")
          for _ in range(cfg.n_layer)]
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
        lt, tc = gpt2_decode.chunk_prefill_step(
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


def test_engine_rejects_unported_options(setup):
    """``prefill_chunk`` must be a positive multiple of ``page_size`` (as
    in the JAX engine); quantized KV is not ported yet."""
    _, _, _, cfg, model = setup
    for chunk in (100, 0):
        with pytest.raises(ValueError, match="multiple of page_size"):
            ServingEngine(model, cfg, num_pages=8, pages_per_seq=2,
                          prefill_chunk=chunk)
    with pytest.raises(NotImplementedError, match="ROADMAP port item"):
        ServingEngine(model, cfg, num_pages=8, pages_per_seq=2,
                      kv_quantization="int8")


def test_import_does_not_import_jax():
    code = ("import sys, flash_attn_tpu_torch, "
            "flash_attn_tpu_torch.serving.engine, "
            "flash_attn_tpu_torch.serving.kvcache, "
            "flash_attn_tpu_torch.serving.speculative, "
            "flash_attn_tpu_torch.kernels.chunk, "
            "flash_attn_tpu_torch.models.llama_decode, "
            "flash_attn_tpu_torch.models.convert, "
            "flash_attn_tpu_torch.reference, "
            "flash_attn_tpu_torch.utils.testing; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'flash_attn_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parent.parent)
