"""The CUDA-graph wrapper of the port's Llama serving phases
(``models/llama_decode.py``), on the CPU: CPU inputs take the eager body
and leave no graph state; the signature tells shapes, dtypes, ``cfg`` and
cache storage apart; a replay copies its inputs, grows the launch
counters by its capture's amounts and returns the static output; every
launch counter in the package is registered, so a replay grows it. The
graphs themselves run on the card (``tests/test_torch_kernels.py``)."""

import importlib
import pkgutil

import numpy as np
import pytest
import torch

import flash_attn_tpu_torch
from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.models import llama_decode
from flash_attn_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from flash_attn_tpu_torch.serving import cache as torch_cache
from flash_attn_tpu_torch.serving.engine import ServingEngine

PS, PMAX = 16, 4


@pytest.fixture(scope="module")
def model():
    cfg = LlamaConfig.tiny(window=24)
    return cfg, LlamaForCausalLM(cfg, generator=torch.Generator().manual_seed(0),
                                 device="cpu")


def caches(cfg, rows, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    shape = (cfg.n_kv_head, 1 + rows * PMAX, PS, cfg.head_dim)
    return [torch_cache.PagedKVCache(torch.randn(shape, generator=g,
                                                 dtype=dtype),
                                     torch.randn(shape, generator=g,
                                                 dtype=dtype))
            for _ in range(cfg.n_layer)]


def clone(cs):
    return [torch_cache.PagedKVCache(c.k_pages.clone(), c.v_pages.clone())
            for c in cs]


def int32(xs):
    return torch.tensor(xs, dtype=torch.int32)


def chunk_args(rows, width=16, seed=1):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy((1 + rng.permutation(rows * PMAX)).reshape(
        rows, PMAX).astype(np.int32))
    pos0 = int32([16] * rows)
    cl = int32(rng.integers(1, width + 1, rows).tolist())
    wtbl = table[:, 1:1 + width // PS].contiguous()
    return (torch.from_numpy(rng.integers(0, 512, (rows, width))), pos0, cl,
            wtbl, table)


def decode_args(rows, seed=2):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy((1 + rng.permutation(rows * PMAX)).reshape(
        rows, PMAX).astype(np.int32))
    lens = rng.integers(1, PMAX * PS - 1, rows)
    lens[-1] = -1
    return table, int32(lens.tolist()), torch.from_numpy(
        rng.integers(0, 512, rows))


@pytest.fixture
def no_graphs(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU call made graph state")

    monkeypatch.setattr(llama_decode, "_Graphs", refuse)


@pytest.mark.parametrize("phase", ["chunk_prefill_step", "decode_step"])
def test_cpu_call_is_the_eager_body(model, no_graphs, phase):
    """On the CPU each phase returns its eager body's logits, writes the
    same pages and makes no graph state on the model."""
    cfg, m = model
    if phase == "decode_step":
        args, body = decode_args(4), llama_decode._decode_body
    else:
        args, body = chunk_args(4), llama_decode._chunk_body
    mine = caches(cfg, 4)
    theirs = clone(mine)
    logits, out = getattr(llama_decode, phase)(m, cfg, mine, *args)
    want = body(m, cfg, theirs, *args)
    assert out is mine
    assert torch.equal(logits, want)
    for a, b in zip(mine, theirs):
        assert torch.equal(a.k_pages, b.k_pages)
        assert torch.equal(a.v_pages, b.v_pages)
    assert m not in llama_decode._GRAPHS


def test_cpu_engine_makes_no_graph_state(model, no_graphs):
    cfg, m = model
    eng = ServingEngine(m, cfg, model_fns=llama_decode, max_batch=2,
                        num_pages=16, page_size=PS, pages_per_seq=PMAX,
                        prefill_chunk=16)
    for n in (9, 40):
        eng.submit(list(range(1, n + 1)), max_new_tokens=3)
    assert len(eng.run(max_steps=20)) == 2
    assert m not in llama_decode._GRAPHS


def _changed(case, cfg, cs, args):
    """(cfg, caches, args) of a call that differs from the given one in
    ``case``."""
    if case == "rows":
        return cfg, caches(cfg, 2), chunk_args(2)
    if case == "width":
        return cfg, cs, chunk_args(4, width=32)
    if case == "id dtype":
        return cfg, cs, (args[0].int(), *args[1:])
    if case == "cache dtype":
        return cfg, caches(cfg, 4, dtype=torch.bfloat16), args
    if case == "cache storage":
        return cfg, caches(cfg, 4), args
    if case == "one layer's storage":
        other = list(cs)
        other[1] = torch_cache.PagedKVCache(cs[1].k_pages.clone(),
                                            cs[1].v_pages)
        return cfg, other, args
    if case == "cfg":
        return LlamaConfig.tiny(window=None), cs, args
    raise KeyError(case)


CASES = ["rows", "width", "id dtype", "cache dtype", "cache storage",
         "one layer's storage", "cfg"]


@pytest.mark.parametrize("case", CASES)
def test_signature_tells_calls_apart(model, case):
    cfg, _ = model
    cs, args = caches(cfg, 4), chunk_args(4)
    storage, sig = llama_decode._signature("chunk_prefill_step", cfg, cs,
                                           args)
    other = llama_decode._signature("chunk_prefill_step",
                                    *_changed(case, cfg, cs, args))
    assert other != (storage, sig)
    if case in ("cache dtype", "cache storage", "one layer's storage"):
        assert other[0] != storage
    else:
        assert other[1] != sig


def test_signature_is_the_same_for_new_values_of_one_shape(model):
    """New argument tensors of the same shapes and dtypes over the same
    caches replay the same graph; the phase tells decode from chunk."""
    cfg, _ = model
    cs = caches(cfg, 4)
    a = llama_decode._signature("chunk_prefill_step", cfg, cs,
                                chunk_args(4, seed=1))
    b = llama_decode._signature("chunk_prefill_step", cfg, cs,
                                chunk_args(4, seed=9))
    assert a == b
    d = llama_decode._signature("decode_step", cfg, cs, decode_args(4))
    assert d[0] == a[0] and d[1] != a[1]


def test_replay_copies_inputs_and_grows_the_counters(monkeypatch):
    """A replay copies each argument into its static input, replays, adds
    its capture's growth to each launch counter and returns the static
    output."""
    seen = []
    inputs = [torch.zeros(3, dtype=torch.int32), torch.zeros(2, 2)]
    out = torch.full((2, 5), 7.0)

    class Stub:
        def replay(self):
            seen.append([t.clone() for t in inputs])

    before = llama_decode._counts()
    grown = [2 + i % 3 for i in range(len(_build.COUNTERS))]
    g = llama_decode._Graph(Stub(), inputs, out, grown)
    try:
        args = (int32([1, 2, 3]), torch.ones(2, 2))
        assert g.replay(args) is out
        assert torch.equal(seen[0][0], args[0])
        assert torch.equal(seen[0][1], args[1])
        g.replay(args)
        assert llama_decode._counts() == [b + 2 * n
                                          for b, n in zip(before, grown)]
    finally:
        for (f, name), n in zip(_build.COUNTERS, before):
            setattr(f, name, n)


def test_every_launch_counter_is_registered():
    """Every function in the package with a ``launches`` or
    ``append_launches`` attribute has it in ``_build.COUNTERS``, which a
    replay grows: a kernel wrapper cannot be left out of replays."""
    found = set()
    for info in pkgutil.walk_packages(flash_attn_tpu_torch.__path__,
                                      "flash_attn_tpu_torch."):
        module = importlib.import_module(info.name)
        for fn in vars(module).values():
            if callable(fn):
                found.update((fn, attr)
                             for attr in ("launches", "append_launches")
                             if hasattr(fn, attr))
    registered = set(_build.COUNTERS)
    assert len(found) >= 17
    assert found <= registered, sorted(
        f"{fn.__qualname__}.{attr}" for fn, attr in found - registered)


def test_weight_addresses_see_moved_and_new_parameters():
    """The graphs' key on the weights: new data under a parameter, or a
    new parameter in a module, changes it; an update in place does not."""
    cfg = LlamaConfig.tiny()
    m = LlamaForCausalLM(cfg, generator=torch.Generator().manual_seed(1),
                         device="cpu")
    slots = llama_decode._weight_slots(m)
    assert len(slots) == len(list(m.parameters()))
    w0 = llama_decode._weights(slots)
    with torch.no_grad():
        m.layers[0].attn.q_proj.weight.mul_(2.0)
    assert llama_decode._weights(slots) == w0
    m.layers[1].mlp.up_proj.weight.data = \
        m.layers[1].mlp.up_proj.weight.data.clone()
    w1 = llama_decode._weights(slots)
    assert w1 != w0
    m.norm.weight = torch.nn.Parameter(torch.ones(cfg.n_embd))
    assert llama_decode._weights(slots) != w1
