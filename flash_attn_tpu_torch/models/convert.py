"""Load a flax GPT-2 parameter tree into the port's ``GPT2LMHeadModel``.

The tree comes in as numpy arrays (the caller runs
``jax.tree_util.tree_map(np.asarray, params)``), so this module imports no
JAX. Flax ``Dense.kernel`` is (in, out) and ``nn.Linear.weight`` is
(out, in): kernels are transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from flash_attn_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel


def gpt2_from_jax_params(params, cfg: GPT2Config, device="cuda"
                         ) -> GPT2LMHeadModel:
    """``params``: the flax tree ``{"params": {...}}`` (or its inner dict)
    of ``flash_attn_tpu.models.gpt2.GPT2LMHeadModel`` as numpy arrays.
    Returns the port's model on ``device`` with its parameters stored in
    ``cfg.param_dtype`` (fp32 by default, as the flax tree holds them);
    ``cfg`` also carries ``dropout`` and ``remat`` for training."""
    p = params.get("params", params)
    # Every parameter is overwritten below; the seed only fills the module.
    model = GPT2LMHeadModel(cfg, device=device,
                            generator=torch.Generator().manual_seed(0))

    def put(dst: torch.Tensor, src, transpose=False):
        src = np.array(src)  # a writable copy
        if transpose:
            src = src.T
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape {src.shape} for a {tuple(dst.shape)} "
                             "parameter")
        dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))

    def dense(lin, tree):
        put(lin.weight, tree["kernel"], transpose=True)
        put(lin.bias, tree["bias"])

    def norm(ln, tree):
        put(ln.weight, tree["scale"])
        put(ln.bias, tree["bias"])

    with torch.no_grad():
        put(model.wte.weight, p["wte"])
        put(model.wpe.weight, p["wpe"])
        for i, block in enumerate(model.h):
            tree = p[f"h_{i}"]
            norm(block.ln_1, tree["ln_1"])
            norm(block.ln_2, tree["ln_2"])
            dense(block.attn.Wqkv, tree["attn"]["Wqkv"])
            dense(block.attn.out_proj, tree["attn"]["out_proj"])
            dense(block.mlp.c_fc, tree["mlp"]["c_fc"])
            dense(block.mlp.c_proj, tree["mlp"]["c_proj"])
        norm(model.ln_f, p["ln_f"])
    return model
