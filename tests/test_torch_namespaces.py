"""Every public name of the JAX package's namespaces imports from the same
namespace of the port (ROADMAP C11), except the names listed in
``NOT_PORTED``, each with the ROADMAP queue item that brings it; those
must still be missing, so that the list cannot go stale. The port's
``__all__`` lists exactly what it exports, and importing the port pulls
in no JAX.
"""

import importlib
import subprocess
import sys

import pytest

SPACES = ("", ".models", ".ops", ".kernels", ".serving", ".utils")
NOT_PORTED = {
    ("", "BlockSizes"): "not ported by design (TPU tile heuristics)",
    (".kernels", "BlockSizes"): "not ported by design (TPU tile heuristics)",
    (".utils", "TrainCheckpointer"): "M7",
    (".serving", "make_sharded_chunk_attention"): "M6",
    (".serving", "make_sharded_paged_decode"): "M6",
}
NAMES = [(space, name) for space in SPACES
         for name in importlib.import_module(f"flash_attn_tpu{space}").__all__]


@pytest.mark.parametrize("space,name", NAMES,
                         ids=[f"flash_attn_tpu{s}.{n}" for s, n in NAMES])
def test_jax_name_imports_from_the_port(space, name):
    port = importlib.import_module(f"flash_attn_tpu_torch{space}")
    if (space, name) in NOT_PORTED:
        assert not hasattr(port, name), (
            f"{name} is ported now: drop it from NOT_PORTED")
    else:
        assert getattr(port, name) is not None
        assert name in port.__all__


@pytest.mark.parametrize("space", SPACES)
def test_port_all_lists_its_exports(space):
    port = importlib.import_module(f"flash_attn_tpu_torch{space}")
    for name in getattr(port, "__all__", []):
        assert hasattr(port, name), name


def test_not_ported_names_exist_in_jax():
    for space, name in NOT_PORTED:
        assert name in importlib.import_module(
            f"flash_attn_tpu{space}").__all__, (space, name)


def test_port_namespaces_import_no_jax():
    code = ("import sys\n"
            + "".join(f"import flash_attn_tpu_torch{s}\n" for s in SPACES)
            + "import flash_attn_tpu_torch.serving as s\n"
            + "s.ServingEngine\n"
            + "assert not [m for m in sys.modules if m == 'jax' or "
            + "m.startswith(('jax.', 'flash_attn_tpu.'))], 'imported jax'\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
