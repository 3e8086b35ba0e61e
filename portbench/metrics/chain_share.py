"""chain_share (chain_share.serve): the share in % of the busy device time
in the profiled sub-window taken by the kernels the breakdown classes as
``elementwise/other`` or ``copies`` (``harness/common.py``
``kernel_class``): in the Llama serving phases the chain around the
products, which the port's fused norm, rotary and SwiGLU kernels
(``kernels/llama_chain.py``) and, in a routed-expert model, the experts'
routing and dispatch leave there. The sum of those kernels' durations
over the union of every device interval; a window with no device work
reads nothing."""

from portbench.harness.common import kernel_class

CLASSES = ("elementwise/other", "copies")


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    busy = tr.union_us()
    if busy <= 0:
        return None
    chain = sum(d for name, _, d in tr.device
                if kernel_class(name) in CLASSES)
    return 100.0 * chain / busy
