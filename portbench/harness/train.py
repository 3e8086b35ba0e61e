"""Training cells: the port's training step over fresh batches from the
seed, then its first steps judged by the plain reference.

Set-up builds the one training object (model, AdamW state, step) and
drives it through its first ``check.steps`` steps on the window's own
feed; it reads each step's loss, the first gradient as the optimizer got
it (AdamW's first moment after one step is (1 - beta1) g) and each leaf's
change after the last checked step. The window then runs whole steps,
each ending in a synchronize, until ``--seconds`` have passed. After the
window the program's state is freed and the reference follows the same
steps from the same weights and batches.
"""

from __future__ import annotations

import statistics

import torch

from portbench.harness.common import (
    Profiled,
    Spans,
    clock,
    log,
    make_weights,
    weight_seed,
)


class Feed:
    """Batches of uniform token ids from the seed, made on the device."""

    def __init__(self, t, vocab, seed, device):
        self.t, self.vocab, self.device = t, vocab, device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)

    def __call__(self):
        ids = torch.randint(0, self.vocab, (self.t["batch"], self.t["seq"]),
                            generator=self.gen, device=self.device)
        return {"input_ids": ids, "labels": ids}


def program_readings(model, opt, step, feed, n_steps, spec, wseed, device,
                     beta1):
    """The program's losses, first-step gradient norms and change norms
    over its first n_steps steps."""
    names = {p: n for n, p in model.named_parameters()}
    losses, grads = [], {}
    for k in range(n_steps):
        losses.append(float(step(feed())))
        if k == 0:  # a leaf the optimizer holds no state for got none
            with torch.no_grad():
                grads = {n: float(opt.state[p]["exp_avg"].norm())
                         / (1 - beta1) if p in opt.state else 0.0
                         for p, n in names.items()}
    with torch.no_grad():
        w0 = make_weights(spec, wseed, torch.float32, device)
        change = {n: float((p - w0[n]).norm())
                  for n, p in model.named_parameters()}
        del w0
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


def compare(prog: dict, ref: dict) -> dict:
    """The gaps the check holds: the worst step's loss gap, and by the
    worst leaf the gap between the program's and the reference's norms
    of the first gradient and of the change, each over the larger of that
    leaf's reference norm and the median leaf's. Leaves whose reference
    gradient is under a thousandth of the median leaf's (nought to
    rounding) are left out of the change."""
    loss_gap = max(abs(a - b) for a, b in zip(prog["losses"],
                                              ref["losses"]))
    g_med = statistics.median(ref["grad_norms"].values())

    def worst(key, leaves):
        ref_n = ref[key]
        med = statistics.median(ref_n[n] for n in leaves)
        return max((abs(prog[key][n] - ref_n[n]) / max(ref_n[n], med), n)
                   for n in leaves)

    every = list(ref["grad_norms"])
    moving = [n for n in every if ref["grad_norms"][n] >= 1e-3 * g_med]
    grad_gap, grad_leaf = worst("grad_norms", every)
    change_gap, change_leaf = worst("change_norms", moving)
    log(f"check: worst gradient leaf {grad_leaf}, worst change leaf "
        f"{change_leaf}; {len(every) - len(moving)} leaves left out of the "
        f"change")
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def build(r):
    """The one training object from the seed: (model, optimizer, step,
    feed, weight spec, weight seed)."""
    c, t, dev = r.config, r.traffic, r.device
    pcfg = r.family.port_config(c, train=True)
    spec = r.family.param_spec(c)
    wseed = weight_seed(r.seed)
    weights = make_weights(spec, wseed, torch.float32, dev.torch_device)
    model = r.family.build(pcfg, weights, dev.torch_device, train=True)
    step, opt = r.family.train_step(model, t["optimizer"],
                                    t.get("lm_loss_chunk"))
    step = r.wrap_step(step) if r.wrap_step else step
    feed = Feed(t, c["vocab_size"], r.seed, dev.torch_device)
    return model, opt, step, feed, spec, wseed


def first_steps(r, model, opt, step, feed, spec, wseed) -> dict:
    beta1 = r.traffic["optimizer"].get("betas", (0.9, 0.999))[0]
    return program_readings(model, opt, step, feed,
                            r.traffic["check"]["steps"], spec, wseed,
                            r.device.torch_device, beta1)


def reference_readings(r, mode="fp32") -> dict:
    """The plain reference's readings over the same first steps, from the
    same weights and batches (``mode="fp8"``: the control)."""
    t, dev = r.traffic, r.device
    r.reference.no_tf32()
    feed = Feed(t, r.config["vocab_size"], r.seed, dev.torch_device)
    batches = [feed()["input_ids"] for _ in range(t["check"]["steps"])]
    spec = r.family.param_spec(r.config)
    return r.reference.train(make_weights(spec, weight_seed(r.seed),
                                          torch.float32, dev.torch_device),
                             r.config, batches, t["optimizer"], mode)


def run(r) -> dict:
    t, dev = r.traffic, r.device
    model, opt, step, feed, spec, wseed = build(r)
    prog = first_steps(r, model, opt, step, feed, spec, wseed)
    spans = Spans(annotate=r.trace)
    prof = Profiled(dev) if r.trace else None
    p_at = t["trace_start"] * r.seconds
    p_steps = t["trace_steps"]
    dev.sync()
    setup_s = clock() - r.t_start

    steps = []
    t0 = clock()
    while not steps or steps[-1][1] - t0 < r.seconds:
        if prof is not None and prof.state == "idle" and \
                clock() - t0 >= p_at:
            prof.start()
            p_first = len(steps)
        with spans.span("train.step"):
            step(feed())
            dev.sync()
        steps.append(spans.items[-1][1:3])
        if prof is not None and prof.state == "on" and \
                len(steps) - p_first >= p_steps:
            prof.stop()
    if prof is not None and prof.state == "on":
        prof.stop()
    peak = dev.peak_bytes()
    trace = prof.reduce() if prof is not None and prof.state == "done" \
        else None
    del model, opt, step
    if dev.cuda:
        torch.cuda.empty_cache()

    ref = reference_readings(r)
    log(f"train: losses program {prog['losses']} reference {ref['losses']}")
    gaps = compare(prog, ref)
    limits = t["check"]["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}
    return dict(setup_s=setup_s, window=(t0, steps[-1][1]), steps=steps,
                tokens_per_step=t["batch"] * t["seq"], spans=spans.items,
                trace=trace, profiled=(prof.t0, prof.t1)
                if trace is not None else None, peak=peak, checks=checks,
                attempted=len(steps), failed=0)
