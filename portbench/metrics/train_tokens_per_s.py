"""train_tokens_per_s: the tokens of every whole training step in the
window (each step ends in a synchronize) over the time from the window's
opening to the end of its last step."""


def read(ctx):
    if ctx.kind != "train" or not ctx.steps:
        return None
    return len(ctx.steps) * ctx.tokens_per_step / (ctx.steps[-1][1]
                                                   - ctx.window[0])
