"""The step's model flops (counted from the configuration's shapes by
``counts.model_flops_per_step``) over the step's time in the untraced
window, as a share of the card's float32 peak."""


def read(ctx):
    if ctx.card is None or not getattr(ctx, "step_s", None):
        return None
    rate = ctx.model_flops_per_step / ctx.step_s
    return 100.0 * rate / ctx.card["fp32_flops"]
