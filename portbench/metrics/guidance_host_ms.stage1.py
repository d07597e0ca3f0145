"""Host time per call of the guidance callable the benchmark hands the
trainer (its own span, no synchronisation added), over the window's
steps: the VAE encode, the UNet with CFG and the SDS target as launched."""

LAYER = "guidance"
UNIT = "ms"
MOVES = "stage1_step_ms"


def read(ctx):
    spans = ctx.get("guidance_host_s")
    if ctx.get("kind") != "stage1" or not spans:
        return None
    return sum(spans) / len(spans) * 1e3
