"""The model step's share of the card's bf16 peak: the FLOPs the tokens
delivered in the window's unprofiled stretches needed (prompts' real
tokens, each token's causal context, the head where logits are needed)
over those stretches, over 989.4 TFLOP/s."""
from perfbench import readers, work


def read(ctx):
    ivs = readers.intervals(ctx)
    return 100.0 * readers.serve_flops(ctx, ivs) / readers.span(ivs) \
        / work.PEAK_FLOPS
