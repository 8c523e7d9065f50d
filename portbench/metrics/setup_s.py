"""Seconds from the start of the process to the first timed solve:
imports, the card's context, the seeded state made on the card, plans,
kernel builds (the first run in a checkout) and the warm-up."""


def read(ctx):
    return ctx.setup_s
