"""train_tokens_per_s: every token trained in the window over the window's seconds (host clock)."""

from perfbench import readers


def read(obs):
    return readers.rate(obs, "tokens_trained")
