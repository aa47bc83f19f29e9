"""gen_tokens_per_s: every token generated by the requests completed in the window over the summed seconds of the engine's run calls (host clock)."""

from perfbench import readers


def read(obs):
    return readers.rate(obs, "tokens_generated")
