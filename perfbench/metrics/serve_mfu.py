"""serve_mfu: the model FLOPs the window's completed requests need (perfbench.counts.serve_flops, real tokens only) over its seconds, as % of 989 TFLOP/s."""

from perfbench import readers


def read(obs):
    return readers.mfu(obs)
