"""train_mfu: the window's training model FLOPs (perfbench.counts.train_flops) over its seconds, as % of 989 TFLOP/s."""

from perfbench import readers


def read(obs):
    return readers.mfu(obs)
