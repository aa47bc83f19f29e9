"""train.step_ms_p50: median of the runner's spans around each train_step of the window, each ended by a synchronise."""

from perfbench import readers


def read(obs):
    return readers.median_ms(obs, "train.step")
