"""device_idle.serve: % of the traced window in which no operation ran on the device."""

from perfbench import readers


def read(obs):
    return readers.idle(obs)
