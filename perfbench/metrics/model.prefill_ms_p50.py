"""model.prefill_ms_p50: median of the runner's spans around models.model.prefill in the window, synchronised on both sides (traced run)."""

from perfbench import readers


def read(obs):
    return readers.median_ms(obs, "model.prefill")
