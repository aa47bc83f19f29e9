"""flash_bwd_roofline.train: % of the roofline of the flash backward kernels' device time in the traced training steps."""

from perfbench import readers

#: the bf16 kernels this cell runs (csrc/flash_bwd.cu), as the device trace names them
KERNELS = ("rows_kernel", "bwd_bf16_kernel", "finish_kernel")


def read(obs):
    return readers.roofline(obs, "bwd", KERNELS)
