"""flash_roofline.serve: % of the roofline of the flash forward kernels' device time in the traced engine call."""

from perfbench import readers

#: the bf16 kernels this cell runs (csrc/flash.cu), as the device trace names them
KERNELS = ("flash_bf16_kernel",)


def read(obs):
    return readers.roofline(obs, "fwd", KERNELS)
