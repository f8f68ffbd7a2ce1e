"""flash_decode_roofline.decode: percent of the traced time of the
flash_decode split and combine kernels that their bytes bound is: the K/V
rows below each frontier read once at 3.35 TB/s (harness/counts.py
decode_call_seconds) a call, times the calls traced (one split kernel, on
the tensor cores or the CUDA cores, a call)."""

from harness.readers import roofline


def read(run):
    return roofline(run, "flash_decode",
                    ["flash_decode_split_kernel", "flash_decode_mma_kernel",
                     "flash_decode_combine_kernel"],
                    ["flash_decode_split_kernel", "flash_decode_mma_kernel"])
