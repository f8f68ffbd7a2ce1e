"""flash_attention_roofline.train: percent of the traced time of the bf16
flash_attention forward kernel (forward and any recompute under remat)
that its operations bound is: 4 hd flops a kept causal pair a head at
989 TFLOP/s (harness/counts.py attention_call_seconds) a call, times the
kernel's traced launches."""

from harness.readers import roofline


def read(run):
    return roofline(run, "flash_attention_wgmma_kernel",
                    ["flash_attention_wgmma_kernel"],
                    ["flash_attention_wgmma_kernel"])
