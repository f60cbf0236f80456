"""The fold launches of ``csrc/fused_step_delta.cu``'s kernel (the folded
refinement's correction iterations) in the traced requests: their bound
time (``portbench/roofline_fold.py``, 80 flops a slot a root-find step)
over their measured device time, in percent."""
from portbench import roofline_fold


def read(run):
    return roofline_fold.share(run, delta=True)
