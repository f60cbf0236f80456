"""The fold launches of ``csrc/fused_step.cu``'s grouped kernel (the folded
base's iterations) in the traced requests: their bound time
(``portbench/roofline_fold.py``, the traffic's ``ProjectionConfig``) over
their measured device time, in percent."""
from portbench import roofline_fold


def read(run):
    return roofline_fold.share(run, delta=False)
