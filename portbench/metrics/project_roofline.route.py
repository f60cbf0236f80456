"""The grouped base projection ``cfmm_project`` (``csrc/projection.cu``) in
the traced routes: its launches' bound time (``portbench/roofline.py``,
ProjectionConfig(24, 4)) over their measured device time, in percent."""
from portbench import roofline


def read(run):
    return roofline.share(run.trace, run.net, "project_kernel",
                          roofline.project_bound_s)
