"""K5 (csrc/nn.cu, descriptor top-1): share of its roofline over the
profiled slice; operations and bytes from harness/roofline.py."""

from portbench.harness.readers import roofline_pct


def read(data):
    return roofline_pct(data, "k5")
