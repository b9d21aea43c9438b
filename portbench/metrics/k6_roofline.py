"""K6 (csrc/ransac_score.cu, hypothesis scoring): share of its roofline
over the profiled slice; operations and bytes from harness/roofline.py."""

from portbench.harness.readers import roofline_pct


def read(data):
    return roofline_pct(data, "k6")
