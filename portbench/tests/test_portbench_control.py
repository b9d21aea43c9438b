"""The comparison fails what it must fail, on the CPU at a size a test run
holds (the scan-registration cell with 2,500-point pairs and RANSAC cut to
3,000 hypotheses; the limits are the cell's own).

* the control: the reference in TF32 put in the program's place;
* faults planted in the program under a whole run (the look for a card
  skipped): ICP returning its state unchanged, the voxel means taken over
  half of the points, a correspondence altered where it is produced, the
  refined pose altered where it is produced.
"""

import time

import pytest
import torch

from portbench import control
from portbench.harness import runner, spec

SMALL = {"points": 2500, "pool": 2}


def small_cell():
    cell = spec.cell("pair_8k")
    cell.traffic.update(SMALL)
    cell.config["registration"]["ransac_max_iterations"] = 3000
    cell.workload["checked_requests"] = 2
    return cell


def over(numbers: dict, limits: dict) -> list:
    return sorted(n for n, v in numbers.items()
                  if n in limits and not v <= limits[n])


def test_the_control_fails_and_the_program_passes():
    cell = small_cell()
    r = control.readings(cell, 2**31 + 77, device="cpu")
    limits = cell.workload["limits"]
    assert over(r["program"], limits) == []
    assert over(r["control"], limits) != []


def _icp_unchanged(monkeypatch):
    from tpu3d_torch import registration

    real = registration.icp_refine

    def fault(source, target, init, *a, **k):
        out = real(source, target, init, *a, **k)
        return out._replace(transformation=init.to(torch.float32))
    monkeypatch.setattr(registration, "icp_refine", fault)


def _half_the_points(monkeypatch):
    from tpu3d_torch import registration

    real = registration.downsample_bucketed

    def fault(cloud, config, capacity=None):
        keep = cloud.mask.clone()
        keep[1::2] = False
        return real(cloud._replace(mask=keep), config, capacity)
    monkeypatch.setattr(registration, "downsample_bucketed", fault)


def _correspondence_altered(monkeypatch):
    from tpu3d_torch.ops import ransac

    real = ransac.feature_correspondences

    def fault(src, tgt):
        idx = real(src, tgt).clone()
        idx[::10] = (idx[::10] + 1) % tgt.descriptors.shape[0]
        return idx
    monkeypatch.setattr(ransac, "feature_correspondences", fault)


def _pose_altered(monkeypatch):
    from tpu3d_torch import registration

    real = registration.icp_refine

    def fault(*a, **k):
        out = real(*a, **k)
        T = out.transformation.clone()
        T[0, 3] += 0.001
        return out._replace(transformation=T)
    monkeypatch.setattr(registration, "icp_refine", fault)


FAULTS = {"icp_unchanged": _icp_unchanged,
          "half_the_points": _half_the_points,
          "correspondence_altered": _correspondence_altered,
          "pose_altered": _pose_altered}


@pytest.mark.parametrize("fault", [None] + sorted(FAULTS))
def test_a_run_with_a_fault_is_not_correct(fault, monkeypatch):
    if fault is not None:
        FAULTS[fault](monkeypatch)
    res = runner.run(small_cell(), 2**31 + 91, 0.5, False,
                     time.perf_counter(), device="cpu")
    bad = [n for n, c in res["checks"].items()
           if not c["value"] <= c["limit"]]
    assert res["correct"] == (fault is None), bad
