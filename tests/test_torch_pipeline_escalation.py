"""The port's sparse-arm escalation against the JAX package's
(``tests/test_pipeline.py``'s forced-escalation fixture, on a smaller
bumpy frame), from the per-instance and the batched path, with JAX's
RANSAC draw stream replayed."""

import time

from test_torch_pipeline_sparse import _assert_same, _both, frame  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


def test_sparse_escalation_matches_jax(frame, monkeypatch, capsys):
    """A forced threshold escalates from both paths. The batched path
    escalates from the batch's result: each member runs the sparse arm once
    (JAX re-runs it per instance before escalating), and the poses equal
    JAX's."""
    (jp, jprep, jref), (tp, tprep, tref), runs = _both(frame, True,
                                                       monkeypatch)
    j_pose = jp._register_instance_inner(jprep[0], None, *jref, 0,
                                         time.perf_counter())
    t_pose = tp._register_instance_inner(tprep[0], None, *tref, 0,
                                         time.perf_counter())
    out = capsys.readouterr().out
    assert out.count("escalating through the full-prepare arm") == 2
    assert len(runs) == 1

    j_poses = jp._register_instances([jprep, jprep], *jref)
    out = capsys.readouterr().out
    assert "re-running per-instance with escalation" in out
    t_poses = tp._register_instances([tprep, tprep], *tref)
    out = capsys.readouterr().out
    assert out.count("escalating through the full-prepare arm") == 2
    assert "re-running" not in out
    assert len(runs) == 3 and tp._batched_groups == 1 and tp._degraded == 0
    _assert_same([j_pose] + j_poses, [t_pose] + t_poses, jp, tp,
                 tprep[0].count())
