"""tpu3d_torch.utils.profiling: the trace context writes a Chrome trace
holding the annotated range, and StageRecorder mirrors the JAX one."""

import json
import os

import torch

from tpu3d.utils.profiling import StageRecorder as JaxStageRecorder
from tpu3d_torch.utils import StageRecorder, annotate, trace


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir) as prof:
        with annotate("tpu3d_stage"):
            torch.ones(64).sum()
    path = os.path.join(logdir, "trace.json")
    assert os.path.exists(path) and prof is not None
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "tpu3d_stage" for e in events)


def test_stage_recorder_mirrors_jax(tmp_path):
    recs = []
    for cls in (StageRecorder, JaxStageRecorder):
        rec = cls()
        with rec.stage("a", n=3):
            pass
        with rec.stage("b"):
            pass
        recs.append(rec)
    ours, ref = recs
    assert list(ours.summary()) == list(ref.summary()) == ["a", "b"]
    assert [set(r) for r in ours.records] == [set(r) for r in ref.records]
    assert ours.records[0]["n"] == 3
    path = str(tmp_path / "s.json")
    assert json.loads(ours.dump(path)) == json.load(open(path))
    ours.report()
