"""Nothing the harness loads is JAX or the JAX package, compared by whole
top-level name (``tpu3d_torch`` begins with ``tpu3d``); the reference
imports nothing of the program."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

LOAD_ALL = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.harness import runner, spec
from portbench import control
bench = json.load(open({root!r} + '/BENCHMARK.json'))
for w in bench['workloads']:
    cell = spec.cell(w['name'], bench)
    cell.driver(); cell.generator()
for m in bench['per_layer']:
    spec.reader(m['name'])
import tpu3d_torch.registration, tpu3d_torch.pipeline.pipeline
print(' '.join(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    names = top_level(LOAD_ALL.format(root=str(ROOT)))
    assert "tpu3d_torch" in names and "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "tpu3d", "bench",
                        "benchmarks"}


def test_reference_imports_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "import portbench.reference.judge, portbench.reference.frames\n"
            "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    assert "tpu3d_torch" not in top_level(code)


def test_forbidden_names_compare_whole():
    from portbench.harness import runner

    sys.modules["tpu3d_torch_probe_name"] = sys
    try:
        assert "tpu3d" not in runner.forbidden_modules()
        sys.modules["tpu3d"] = sys
        assert "tpu3d" in runner.forbidden_modules()
    finally:
        sys.modules.pop("tpu3d", None)
        sys.modules.pop("tpu3d_torch_probe_name", None)
