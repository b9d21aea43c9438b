"""The port's two examples on the CPU, at 5,000 surface points (20,000 by
default; the CPU's plain PyTorch takes ~2 min there): each recovered pose
through bench.py's quality gate, the multichip one over a virtual mesh of
4 CPU shards through the sharded route."""

import ast
import os
import sys

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
sys.path.insert(0, EXAMPLES)

import torch_register_pair  # noqa: E402
import torch_register_pair_multichip  # noqa: E402

POINTS = "5000"


def _gate(r_err, t_err, fitness):
    assert r_err < 0.02 and t_err < 0.005, (r_err, t_err)
    assert fitness > 0.5


@pytest.mark.parametrize("name", ["torch_register_pair.py",
                                  "torch_register_pair_multichip.py"])
def test_examples_import_only_the_port(name):
    with open(os.path.join(EXAMPLES, name)) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "tpu3d_torch" in roots
    assert not roots & {"jax", "jaxlib", "tpu3d"}


def test_register_pair_example(capsys):
    _gate(*torch_register_pair.main(["--device", "cpu", "--points", POINTS]))
    out = capsys.readouterr().out
    assert "rotation error:" in out and "translation error:" in out


def test_multichip_example_on_a_virtual_mesh(monkeypatch, capsys):
    from tpu3d_torch.parallel import mesh, register_sharded

    meshes = []
    real = register_sharded.register_pair_sharded

    def counted(source, target, config, m, **kw):
        meshes.append(m)
        return real(source, target, config, m, **kw)

    monkeypatch.setattr(register_sharded, "register_pair_sharded", counted)
    _gate(*torch_register_pair_multichip.main(
        ["--device", "cpu", "--virtual", "4", "--points", POINTS]))
    assert len(meshes) == 1 and meshes[0].shape == {"shard": 4}
    assert all(d == torch.device("cpu") for d in meshes[0].devices.reshape(-1))
    assert "devices: 4" in capsys.readouterr().out
    # The virtual device count is restored.
    assert mesh.visible_devices("cpu") == [torch.device("cpu")]
