"""Sharded prepare's exactness flag: ``tpu3d_torch.parallel.
prepare_sharded`` on an 8-shard CPU mesh against
``tpu3d.parallel.prepare_sharded`` on JAX's 8 virtual host devices, on
``test_prepare_sharded.py``'s flagged inputs (its values in
``test_torch_parallel_prepare.py``)."""

import jax
import numpy as np
import pytest

from test_torch_parallel_prepare import _bumpy, _jax, _port
from tpu3d.parallel import make_mesh as jax_make_mesh
from tpu3d_torch.parallel import make_mesh
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh (conftest default)")
    return jax_make_mesh(("shard",)), make_mesh(devices=["cpu"] * 8)


@pytest.mark.parametrize("case", ["degenerate_x", "thin_halo", "wide"])
def test_ok_flag_matches_jax(rng, meshes, case):
    """``test_prepare_sharded.py``'s flagged inputs (every x equal at
    4,096 rows; an 8-row halo at 16,384) and a well-spread 4,096-row
    cloud with a 512-row halo: the same flag as JAX's."""
    jmesh, mesh = meshes
    r = np.float32(0.004)
    n = 16384 if case == "thin_halo" else 4096
    pts = _bumpy(rng, n, r)
    kw = {}
    if case == "degenerate_x":
        pts[:, 0] = 0.05
    elif case == "thin_halo":
        kw = {"halo": 8}
    else:
        kw = {"halo": 512}
    _, _, jok, _ = _jax(pts, n, r, jmesh, **kw)
    _, _, tok, _ = _port(pts, n, r, mesh, **kw)
    assert tok == jok == (case == "wide")
