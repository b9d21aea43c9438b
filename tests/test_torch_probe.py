"""The probe's counterpart (``tpu3d_torch.probe``) on the CPU: each probed
function's plain version on the JAX probe's inputs against the expression
that ``benchmarks/pallas_probe.py`` puts inside its Pallas kernel,
evaluated by jax.numpy (the probe itself runs only on a TPU). The
transcendentals are held within the probe's own tolerance (2 x the CUDA
math library's documented ulp bound); argmin and the transpose exactly;
the cumsum and the product within the sequential-sum bound the probe
states."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3d_torch import probe
from torch_threads import one_torch_thread  # noqa: F401


def _jax_inputs():
    x = jnp.linspace(-2, 2, 8 * 256).reshape(8, 256).astype(jnp.float32)
    y = jnp.linspace(0, 1, 128 * 128).reshape(128, 128).astype(jnp.float32)
    return x, y


def test_probe_inputs_are_the_jax_probes():
    x, y, a = probe.probe_inputs("cpu")
    jx, jy = _jax_inputs()
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=3e-7)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-7)
    assert a.shape == (31, 128) and bool((a == 1).all())


@pytest.mark.parametrize("name", probe.UNARY)
def test_unary_matches_jax(name):
    x, _, _ = probe.probe_inputs("cpu")
    jx = jnp.asarray(x.numpy())
    ref = {
        "atan2": lambda i: jnp.arctan2(i, 0.5 + 0.0 * i),
        "atan": jnp.arctan,
        "acos": lambda i: jnp.arccos(jnp.clip(i, -1.0, 1.0)),
        "cos": jnp.cos,
    }[name](jx)
    got = probe.unary(x, name)
    assert probe.ulp_distance(got, torch.from_numpy(np.array(ref))) <= (
        2 * probe.ULP_BOUND[name])


def test_argmin_cumsum_dot_transpose_match_jax():
    x, y, a = probe.probe_inputs("cpu")
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    # Rows with ties: the first least column wins, as jnp.argmin's.
    t = x.clone()
    t[:, 100:] = t[:, :156]
    t[3, 7] = t[3, 0]
    np.testing.assert_array_equal(
        probe.row_argmin(t).numpy(),
        np.asarray(jnp.argmin(jnp.asarray(t.numpy()), axis=1)))
    n = torch.arange(1, 257)
    tol = 2 * n * probe._U * torch.cumsum(x.abs().double(), 1)
    err = (probe.row_cumsum(x).double()
           - torch.from_numpy(np.array(jnp.cumsum(jx, axis=1))).double())
    assert bool((err.abs() <= tol).all())
    ja = jnp.ones((31, 128), jnp.float32)
    jdot = jax.lax.dot_general(
        ja, jy[:, :31], (((0,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)
    tol = 2 * 31 * probe._U * (a.double().T @ y[:, :31].double().T)
    err = probe.dot_axis0(a, y).double() - torch.from_numpy(
        np.asarray(jdot)).double()
    assert bool((err.abs() <= tol).all())
    np.testing.assert_array_equal(probe.transpose(y).numpy(),
                                  np.asarray(jnp.swapaxes(jy, 0, 1)))


def test_probe_main_on_the_cpu_and_its_checks():
    assert probe.main("cpu") == 0
    assert all(r["ok"] for r in probe.run("cpu"))
    with pytest.raises(TypeError):
        probe.unary(torch.zeros(4, dtype=torch.float64), "cos")
    with pytest.raises(ValueError):
        probe.unary(torch.zeros(4), "tan")
    with pytest.raises(ValueError):
        probe.transpose(torch.zeros(3, 4))
