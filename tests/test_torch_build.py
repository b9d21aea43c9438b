"""The kernels' first build under concurrent first calls: the pipeline's
prepare threads can all reach ``build.library()`` before it has built."""

import sys
import threading
import time
import types

from tpu3d_torch import build


def test_concurrent_first_calls_build_once(monkeypatch):
    builds = []

    def slow_build(verbose=False):
        builds.append(threading.get_ident())
        time.sleep(0.05)  # long enough for every thread to arrive
        return "libtpu3d_kernels_test.so"

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(build, "build", slow_build)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: FakeLib())
    build._load.cache_clear()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    libs = []
    try:
        threads = [
            threading.Thread(target=lambda: libs.append(build.library()))
            for _ in range(32)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        build._load.cache_clear()
    assert len(builds) == 1
    assert len(libs) == 32 and all(lib is libs[0] for lib in libs)
    assert libs[0].tpu3d_bilateral_filter.argtypes == build.SIGNATURES[
        "tpu3d_bilateral_filter"]


def test_signatures_name_every_entry_point():
    """The library binds K8's and the probe's C entry points beside the
    earlier kernels'."""
    for name in ("tpu3d_nn_top1", "tpu3d_nn_desc_top1", "tpu3d_ransac_score",
                 "tpu3d_icp_p2plane_stats", "tpu3d_moments_sweep",
                 "tpu3d_spfh_sweep", "tpu3d_fpfh_sweep",
                 "tpu3d_bilateral_filter", "tpu3d_nn_walk_top1",
                 "tpu3d_knn_select", "tpu3d_probe_unary", "tpu3d_probe_argmin",
                 "tpu3d_probe_cumsum", "tpu3d_probe_dot_axis0",
                 "tpu3d_probe_transpose"):
        assert name in build.SIGNATURES, name
    # q4, packed, lo, len, order, then qp, m, nb, k, block, sub, slices,
    # per, r2, d2, idx, stream
    assert build.SIGNATURES["tpu3d_nn_walk_top1"] == [
        build._P] * 5 + [build._I] * 8 + [build._F] + [build._P] * 3
    # in, out, then h, w, r, inv_s2, inv_r2, stream
    assert build.SIGNATURES["tpu3d_bilateral_filter"] == [
        build._P] * 2 + [build._I] * 3 + [build._D, build._F, build._P]
    # The tensor-core routes: qop, top, queries, then q, d, qp, m_tiles,
    # tiles_per_split, splits, then partials, idx, d2, stream; and feat,
    # pq, w, tn, then n, h, rows, slices, thr2, band, then partials,
    # outputs, stream.
    assert build.SIGNATURES["tpu3d_nn_desc_top1"] == (
        [build._P] * 3 + [build._I] * 6 + [build._P] * 5)
    assert build.SIGNATURES["tpu3d_ransac_score"] == (
        [build._P] * 4 + [build._I] * 4 + [build._F] * 2 + [build._P] * 5)
    # K12: d2, then q, m, k, then d2 and idx out, stream
    assert build.SIGNATURES["tpu3d_knn_select"] == (
        [build._P] + [build._I] * 3 + [build._P] * 3)
    sources = {p.name for p in build._sources()}
    assert {"nn_walk.cu", "probe.cu", "knn_select.cu"} <= sources
