"""The port's host runtime (``tpu3d_torch.native``: its own copy of the C++
source, built by g++ at first use) against the numpy paths: the PLY
readers equal on ASCII (its line forms, and a body cut across threads),
binary and colourless files, the mask resize equal to the numpy nearest
resize binarised at 10, and the loaders using it."""

import numpy as np
import pytest

from tpu3d_torch import build, native
from tpu3d_torch.io import segmentation
from tpu3d_torch.models import ply
from torch_threads import one_torch_thread  # noqa: F401


def test_builds_from_the_port_source():
    assert native.available()
    lib = native.build_library()
    assert lib.parent == build.BUILD_DIR and lib.exists()
    assert native._digest() in lib.name
    assert native.SOURCE.parent == build.CSRC / "host"
    # The CUDA build compiles csrc/*.cu only.
    assert native.SOURCE not in build._sources()


def _numpy_reader(path, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        return ply.load_ply(path)


@pytest.mark.parametrize("colors", [True, False])
def test_ascii_readers_agree(rng, tmp_path, monkeypatch, colors):
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    cols = rng.uniform(size=(500, 3)).astype(np.float32) if colors else None
    path = str(tmp_path / "a.ply")
    ply.save_ply(path, pts, cols)
    got = native.load_ply(path)
    assert got is not None
    ref = _numpy_reader(path, monkeypatch)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[0], pts, atol=1e-4)
    if colors:
        np.testing.assert_array_equal(got[1], ref[1])
    else:
        assert got[1] is None and ref[1] is None
    # load_ply takes the native parser.
    out = ply.load_ply(path)
    np.testing.assert_array_equal(out[0], got[0])


def _ascii(path, lines, props="xyz"):
    names = {"x": "x", "y": "y", "z": "z", "r": "red", "g": "green",
             "b": "blue", "w": "intensity"}
    with open(path, "w", newline="") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(lines)}\n")
        for c in props:
            kind = "uchar" if c in "rgb" else "float"
            f.write(f"property {kind} {names[c]}\n")
        f.write("end_header\n")
        f.write("".join(lines))


@pytest.mark.parametrize("case", ["crlf", "no_final_newline",
                                  "extra_tokens", "short_lines",
                                  "signs_and_exponents", "intensity_first",
                                  "trailing_faces"])
def test_ascii_line_forms_agree(rng, tmp_path, monkeypatch, case):
    """The C++ parser reads line i as vertex i, its leading fields in
    order: the same arrays as the numpy reader on CR-LF lines, a last line
    without a newline, tokens past the declared properties (dropped),
    lines short of them (0), '+' signs and exponents, a property before
    x, and a face block after the vertices."""
    v = rng.normal(size=(40, 3)).astype(np.float32)
    rows = [f"{a} {b} {c}" for a, b, c in v]
    props = "xyz"
    if case == "crlf":
        lines = [r + "\r\n" for r in rows]
    elif case == "no_final_newline":
        lines = [r + "\n" for r in rows[:-1]] + [rows[-1]]
    elif case == "extra_tokens":
        lines = [r + " 7 8\n" if i % 3 == 0 else r + "\n"
                 for i, r in enumerate(rows)]
    elif case == "short_lines":
        lines = [(" ".join(r.split()[:2]) if i % 4 == 1 else r) + "\n"
                 for i, r in enumerate(rows)]
    elif case == "signs_and_exponents":
        lines = [f"{a:+.6e}\t{b:+.3E}  {c:e}\n" for a, b, c in v]
    elif case == "intensity_first":
        props = "wxyzrgb"
        lines = [f"{i / 7} {r} {i} {2 * i} 255\n"
                 for i, r in enumerate(rows)]
    else:
        lines = [r + "\n" for r in rows] + ["3 0 1 2\n", "3 1 2 3\n"]
    path = str(tmp_path / f"{case}.ply")
    _ascii(path, lines, props)
    if case == "trailing_faces":  # the header declares the faces after
        text = open(path).read().replace(
            "end_header", "element face 2\nproperty list uchar int "
            "vertex_indices\nend_header")
        open(path, "w").write(text)
    got = native.load_ply(path)
    assert got is not None
    ref = _numpy_reader(path, monkeypatch)
    np.testing.assert_array_equal(got[0], ref[0])
    if ref[1] is None:
        assert got[1] is None
    else:
        np.testing.assert_array_equal(got[1], ref[1])
    if case == "short_lines":
        assert (got[0][1::4, 2] == 0).all()


def test_ascii_readers_agree_over_many_chunks(rng, tmp_path, monkeypatch):
    """A body of several MiB is cut into line-aligned chunks parsed on
    separate threads; the rows still land in file order."""
    pts = rng.uniform(-1, 1, size=(150_000, 3)).astype(np.float32)
    path = str(tmp_path / "big.ply")
    _ascii(path, [f"{a} {b} {c}\n" for a, b, c in pts])
    got = native.load_ply(path)
    ref = _numpy_reader(path, monkeypatch)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[0], pts)


def test_ascii_body_short_of_the_count_is_declined(tmp_path):
    """Fewer vertex lines than the header declares: the C++ parser
    declines (rc 6) and load_ply takes the numpy reader."""
    path = str(tmp_path / "short.ply")
    _ascii(path, ["0 0 0\n", "1 1 1\n"])
    text = open(path).read().replace("element vertex 2",
                                     "element vertex 3")
    open(path, "w").write(text)
    assert native.load_ply(path) is None


def test_binary_readers_agree(rng, tmp_path, monkeypatch):
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    cols = (rng.uniform(size=(300, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "b.ply")
    with open(path, "wb") as f:
        f.write(
            b"ply\nformat binary_little_endian 1.0\n"
            b"element vertex 300\n"
            b"property float x\nproperty float y\nproperty float z\n"
            b"property uchar red\nproperty uchar green\nproperty uchar blue\n"
            b"end_header\n"
        )
        for i in range(300):
            f.write(pts[i].tobytes())
            f.write(cols[i].tobytes())
    got = native.load_ply(path)
    ref = _numpy_reader(path, monkeypatch)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[0], pts)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6)
    np.testing.assert_allclose(got[1], cols / 255.0, atol=1e-6)  # > 1 → /255


def test_declined_file_takes_the_numpy_reader(tmp_path, monkeypatch):
    """A file the C++ parser declines (rc ≠ 0) is read by numpy: a missing
    file degrades to empty arrays, as in the JAX package."""
    assert native.load_ply(str(tmp_path / "missing.ply")) is None
    pts, cols = ply.load_ply(str(tmp_path / "missing.ply"))
    assert pts.shape == (0, 3) and cols is None
    seen = []
    monkeypatch.setattr(native, "load_ply",
                        lambda p: seen.append(p) or None)
    path = str(tmp_path / "c.ply")
    ply.save_ply(path, np.ones((4, 3), np.float32))
    pts, _ = ply.load_ply(path)
    assert seen == [path] and pts.shape == (4, 3)


def test_mask_resize_matches_numpy(rng, monkeypatch):
    m = (rng.uniform(size=(45, 67)) * 255).astype(np.uint8)
    got = native.resize_mask_nearest_threshold(m, 90, 134)
    ys = (np.arange(90) * 45 / 90).astype(np.int64)
    xs = (np.arange(134) * 67 / 134).astype(np.int64)
    exp = np.where(m[ys[:, None], xs[None, :]] > 10, 255, 0).astype(np.uint8)
    np.testing.assert_array_equal(got, exp)
    # Each path io.segmentation can take (cv2 where installed, then the
    # runtime, then numpy) gives, thresholded, the same mask; without cv2
    # the runtime's own result.
    resized = segmentation.resize_mask_nearest(m, 90, 134)
    np.testing.assert_array_equal(np.where(resized > 10, 255, 0), got)
    monkeypatch.setattr(segmentation, "_HAS_CV2", False)
    np.testing.assert_array_equal(
        segmentation.resize_mask_nearest(m, 90, 134), got)
    monkeypatch.setattr(native, "available", lambda: False)
    plain = segmentation.resize_mask_nearest(m, 90, 134)
    np.testing.assert_array_equal(np.where(plain > 10, 255, 0), got)
