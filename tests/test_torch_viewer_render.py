"""Render proof for the port's exported WebGL viewer page: a mirror of
tests/test_viewer_render.py on ``tpu3d_torch.viz`` (``softrender`` and
``viewer``).

A headless compute host has no browser or JS engine, so the page cannot be
executed directly in CI. Instead, viz/softrender.py mirrors the page's own
scene→pixels pipeline in numpy, and this file closes the loop in two
directions:

  1. every numeric constant the mirror relies on is asserted to be
     literally present in the exported HTML (so the page and the proof
     cannot drift apart silently), and
  2. frames rendered through the mirror from REAL exported pages are
     asserted pixel-level: geometry lands where the scene says, colors
     survive, and the depth test resolves occlusion the WebGL way.

Together these are the executable equivalent of "open the page and see the
scene" — proving the render loop of the reference's gl_viewer.cpp:145-207
is faithfully delivered by the export.
"""

import numpy as np
import pytest

from tpu3d_torch.viz.softrender import (
    PAGE_CLEAR,
    build_draws,
    camera_matrix,
    parse_scene_from_html,
    render,
    render_html,
)
from tpu3d_torch.viz.viewer import SceneViewer


def _export(tmp_path, build):
    v = SceneViewer(html_path=str(tmp_path / "scene.html"))
    build(v)
    return v.export_html(v.html_path)


def _nonbg_mask(img):
    bg = np.round(np.asarray(PAGE_CLEAR) * 255)
    return np.abs(img.astype(int) - bg).sum(-1) > 12


def test_page_constants_match_mirror(tmp_path):
    """Anchor every constant the software mirror hardcodes to the literal
    text of the exported page — if the page's camera, projection, clear or
    point-size code changes, this fails and the mirror must follow."""
    html = open(
        _export(tmp_path, lambda v: v.set_point_cloud("c", np.zeros((1, 3))))
    ).read()
    for literal in [
        "cam = {yaw:-0.5, pitch:0.5, dist:1.5, pan:[0,0]}",  # default camera
        "const AXLEN = 0.05",  # pose triad axis length
        "gl.uniform1f(locS,2.0)",  # gl_PointSize
        "Math.tan(Math.PI/8)",  # fov
        "zn=0.01, zf=100",  # clip planes
        "gl.clearColor(0.07,0.07,0.09,1)",  # clear color
        # Depth buffer must be CLEARED as well as enabled — clearing only
        # COLOR while DEPTH_TEST is on freezes the first frame's depth and
        # corrupts every frame after a camera move.
        "gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT)",
        "gl.enable(gl.DEPTH_TEST)",
        "gl_Position=mvp*vec4(p,1.0)",
        "gl.drawArrays(",
        "requestAnimationFrame(frame)",
    ]:
        assert literal in html, f"page lost its anchor literal: {literal!r}"


def test_build_draws_matches_page_rebuild(tmp_path):
    """Draw-list construction mirrors rebuild(): one points draw per cloud,
    a 6-vertex lines draw per pose, one strip for the path, and the orbit
    center is the mean over cloud points only."""

    def build(v):
        v.set_point_cloud("a", np.full((10, 3), 2.0))
        v.set_point_cloud("b", np.zeros((30, 3)))
        T = np.eye(4)
        T[:3, 3] = (9.0, 9.0, 9.0)  # far pose must not move the center
        v.set_pose("p", T)
        v.set_path([[0, 0, 0], [1, 1, 1], [2, 2, 2]])

    scene = parse_scene_from_html(open(_export(tmp_path, build)).read())
    draws, center = build_draws(scene)
    by_mode = {}
    for d in draws:
        by_mode.setdefault(d["mode"], []).append(d)
    assert sorted(len(d["pts"]) for d in by_mode["points"]) == [10, 30]
    assert len(by_mode["lines"]) == 1 and len(by_mode["lines"][0]["pts"]) == 6
    assert len(by_mode["strip"]) == 1 and len(by_mode["strip"][0]["pts"]) == 3
    np.testing.assert_allclose(center, np.full(3, 2.0 * 10 / 40), atol=1e-6)
    # Pose axis endpoints: origin + AXLEN * column.
    lines = by_mode["lines"][0]["pts"]
    np.testing.assert_allclose(lines[0], [9, 9, 9], atol=1e-6)
    np.testing.assert_allclose(lines[1], [9.05, 9, 9], atol=1e-6)


def test_camera_looks_at_center():
    """The orbit camera targets the cloud center: the center must project
    to the exact middle of the viewport for ANY yaw/pitch/dist."""
    center = np.array([0.3, -0.2, 1.1], np.float32)
    for yaw, pitch, dist in [(-0.5, 0.5, 1.5), (2.0, -1.0, 0.4), (0, 0, 3)]:
        cam = {"yaw": yaw, "pitch": pitch, "dist": dist, "pan": [0.0, 0.0]}
        M = camera_matrix(center, cam, aspect=4 / 3)
        clip = M @ np.append(center, 1.0)
        ndc = clip[:3] / clip[3]
        np.testing.assert_allclose(ndc[:2], 0.0, atol=1e-6)
        assert -1 <= ndc[2] <= 1


def test_rendered_frame_shows_scene(tmp_path):
    """End to end: exported page → parsed scene → rendered frame. The cloud
    must cover real pixels with its own colors; triad and path colors must
    survive to the framebuffer."""
    rng = np.random.default_rng(7)

    def build(v):
        # 0.15 keeps the whole cloud inside the default-camera frustum, so
        # the exact point-count assertion below is meaningful.
        pts = rng.normal(size=(1500, 3)).astype(np.float32) * 0.15
        v.set_point_cloud("obj", pts, colors=np.full((1500, 3), [0.9, 0.1, 0.1]))
        T = np.eye(4)
        T[:3, 3] = (0.0, 0.5, 0.0)
        v.set_pose("grasp", T)
        v.set_path([[0, 0, 0], [0.3, 0.3, 0.0]])

    img, stats = render_html(_export(tmp_path, build), width=320, height=240)
    assert stats["points"] == 1500  # every cloud vertex passed the clip test
    assert stats["lines"] == 6 and stats["strip"] == 2
    mask = _nonbg_mask(img)
    assert mask.mean() > 0.01, "scene drew almost nothing"
    # Cloud color dominates the drawn pixels (red channel high, green low).
    drawn = img[mask].astype(int)
    red = (drawn[:, 0] > 150) & (drawn[:, 1] < 80)
    assert red.mean() > 0.5
    # Path color (yellow) present somewhere.
    yellow = (drawn[:, 0] > 180) & (drawn[:, 1] > 180) & (drawn[:, 2] < 120)
    assert yellow.any()
    # Pose triad: its green axis color [0.2,1,0.2] present.
    green = (drawn[:, 1] > 200) & (drawn[:, 0] < 120) & (drawn[:, 2] < 120)
    assert green.any()


def test_depth_test_resolves_occlusion(tmp_path):
    """Two points on the same view ray: the near one must win every pixel.
    This exercises the page's DEPTH_TEST + full depth-buffer clear."""

    def build(v):
        # cam yaw=0,pitch=0 looks down -z; the mirror renders with the
        # page's persisted-camera override below.
        v.set_point_cloud(
            "near", np.array([[0.0, 0.0, 0.0]]), colors=[[1.0, 0.0, 0.0]]
        )
        v.set_point_cloud(
            "far", np.array([[0.0, 0.0, -0.5]]), colors=[[0.0, 0.0, 1.0]]
        )

    scene = parse_scene_from_html(open(_export(tmp_path, build)).read())
    cam = {"yaw": 0.0, "pitch": 0.0, "dist": 1.5, "pan": [0.0, 0.0]}
    img, stats = render(scene, width=160, height=120, cam=cam)
    mask = _nonbg_mask(img)
    assert mask.any()
    drawn = img[mask]
    # Every drawn pixel is the NEAR (red) point; blue lost the depth test.
    assert (drawn[:, 0] > 200).all() and (drawn[:, 2] < 60).all()
    # Draw order reversed must give the same framebuffer (depth, not order).
    scene2 = {
        "version": scene["version"],
        "clouds": dict(reversed(list(scene["clouds"].items()))),
        "poses": {},
        "path": [],
    }
    img2, _ = render(scene2, width=160, height=120, cam=cam)
    np.testing.assert_array_equal(img, img2)


def test_live_sidecar_scene_renders_identically(tmp_path):
    """The page's fetch-poll swaps SCENE for the sidecar JSON and calls
    rebuild(): rendering the sidecar must equal rendering the embedded
    scene — i.e. a live update draws exactly what a fresh export would."""
    import json

    rng = np.random.default_rng(3)
    v = SceneViewer(html_path=str(tmp_path / "scene.html"))
    v.set_point_cloud("s", rng.normal(size=(200, 3)).astype(np.float32))
    html_path = v.export_html(v.html_path)
    sidecar = v.export_scene_json(v.json_path)
    img_embedded, _ = render_html(html_path, width=160, height=120)
    img_sidecar, _ = render(
        json.load(open(sidecar)), width=160, height=120
    )
    np.testing.assert_array_equal(img_embedded, img_sidecar)
