"""Viewer tests on the Agg (headless) backend: key routing, knob keys,
status readout, resize — the imgui-panel analog (context.rs:230-258)."""

import types

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg", force=True)

import ray_tracer as rt
from ray_tracer.viewer import Viewer, view


PARAMS = rt.RenderParams(width=16, height=16, bounces=1, backend="jnp",
                         skybox=True)


def make_viewer():
    scene, cam = rt.builtin_scene("metal", aspect=1.0)
    return Viewer(scene, cam, PARAMS, scene_id=3)


def key(k):
    return types.SimpleNamespace(key=k)


def test_view_raises_headless():
    scene, cam = rt.builtin_scene("metal", aspect=1.0)
    with pytest.raises(RuntimeError):
        view(scene, cam, PARAMS)


def test_bounces_and_rpp_keys():
    v = make_viewer()
    v._on_key(key("B"))
    assert v.renderer.params.bounces == 2
    v._on_key(key("b"))
    v._on_key(key("b"))
    assert v.renderer.params.bounces == 0
    v._on_key(key("b"))
    assert v.renderer.params.bounces == 0  # clamped
    v._on_key(key("R"))
    assert v.renderer.params.rays_per_pixel == 2


def test_focus_and_aperture_keys():
    """Runtime focus-distance / aperture controls (imgui sliders at
    context.rs:254-255); clamped to the sliders' ranges."""
    v = make_viewer()
    f0 = v.renderer.camera.focus_dist
    v._on_key(key("F"))
    assert v.renderer.camera.focus_dist == pytest.approx(f0 + 0.25)
    assert v.renderer.frames == -1  # accumulation cleared
    v._on_key(key("V"))
    assert v.renderer.camera.aperture == pytest.approx(0.1)
    for _ in range(50):
        v._on_key(key("v"))
    assert v.renderer.camera.aperture == pytest.approx(-2.0)  # slider min
    for _ in range(60):
        v._on_key(key("f"))
    assert v.renderer.camera.focus_dist == 0.0  # slider min


def test_movement_key_clears_accumulation():
    v = make_viewer()
    v.renderer.step()
    v.renderer.step()
    assert v.renderer.frames >= 1
    v._on_key(key("w"))
    assert v.renderer.frames == -1


def test_scene_switch_keys():
    v = make_viewer()
    v._on_key(key("0"))
    assert v.scene_id == 0
    assert v.renderer.scene.num_spheres >= 6  # balls scene


def test_toggles_and_scroll():
    v = make_viewer()
    assert v.renderer.params.skybox
    v._on_key(key("k"))
    assert not v.renderer.params.skybox
    v._on_key(key("c"))
    assert not v.renderer.params.accumulate
    o0 = np.asarray(v.renderer.camera.origin)
    v._on_scroll(types.SimpleNamespace(step=1.0))
    assert not np.allclose(np.asarray(v.renderer.camera.origin), o0)


def test_status_line_has_camera_readout():
    """Camera position/look-at readout (context.rs:243-249)."""
    v = make_viewer()
    s = v._status_line(0.016)
    cam = v.renderer.camera
    assert f"{cam.origin[0]:.2f}" in s and "look (" in s
    assert "focus" in s and "aperture" in s


def test_resize():
    v = make_viewer()
    v.resize(24, 12)
    assert v.renderer.params.width == 24
    assert v.renderer.camera.aspect == pytest.approx(2.0)
    img = np.asarray(v.renderer.step())
    assert img.shape == (12, 24, 3)


def test_scroll_delta_paths():
    """Both reference scroll paths (camera.rs:235-244) exist verbatim."""
    from ray_tracer.camera import CameraController
    c = CameraController()
    c.scroll_line_delta(2.0)
    assert c.scroll == -20000.0
    c.scroll_pixel_delta(30.0)
    assert c.scroll == -30.0


def test_denoise_toggle():
    """'n' toggles display-path denoising without touching accumulation."""
    v = make_viewer()
    assert v.denoise == 0
    v._on_key(key("n"))
    assert v.denoise == 3
    frames_before = v.renderer.frames
    v.run(max_frames=1)   # one filtered frame draws fine
    assert v.renderer.frames == frames_before + 1
    v._on_key(key("n"))
    assert v.denoise == 0


def test_widget_panel_drives_state():
    """VERDICT r4 #7: the on-screen widget panel (imgui tree analog,
    context.rs:230-258) must drive the same state transitions as the key
    bindings — exercised headless via Agg by invoking the widget
    callbacks the way matplotlib would."""
    v = make_viewer()
    w = v._widgets
    assert set(w) == {"bounces", "rpp", "focus", "aperture", "checks",
                      "scene"}

    w["bounces"].set_val(4)
    assert v.renderer.params.bounces == 4
    w["rpp"].set_val(3)
    assert v.renderer.params.rays_per_pixel == 3

    v.renderer.step(); v.renderer.step()
    w["focus"].set_val(2.5)
    assert v.renderer.camera.focus_dist == pytest.approx(2.5)
    assert v.renderer.frames == -1  # accumulation cleared, like the keys
    w["aperture"].set_val(0.7)
    assert v.renderer.camera.aperture == pytest.approx(0.7)

    # CheckButtons: invoke the registered callback as a click would
    assert v.renderer.params.skybox
    w["checks"].set_active(0)          # fires on_clicked("skybox")
    assert not v.renderer.params.skybox
    w["checks"].set_active(1)
    assert not v.renderer.params.accumulate
    w["checks"].set_active(2)
    assert v.denoise == 3

    w["scene"].set_active(2)           # "room"
    assert v.scene_id == 2
    assert v.renderer.scene.num_tris >= 14  # room walls + light

    # a widgetless viewer still works (e.g. tiny screens)
    scene, cam = rt.builtin_scene("metal", aspect=1.0)
    v2 = Viewer(scene, cam, PARAMS, scene_id=3, widgets=False)
    assert v2._widgets == {}
