"""Interactive progressive viewer.

The analog of the reference's winit window + imgui overlay
(src/lib.rs:23-69, src/core/imgui.rs): a matplotlib window displays the
progressive accumulation while keyboard/mouse drive the same fly-camera
controller (camera.CameraController) and the same knob set the imgui panel
exposes (src/core/context.rs:230-258) — bounces, rays/pixel, skybox,
accumulate, scene switching 0-3. Any input clears the accumulation, exactly
like Context::input (src/core/context.rs:148-175).

Keys: W/A/S/D move, Space/Z up/down, arrow keys look, scroll zoom,
mouse-drag look, 0-3 switch built-in scene, B/b bounces +/-, R/r rays per
pixel +/-, F/f focus distance +/- (imgui slider 0..10, context.rs:254),
V/v aperture +/- (slider -2..2, context.rs:255), K toggle skybox,
C toggle accumulate, P save PNG, Q quit. The title bar mirrors the imgui
overlay's readout (frame time, frame, camera position/look-at —
context.rs:235-249).

Headless environments: raises RuntimeError early if no GUI backend works —
use the CLI `render` command instead.
"""

from __future__ import annotations

import time

import numpy as np

from .camera import CameraController, update_camera
from .io.image import to_uint8
from .renderer import Renderer
from .scene import SCENE_IDS, builtin_scene
from .utils.config import RenderParams


class Viewer:
    """Progressive interactive viewer around a Renderer.

    ``widgets=True`` (default) adds an on-screen control panel — the
    visual counterpart of the reference's imgui slider/checkbox tree
    (src/core/context.rs:230-258): sliders for bounces, rays/pixel,
    focus distance and aperture, checkboxes for skybox/accumulate/
    denoise, and a scene radio group. Panel callbacks drive the exact
    same state transitions as the key bindings.
    """

    def __init__(self, scene, camera, params: RenderParams, scene_id=None,
                 widgets: bool = True):
        import matplotlib
        import matplotlib.pyplot as plt

        self.plt = plt
        self.renderer = Renderer(scene, camera, params)
        self.controller = CameraController()
        self.scene_id = scene_id
        self.denoise = 0          # à-trous iterations on the display path
        self._drag_origin = None
        self._running = True
        self._dt = 1.0 / 30.0
        from .utils.metrics import FrameClock
        self.clock = FrameClock()

        pw = params.width / 100
        self.fig = plt.figure(
            figsize=(pw * (1.45 if widgets else 1.0), params.height / 100))
        # image fills the left region; the right strip hosts the panel
        self.ax = self.fig.add_axes((0.0, 0.0, 0.69 if widgets else 1.0, 1.0))
        self.ax.set_axis_off()
        self.im = None
        self._widgets = {}
        if widgets:
            self._build_widgets()
        self.fig.canvas.mpl_connect("key_press_event", self._on_key)
        self.fig.canvas.mpl_connect("scroll_event", self._on_scroll)
        self.fig.canvas.mpl_connect("button_press_event", self._on_press)
        self.fig.canvas.mpl_connect("button_release_event", self._on_release)
        self.fig.canvas.mpl_connect("motion_notify_event", self._on_motion)
        self.fig.canvas.mpl_connect("close_event", lambda e: self._stop())
        self.fig.canvas.mpl_connect("resize_event", self._on_resize)

    # -- widget panel (imgui tree analog, context.rs:230-258) -------------

    def _build_widgets(self):
        """On-screen sliders/checkboxes/radio — same knob set and ranges as
        the imgui widget tree (context.rs:250-258), same state transitions
        as the key bindings. One-way (panel → renderer): the key bindings
        remain authoritative and don't echo back into the widgets."""
        from matplotlib.widgets import CheckButtons, RadioButtons, Slider

        p = self.renderer.params
        cam = self.renderer.camera
        x, w = 0.78, 0.17

        def slider_ax(i):
            return self.fig.add_axes((x, 0.92 - i * 0.07, w, 0.04))

        s_bounce = Slider(slider_ax(0), "bounces", 0, 8,
                          valinit=p.bounces, valstep=1)
        s_rpp = Slider(slider_ax(1), "rays/px", 1, 8,
                       valinit=p.rays_per_pixel, valstep=1)
        # imgui slider ranges: focus 0..10, aperture -2..2 (context.rs:254-255)
        s_focus = Slider(slider_ax(2), "focus", 0.0, 10.0,
                         valinit=float(cam.focus_dist))
        s_apert = Slider(slider_ax(3), "aperture", -2.0, 2.0,
                         valinit=float(cam.aperture))

        s_bounce.on_changed(lambda v: self.renderer.set_params(
            self.renderer.params.replace(bounces=int(v))))
        s_rpp.on_changed(lambda v: self.renderer.set_params(
            self.renderer.params.replace(rays_per_pixel=int(v))))
        s_focus.on_changed(lambda v: self.renderer.set_camera(
            self.renderer.camera.replace(focus_dist=float(v))))
        s_apert.on_changed(lambda v: self.renderer.set_camera(
            self.renderer.camera.replace(aperture=float(v))))

        checks_ax = self.fig.add_axes((x, 0.42, w, 0.2))
        checks_ax.set_axis_off()
        checks = CheckButtons(checks_ax, ["skybox", "accumulate", "denoise"],
                              [p.skybox, p.accumulate, bool(self.denoise)])

        def on_check(label):
            pp = self.renderer.params
            if label == "skybox":
                self.renderer.set_params(pp.replace(skybox=not pp.skybox))
            elif label == "accumulate":
                self.renderer.set_params(
                    pp.replace(accumulate=not pp.accumulate))
            else:
                self.denoise = 0 if self.denoise else 3
        checks.on_clicked(on_check)

        radio_ax = self.fig.add_axes((x, 0.1, w, 0.26))
        radio_ax.set_title("scene", fontsize=7)
        radio_ax.set_axis_off()
        names = [SCENE_IDS[i] for i in sorted(SCENE_IDS)]
        radio = RadioButtons(
            radio_ax, names,
            active=self.scene_id if self.scene_id is not None else 0)

        def on_scene(label):
            sid = names.index(label)
            scene, cam2 = builtin_scene(
                sid, aspect=self.renderer.params.aspect)
            self.renderer.set_scene(scene)
            self.renderer.set_camera(cam2)
            self.scene_id = sid
        radio.on_clicked(on_scene)

        # keep references alive (matplotlib widgets are GC'd otherwise)
        self._widgets = {"bounces": s_bounce, "rpp": s_rpp, "focus": s_focus,
                         "aperture": s_apert, "checks": checks,
                         "scene": radio}

    # -- input routing (Context::input analog, context.rs:148-175) --------

    def _apply_camera(self):
        cam = update_camera(self.renderer.camera, self.controller, self._dt)
        for a in ("amount_forward", "amount_backward", "amount_left",
                  "amount_right", "amount_up", "amount_down"):
            setattr(self.controller, a, 0.0)
        self.renderer.set_camera(cam)  # clears accumulation

    def _on_key(self, event):
        k = (event.key or "").lower()
        moved = self.controller.press(
            {"z": "shift", " ": "space"}.get(k, k), True)
        if moved:
            self._apply_camera()
            return
        p = self.renderer.params
        if k in "0123":
            scene, cam = builtin_scene(int(k), aspect=p.aspect)
            self.renderer.set_scene(scene)
            self.renderer.set_camera(cam)
            self.scene_id = int(k)
        elif k == "b":
            delta = 1 if event.key == "B" else -1
            self.renderer.set_params(p.replace(bounces=max(0, p.bounces + delta)))
        elif k == "r":
            delta = 1 if event.key == "R" else -1
            self.renderer.set_params(
                p.replace(rays_per_pixel=max(1, p.rays_per_pixel + delta)))
        elif k == "f":
            # imgui "Focus distance" slider range 0..10 (context.rs:254)
            delta = 0.25 if event.key == "F" else -0.25
            cam = self.renderer.camera
            self.renderer.set_camera(cam.replace(
                focus_dist=min(10.0, max(0.0, cam.focus_dist + delta))))
        elif k == "v":
            # imgui "Aperture" slider range -2..2 (context.rs:255)
            delta = 0.1 if event.key == "V" else -0.1
            cam = self.renderer.camera
            self.renderer.set_camera(cam.replace(
                aperture=min(2.0, max(-2.0, cam.aperture + delta))))
        elif k == "k":
            self.renderer.set_params(p.replace(skybox=not p.skybox))
        elif k == "c":
            self.renderer.set_params(p.replace(accumulate=not p.accumulate))
        elif k == "n":
            # denoise toggle (extension): à-trous filter on the display
            # path only — the accumulation buffer stays untouched
            self.denoise = 0 if self.denoise else 3
        elif k == "p":
            fname = f"frame_{int(time.time())}.png"
            from .io.image import write_png
            write_png(fname, self.renderer.image)
            print(f"saved {fname}")
        elif k == "q":
            self._stop()

    def _on_scroll(self, event):
        # matplotlib only reports wheel *steps* (lines); the reference's
        # LineDelta scale of 10000 (camera.rs:237) teleports the camera, so
        # steps are mapped through the PixelDelta path at ~25 px per step
        # (deviation D16)
        self.controller.scroll_pixel_delta(event.step * 25.0)
        self._apply_camera()

    def _on_press(self, event):
        self._drag_origin = (event.x, event.y)

    def _on_release(self, event):
        self._drag_origin = None

    def _on_motion(self, event):
        if self._drag_origin is None:
            return
        dx = (event.x - self._drag_origin[0]) * 0.02
        dy = (event.y - self._drag_origin[1]) * 0.02
        self._drag_origin = (event.x, event.y)
        self.controller.mouse(dx, dy)
        self._apply_camera()

    def _stop(self):
        self._running = False

    def _status_line(self, dt: float) -> str:
        """The imgui overlay readout (context.rs:235-249): frame time
        (instant + windowed mean/fps via FrameClock), frame counter,
        camera position and look-at, plus the knob state."""
        cam = self.renderer.camera
        pos = ", ".join(f"{x:.2f}" for x in cam.origin)
        look = ", ".join(f"{x:.2f}" for x in cam.look_at)
        sid = self.scene_id if self.scene_id is not None else "-"
        return (f"frame {self.renderer.frames}  {dt*1e3:.0f} ms "
                f"(avg {self.clock.mean_ms:.0f}, {self.clock.fps:.1f} fps)"
                f"  scene {sid}\npos ({pos})  look ({look})  "
                f"focus {cam.focus_dist:.2f}  aperture {cam.aperture:.2f}")

    def resize(self, width: int, height: int):
        """Resolution change (Context::resize analog, context.rs:126-142):
        new params + accumulation reset; XLA recompiles for the new shape."""
        self.renderer.set_params(
            self.renderer.params.replace(width=width, height=height))
        self.im = None  # force imshow rebuild at the new extent

    def _on_resize(self, event):
        """Window-drag resize → render-resolution change (lib.rs:40-45).
        Target resolution comes from the AXES bounding box (the region the
        image is actually displayed in), not the full canvas — the canvas
        includes the title/margin area, which would systematically
        over-render. Quantized to multiples of 16 and no-op'd when
        unchanged: every distinct size is a (cached) recompile, and
        matplotlib fires resize_event on some ordinary draws too."""
        try:
            bbox = self.ax.get_window_extent()
            ew, eh = bbox.width, bbox.height
        except Exception:  # backend without a realized renderer yet
            ew, eh = event.width, event.height
        w = max(64, int(ew) // 16 * 16)
        h = max(64, int(eh) // 16 * 16)
        p = self.renderer.params
        if (w, h) != (p.width, p.height):
            self.resize(w, h)

    # -- frame loop (run() analog, src/lib.rs:23-69) -----------------------

    def run(self, max_frames=None):
        self.plt.ion()
        self.fig.show()
        n = 0
        while self._running and (max_frames is None or n < max_frames):
            t0 = time.time()
            img = self.renderer.step()
            if self.denoise:
                from .denoise import denoise_render
                from .renderer import camera_basis
                img = denoise_render(
                    self.renderer.scene, camera_basis(self.renderer.camera),
                    self.renderer.params, img, iterations=self.denoise)
            rgb = to_uint8(np.asarray(img))
            if self.im is None:
                self.im = self.ax.imshow(rgb)
            else:
                self.im.set_data(rgb)
            dt = time.time() - t0
            self._dt = max(dt, 1e-3)
            self.clock.record(dt)
            self.ax.set_title(self._status_line(dt), fontsize=7)
            self.fig.canvas.draw_idle()
            self.fig.canvas.flush_events()
            n += 1
        self.plt.ioff()


def view(scene, camera, params: RenderParams, scene_id=None, max_frames=None):
    """Open an interactive viewer window. Raises if no GUI is available."""
    import matplotlib
    if matplotlib.get_backend().lower() in ("agg", "pdf", "svg", "ps"):
        raise RuntimeError(
            "no interactive matplotlib backend available (headless?); "
            "use `python -m ray_tracer render` instead")
    v = Viewer(scene, camera, params, scene_id=scene_id)
    v.run(max_frames=max_frames)
    return v
