"""Minimal live viewer — the interactive-use analogue of the reference UI.

The reference's viewport is an ImGui pane: left-drag orbits the camera
(sensitivity 0.25 with cursor wrap-around, ``src/ui/main_window.cpp:
267-315``), the wheel zooms with the radius clamped to [0.1, 10]
(``main_window.cpp:317-324`` -> ``src/scene/camera.cpp:31-34``).  This
viewer reproduces those controls on a matplotlib window driving the same
render as the offline CLI (``method="auto"``: the K1 kernel on a CUDA
device).

    python -m volumetric_renderer_torch.apps.viewer head.nrrd --size 512x512
    python -m volumetric_renderer_torch.apps.viewer --synthetic --device cpu

Controls: left-drag = orbit, scroll = zoom, 'r' = reset camera,
'q'/close = quit.  The title bar shows the rays/s of the last frame
(the reference's FPS counter, ``src/application.cpp:102-122``).  The
window needs matplotlib; :class:`ViewerState` and :func:`make_frame_renderer`
need neither it nor a display.

Two details differ from the JAX package's viewer, which gets them wrong:
the wrap-around of a drag at the viewport's edges happens only where a
``warp_cursor`` hook moves the cursor (without one, the JAX viewer drops
the next real motion), and a press takes the same ``(x, -y)`` coordinates
as the motion that follows it (the JAX viewer takes ``(x, y)``, so the first
motion of every drag pitches by twice the cursor's height).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


class ViewerState:
    """Camera + renderer state machine, UI-toolkit-agnostic (testable
    headless: feed it synthetic drag/scroll events)."""

    def __init__(self, render_frame, camera, background=(0.11, 0.11, 0.11),
                 wrap_bounds=None, warp_cursor=None):
        self.render_frame = render_frame   # camera -> (H, W, 3) image
        self.camera = camera
        self._camera0 = camera
        self.background = background
        self.last_rays_per_s = 0.0
        self._drag_from = None
        # cursor wrap-around at viewport edges so a drag can orbit
        # indefinitely (main_window.cpp:267-315, SDL_WarpMouseInWindow):
        # wrap_bounds = ((min_x, min_y), (max_x, max_y)); warp_cursor is
        # the UI-toolkit hook that actually moves the OS cursor, and the
        # wrap happens only where there is one
        self.wrap_bounds = wrap_bounds
        self.warp_cursor = warp_cursor
        self._ignore_next = False  # "ignore mouse motion after warp"

    def frame(self):
        """Render the current camera; the image is on the host (a tensor
        is copied there, which waits for its device) when the time is
        taken."""
        t0 = time.perf_counter()
        rgb = self.render_frame(self.camera)
        if hasattr(rgb, "cpu"):
            rgb = rgb.cpu()
        dt = time.perf_counter() - t0
        self.last_rays_per_s = rgb.shape[0] * rgb.shape[1] / max(dt, 1e-9)
        return rgb

    # -- events (pixel coordinates, like SDL's) ---------------------------
    def press(self, x, y):
        self._drag_from = (x, y)

    def release(self):
        self._drag_from = None

    def drag(self, x, y):
        """Returns True when the camera changed (a re-render is due).

        Reproduces the reference's edge behavior
        (``main_window.cpp:267-315``): the rotation applies first, then a
        cursor that left the viewport warps to the opposite edge and the
        *next* motion event is ignored (its delta would be the warp jump).
        """
        if self._drag_from is None:
            return False
        if self._ignore_next:
            # "Ignore mouse motion after warp" + ResetMouseDragDelta
            self._ignore_next = False
            self._drag_from = (x, y)
            return False
        dx = x - self._drag_from[0]
        dy = y - self._drag_from[1]
        self._drag_from = (x, y)
        if dx == 0 and dy == 0:
            return False
        # OrbitCamera.rotate applies the reference's 0.25 drag sensitivity
        # itself (yaw about world Z, pitch about camera right,
        # camera.cpp:15-29)
        self.camera = self.camera.rotate((dx, dy))
        if self.wrap_bounds is not None and self.warp_cursor is not None:
            (min_x, min_y), (max_x, max_y) = self.wrap_bounds
            wx, wy = x, y
            if x < min_x or x > max_x:
                wx = max_x if x < min_x else min_x
            if y < min_y or y > max_y:
                wy = max_y if y < min_y else min_y
            if (wx, wy) != (x, y):
                self._drag_from = (wx, wy)
                self._ignore_next = True
                self.warp_cursor(wx, wy)
        return True

    def scroll(self, steps):
        # wheel up = zoom in = radius shrink (main_window.cpp:317-324)
        self.camera = self.camera.zoom(float(steps))
        return True

    def reset(self):
        self.camera = self._camera0
        return True


def make_frame_renderer(vol, tf, settings, *, density_min=None,
                        density_max=None, method: str = "auto",
                        background=(0.11, 0.11, 0.11)):
    """``camera -> (H, W, 3)`` float32 image in [0, 1] on ``vol``'s device:
    ``render`` composited over ``background``, without autograd."""
    import torch

    from volumetric_renderer_torch.render.api import composite_over, render

    def render_frame(camera):
        with torch.no_grad():
            rgba = render(vol, tf, camera, settings, density_min=density_min,
                          density_max=density_max, method=method)
            return torch.clamp(composite_over(rgba, background), 0.0, 1.0)

    return render_frame


def mpl_handlers(state: ViewerState, redraw, close):
    """The matplotlib event handlers of :func:`main`, by event name.
    matplotlib's y grows upward and the reference's drag is screen-space,
    so a press and the motions after it all take ``(ev.x, -ev.y)``."""

    def on_press(ev):
        if ev.button == 1 and ev.xdata is not None:
            state.press(ev.x, -ev.y)

    def on_release(ev):
        state.release()

    def on_move(ev):
        if state.drag(ev.x, -ev.y):
            redraw()

    def on_scroll(ev):
        state.scroll(ev.step)
        redraw()

    def on_key(ev):
        if ev.key == "r":
            state.reset()
            redraw()
        elif ev.key == "q":
            close()

    return {"button_press_event": on_press,
            "button_release_event": on_release,
            "motion_notify_event": on_move, "scroll_event": on_scroll,
            "key_press_event": on_key}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataset", nargs="*", help="NRRD / CSV slice files")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--size", default="512x512")
    ap.add_argument("--steps", type=int, default=360)
    ap.add_argument("--tf", default="preset:grayscale")
    ap.add_argument("--tf-resolution", type=int, default=256)
    ap.add_argument("--method", default="auto",
                    choices=["auto", "oracle", "fused", "kernel"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)

    import matplotlib.pyplot as plt
    import torch

    from volumetric_renderer_torch.apps.render_cli import load_tf, open_device
    from volumetric_renderer_torch.data.importer import import_volume
    from volumetric_renderer_torch.data.volume import Volume
    from volumetric_renderer_torch.scene.camera import OrbitCamera
    from volumetric_renderer_torch.utils.config import RenderSettings

    device = open_device(args.device)
    w, h = (int(v) for v in args.size.split("x"))
    if args.synthetic or not args.dataset:
        vol = Volume.synthetic_sphere(128)
    else:
        paths = args.dataset if len(args.dataset) > 1 else args.dataset[0]
        vol = import_volume(paths)
    tf = torch.as_tensor(load_tf(args.tf, args.tf_resolution), device=device)
    settings = RenderSettings(height=h, width=w,
                              step_size=1.8 / args.steps,
                              tf_resolution=args.tf_resolution)
    render_frame = make_frame_renderer(
        vol.as_torch(device), tf, settings, density_min=vol.vmin,
        density_max=vol.vmax, method=args.method)
    state = ViewerState(render_frame,
                        OrbitCamera.from_angles(yaw_deg=30.0,
                                                pitch_deg=20.0))

    fig, axim = plt.subplots(figsize=(w / 100, h / 100))
    axim.set_axis_off()
    im = axim.imshow(np.asarray(state.frame()))

    def redraw():
        im.set_data(np.asarray(state.frame()))
        fig.canvas.manager.set_window_title(
            f"volumetric_renderer_torch — {state.last_rays_per_s:,.0f} "
            "rays/s")
        fig.canvas.draw_idle()

    for event, handler in mpl_handlers(state, redraw,
                                       lambda: plt.close(fig)).items():
        fig.canvas.mpl_connect(event, handler)
    print("viewer: left-drag orbit, scroll zoom, r reset, q quit",
          file=sys.stderr)
    plt.show()


if __name__ == "__main__":
    main()
