"""Interactive camera controller.

Port of `opencl_path_tracer_tpu/runtime/controller.py`: the reference's
GLUT input layer (onKeyboard :1042, onKeyboardUp :1098, onMouse :1137,
onMouseMotion :1151, the movement in onIdle :1171-1224, the Camera
shift :334-336) without a window:

  W/S fly forward/back, A/D strafe, Q/Y up/down (1000 units/s,
  main.cpp:1189-1209), E/C zoom the fov (20 deg/s, slowing to 2 and 0.1
  at narrow fov, :1211-1224), a mouse drag looks around (0.2 deg/px,
  slowing with the fov, :1151-1163), '+'/'-' set the bounce depth in
  [1, max_iterations] (:1043-1054), 'r' toggles real time (:1067-1069),
  ESC quits (:1055-1058), space toggles full screen (:1059-1066).

Any movement or button event restarts the progressive accumulation
(current_sample = 0, main.cpp:1098-1148), here the `accumulation_reset`
flag that the engine consumes. The shift stays a float64 numpy array,
moved along the float32 basis of `core.geometry.rotate_x/rotate_y`, as
in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.config import RenderConfig
from opencl_path_tracer_tpu_torch.core.camera import Camera, make_camera
from opencl_path_tracer_tpu_torch.core.geometry import rotate_x, rotate_y
from opencl_path_tracer_tpu_torch.utils.device import resolve_device

MOVE_KEYS = ("w", "a", "s", "d", "q", "y", "e", "c")
SPEED = 1000.0  # units/sec (main.cpp:1189)


@dataclasses.dataclass
class ControllerState:
    fov: float
    yaw: float
    pitch: float
    shift: np.ndarray
    iterations: int
    real_time: bool = True
    accumulation_reset: bool = False
    quit_requested: bool = False
    fullscreen: bool = False


def _axis(x: float, y: float, z: float, pitch: float, yaw: float):
    """The unit axis (x, y, z) rotated by pitch then yaw, float32 numpy."""
    v = torch.tensor([x, y, z], dtype=torch.float32)
    return rotate_y(rotate_x(v, pitch), yaw).numpy()


class CameraController:
    """The pose and the interactive flags; `camera(w, h)` builds the
    device camera on `device` (CUDA unless "cpu" is asked for)."""

    def __init__(self, config: RenderConfig, device=None) -> None:
        self.cfg = config
        self.device = resolve_device(device)
        self.state = ControllerState(
            fov=config.camera.fov,
            yaw=config.camera.yaw,
            pitch=config.camera.pitch,
            shift=np.asarray(config.camera.shift, np.float64),
            iterations=config.iterations,
        )
        self._keys_down: set[str] = set()
        self._mouse_down = False
        self._last_xy: tuple[int, int] | None = None
        self._cam_key: tuple | None = None
        self._cam = None

    # --- input events ------------------------------------------------
    def key_down(self, key: str) -> None:
        key = key.lower()
        st = self.state
        if key == "+":
            if st.iterations < self.cfg.max_iterations:
                st.iterations += 1
                st.accumulation_reset = True
        elif key == "-":
            if st.iterations > 1:
                st.iterations -= 1
                st.accumulation_reset = True
        elif key == "r":
            st.real_time = not st.real_time
        elif key in ("escape", "esc", "\x1b"):
            # ESC closes the window and exits (main.cpp:1055-1058).
            st.quit_requested = True
        elif key in (" ", "space"):
            # Full screen (main.cpp:1059-1066): display only, no reset.
            st.fullscreen = not st.fullscreen
        elif key in MOVE_KEYS:
            self._keys_down.add(key)

    def key_up(self, key: str) -> None:
        key = key.lower()
        if key in MOVE_KEYS:
            self._keys_down.discard(key)
            self.state.accumulation_reset = True

    def mouse_button(self, down: bool, x: int = 0, y: int = 0) -> None:
        self._mouse_down = down
        self._last_xy = (x, y)
        self.state.accumulation_reset = True

    def mouse_motion(self, x: int, y: int) -> None:
        if self._last_xy is None:
            self._last_xy = (x, y)
            return
        dx = x - self._last_xy[0]
        dy = y - self._last_xy[1]
        st = self.state
        speed = 0.2
        if st.fov < 10:
            speed = 0.05
        if st.fov < 2:
            speed = 0.01
        st.yaw += dx * speed
        st.pitch += dy * speed
        self._last_xy = (x, y)

    # --- per-frame update ---------------------------------------------
    def update(self, dt: float) -> None:
        """Integrate the held keys over dt seconds (onIdle,
        main.cpp:1179-1224). A held key or button restarts the
        accumulation every frame (main.cpp:1179-1183)."""
        st = self.state
        keys = self._keys_down
        if keys or self._mouse_down:
            st.accumulation_reset = True

        forward = SPEED * dt * (("w" in keys) - ("s" in keys))
        rightward = SPEED * dt * (("d" in keys) - ("a" in keys))
        upward = SPEED * dt * (("q" in keys) - ("y" in keys))

        if "e" in keys:
            if st.fov > 10:
                st.fov -= 20 * dt
            elif st.fov > 0.1:
                st.fov -= 2 * dt
            else:
                st.fov = 0.1
        elif "c" in keys:
            if st.fov < 10:
                st.fov += 2 * dt
            elif st.fov < 90:
                st.fov += 20 * dt
            else:
                st.fov = 90.0

        if forward or rightward or upward:
            # The shift moves along the rotated basis (main.cpp:334-336).
            up = _axis(0.0, 1.0, 0.0, st.pitch, st.yaw)
            right = _axis(1.0, 0.0, 0.0, st.pitch, st.yaw)
            ahead = _axis(0.0, 0.0, 1.0, st.pitch, st.yaw)
            st.shift = (st.shift + ahead * forward + right * rightward
                        + up * upward)

    def consume_reset(self) -> bool:
        r = self.state.accumulation_reset
        self.state.accumulation_reset = False
        return r

    def camera(self, width: int, height: int) -> Camera:
        """The device camera of the current pose, memoised on the pose:
        an idle frame reuses the same tensors (`make_camera` is a dozen
        small host-to-device copies)."""
        st = self.state
        key = (width, height, st.fov, st.yaw, st.pitch,
               tuple(float(x) for x in st.shift))
        if key != self._cam_key:
            self._cam_key = key
            self._cam = make_camera(width, height, fov=st.fov, yaw=st.yaw,
                                    pitch=st.pitch, shift=key[5],
                                    device=self.device)
        return self._cam
