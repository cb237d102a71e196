"""PCLVisualizer-equivalent API surface over the headless HTML backend.

The reference's interactive window (pcl::visualization::PCLVisualizer,
reference: visualization/include/pcl/visualization/pcl_visualizer.h:93) is
a VTK render loop plus three registries: named cloud/shape actors with
per-actor rendering properties, camera state, and user callbacks
(keyboard / mouse / point-picking / area-picking — pcl_visualizer.h
registerKeyboardCallback etc., events in visualization/keyboard_event.h,
point_picking_event.h). Compute hosts are headless, so this class keeps the
SAME API surface and state machine but renders to self-contained
interactive HTML (``spin``/``spin_once`` write a viewer file whose
JavaScript raises the same events: key presses and point picks are
captured in-browser and exportable as JSON), and events can be fed back
into the registered Python callbacks with ``dispatch_events`` — the
headless analog of the VTK interactor loop, so callback-driven pipelines
(the reference's app idiom) run unchanged in tests and batch jobs.

Counterpart of ``pcl_tpu/visualization/visualizer.py``: a copy of its numpy
code; actors hold the port's clouds, read back to the host when a frame is
rendered, and the viewer files are the JAX package's byte for byte.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from pcl_tpu_torch.core.cloud import Cloud, from_numpy, to_numpy


# ---------------------------------------------------------------- events

@dataclass(frozen=True)
class KeyboardEvent:
    """reference: visualization/include/pcl/visualization/keyboard_event.h"""
    key_sym: str
    key_down: bool = True
    alt: bool = False
    ctrl: bool = False
    shift: bool = False

    def get_key_sym(self) -> str:
        return self.key_sym

    def key_up(self) -> bool:
        return not self.key_down


@dataclass(frozen=True)
class PointPickingEvent:
    """reference: point_picking_event.h — index + coordinates."""
    index: int
    x: float
    y: float
    z: float

    def get_point_index(self) -> int:
        return self.index

    def get_point(self) -> Tuple[float, float, float]:
        return (self.x, self.y, self.z)


@dataclass(frozen=True)
class MouseEvent:
    """reference: mouse_event.h (subset: button press/release + position)."""
    type: str            # 'press' | 'release' | 'move'
    button: str          # 'left' | 'middle' | 'right'
    x: int
    y: int


# ---------------------------------------------------------------- actors

@dataclass
class _CloudActor:
    cloud: Cloud
    color: Optional[Tuple[float, float, float]] = None   # None = rgb/z ramp
    point_size: float = 2.0
    opacity: float = 1.0


@dataclass
class _ShapeActor:
    kind: str
    points: np.ndarray            # polyline/point samples [M,3]
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)


class Visualizer:
    """Named-actor registry + handler registry + HTML render loop.

    API parity (reference pcl_visualizer.h):
    add_point_cloud/update_point_cloud/remove_point_cloud,
    add_sphere/add_line/add_cube/add_text3d/remove_shape,
    set_point_cloud_rendering_properties, set_background_color,
    add_coordinate_system, set_camera_position,
    register_keyboard_callback/register_point_picking_callback/
    register_mouse_callback, spin/spin_once, close, was_stopped.
    """

    def __init__(self, window_name: str = "pcl_tpu viewer"):
        self.window_name = window_name
        self._clouds: Dict[str, _CloudActor] = {}
        self._shapes: Dict[str, _ShapeActor] = {}
        self._kb_cbs: List[Callable[[KeyboardEvent], None]] = []
        self._pick_cbs: List[Callable[[PointPickingEvent], None]] = []
        self._mouse_cbs: List[Callable[[MouseEvent], None]] = []
        self._bg = (0.07, 0.07, 0.07)
        self._camera: Optional[Tuple[float, ...]] = None
        self._stopped = False
        self._frames = 0

    # -------------------------------------------------- cloud registry
    def add_point_cloud(self, cloud: Cloud, cloud_id: str = "cloud") -> bool:
        if cloud_id in self._clouds:
            return False
        self._clouds[cloud_id] = _CloudActor(cloud=cloud)
        return True

    def update_point_cloud(self, cloud: Cloud, cloud_id: str = "cloud") -> bool:
        if cloud_id not in self._clouds:
            return False
        self._clouds[cloud_id].cloud = cloud
        return True

    def remove_point_cloud(self, cloud_id: str = "cloud") -> bool:
        return self._clouds.pop(cloud_id, None) is not None

    def remove_all_point_clouds(self) -> None:
        self._clouds.clear()

    def contains(self, actor_id: str) -> bool:
        return actor_id in self._clouds or actor_id in self._shapes

    def set_point_cloud_rendering_properties(
            self, prop: str, value, cloud_id: str = "cloud") -> bool:
        """prop in {'point_size', 'opacity', 'color'} (the
        PCL_VISUALIZER_POINT_SIZE/OPACITY/COLOR properties)."""
        a = self._clouds.get(cloud_id)
        if a is None:
            return False
        if prop == "point_size":
            a.point_size = float(value)
        elif prop == "opacity":
            a.opacity = float(value)
        elif prop == "color":
            a.color = tuple(float(v) for v in value)
        else:
            raise ValueError(f"unknown rendering property {prop!r}")
        return True

    # -------------------------------------------------- shape registry
    def add_sphere(self, center, radius: float, shape_id: str = "sphere",
                   color=(1.0, 1.0, 1.0), n: int = 128) -> bool:
        if shape_id in self._shapes:
            return False
        rng = np.random.default_rng(0)
        v = rng.normal(size=(n, 3))
        v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
        pts = np.asarray(center, np.float32)[None, :] + radius * v
        self._shapes[shape_id] = _ShapeActor("sphere", pts.astype(np.float32),
                                             tuple(color))
        return True

    def add_line(self, p0, p1, shape_id: str = "line",
                 color=(1.0, 1.0, 1.0), n: int = 64) -> bool:
        if shape_id in self._shapes:
            return False
        t = np.linspace(0.0, 1.0, n, dtype=np.float32)[:, None]
        pts = (1 - t) * np.asarray(p0, np.float32) + t * np.asarray(p1, np.float32)
        self._shapes[shape_id] = _ShapeActor("line", pts, tuple(color))
        return True

    def add_cube(self, lo, hi, shape_id: str = "cube",
                 color=(1.0, 1.0, 1.0), n_edge: int = 16) -> bool:
        if shape_id in self._shapes:
            return False
        lo = np.asarray(lo, np.float32)
        hi = np.asarray(hi, np.float32)
        corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
                           np.float32)
        edges = [(0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 7), (5, 1),
                 (5, 4), (5, 7), (6, 2), (6, 4), (6, 7)]
        t = np.linspace(0.0, 1.0, n_edge, dtype=np.float32)[:, None]
        pts = np.concatenate([(1 - t) * corners[a] + t * corners[b]
                              for a, b in edges])
        self._shapes[shape_id] = _ShapeActor("cube", pts, tuple(color))
        return True

    def add_text3d(self, text: str, position, shape_id: str = "text",
                   color=(1.0, 1.0, 1.0)) -> bool:
        # headless: the anchor point is rendered; the text itself goes into
        # the HTML overlay info line
        if shape_id in self._shapes:
            return False
        pts = np.asarray(position, np.float32)[None, :]
        actor = _ShapeActor("text", pts, tuple(color))
        actor.text = text  # type: ignore[attr-defined]
        self._shapes[shape_id] = actor
        return True

    def remove_shape(self, shape_id: str) -> bool:
        return self._shapes.pop(shape_id, None) is not None

    def add_coordinate_system(self, scale: float = 1.0,
                              origin=(0.0, 0.0, 0.0)) -> None:
        o = np.asarray(origin, np.float32)
        self.add_line(o, o + [scale, 0, 0], "_axis_x", color=(1, 0, 0))
        self.add_line(o, o + [0, scale, 0], "_axis_y", color=(0, 1, 0))
        self.add_line(o, o + [0, 0, scale], "_axis_z", color=(0, 0, 1))

    # -------------------------------------------------- camera / window
    def set_background_color(self, r: float, g: float, b: float) -> None:
        self._bg = (r, g, b)

    def set_camera_position(self, pos, focal, up=(0.0, 0.0, 1.0)) -> None:
        self._camera = tuple(map(float, (*pos, *focal, *up)))

    def was_stopped(self) -> bool:
        return self._stopped

    def close(self) -> None:
        self._stopped = True

    # -------------------------------------------------- handler registry
    def register_keyboard_callback(
            self, cb: Callable[[KeyboardEvent], None]) -> Callable[[], None]:
        self._kb_cbs.append(cb)
        return lambda: self._kb_cbs.remove(cb)

    def register_point_picking_callback(
            self, cb: Callable[[PointPickingEvent], None]) -> Callable[[], None]:
        self._pick_cbs.append(cb)
        return lambda: self._pick_cbs.remove(cb)

    def register_mouse_callback(
            self, cb: Callable[[MouseEvent], None]) -> Callable[[], None]:
        self._mouse_cbs.append(cb)
        return lambda: self._mouse_cbs.remove(cb)

    # -------------------------------------------------- event dispatch
    def dispatch_events(self, events) -> int:
        """Feed events into the registered callbacks — the headless stand-in
        for the VTK interactor. ``events`` is a list of dicts (or a path to
        a JSON file exported from the HTML viewer's event log):
        {"type": "key", "key": "r", "down": true} |
        {"type": "pick", "index": 17, "x":..,"y":..,"z":..} |
        {"type": "mouse", "event": "press", "button": "left", "x":..,"y":..}
        Returns the number of events delivered."""
        if isinstance(events, str):
            with open(events) as f:
                events = json.load(f)
        n = 0
        for e in events:
            t = e.get("type")
            if t == "key":
                ev = KeyboardEvent(e["key"], e.get("down", True),
                                   e.get("alt", False), e.get("ctrl", False),
                                   e.get("shift", False))
                for cb in list(self._kb_cbs):
                    cb(ev)
                if e["key"] in ("q", "Q", "Escape") and e.get("down", True):
                    self._stopped = True
                n += 1
            elif t == "pick":
                ev2 = PointPickingEvent(int(e["index"]), float(e["x"]),
                                        float(e["y"]), float(e["z"]))
                for cb2 in list(self._pick_cbs):
                    cb2(ev2)
                n += 1
            elif t == "mouse":
                ev3 = MouseEvent(e.get("event", "press"),
                                 e.get("button", "left"),
                                 int(e.get("x", 0)), int(e.get("y", 0)))
                for cb3 in list(self._mouse_cbs):
                    cb3(ev3)
                n += 1
        return n

    # -------------------------------------------------- rendering
    def _flatten(self):
        pts, cols, sizes = [], [], []
        info = [self.window_name]
        for cid, a in self._clouds.items():
            xyz, attrs = to_numpy(a.cloud, compact=True)
            c = np.empty((len(xyz), 3), np.float32)
            if a.color is not None:
                c[:] = a.color
            elif "rgb" in attrs:
                c[:] = attrs["rgb"]
            else:
                z = xyz[:, 2]
                t = (z - z.min()) / max(z.max() - z.min(), 1e-9)
                c[:, 0] = t
                c[:, 1] = 0.5
                c[:, 2] = 1.0 - t
            pts.append(xyz)
            cols.append(c * a.opacity)
            sizes.append(np.full(len(xyz), a.point_size, np.float32))
            info.append(f"{cid}:{len(xyz)}")
        for sid, s in self._shapes.items():
            pts.append(s.points)
            cols.append(np.tile(np.asarray(s.color, np.float32),
                                (len(s.points), 1)))
            sizes.append(np.full(len(s.points), 3.0, np.float32))
            if s.kind == "text":
                info.append(f"{sid}='{getattr(s, 'text', '')}'")
        if not pts:
            return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                    np.zeros((0,), np.float32), " ".join(info))
        return (np.concatenate(pts), np.concatenate(cols),
                np.concatenate(sizes), " ".join(info))

    def spin_once(self, path: Optional[str] = None) -> Optional[str]:
        """Render one frame. With ``path``, writes the interactive HTML
        viewer (point picking + key capture + event-log export built in)
        and returns the path; without, returns an ASCII snapshot string."""
        self._frames += 1
        xyz, cols, _sizes, info = self._flatten()
        if path is None:
            from pcl_tpu_torch.visualization.export import render_ascii
            return render_ascii(from_numpy(xyz, device="cpu")) if len(xyz) else ""
        from pcl_tpu_torch.visualization.export import cloud_to_html
        cloud = from_numpy(xyz, attrs={"rgb": cols} if len(xyz) else None, device="cpu")
        cloud_to_html(path, cloud, title=info + " — click: pick point, "
                      "keys logged; press E to export event JSON")
        self._inject_event_capture(path)
        return path

    def spin(self, path: Optional[str] = None) -> Optional[str]:
        return self.spin_once(path)

    def save_screenshot(self, path: str) -> None:
        """ASCII z-buffer snapshot (the headless screenshot analog)."""
        snap = self.spin_once(None)
        with open(path, "w") as f:
            f.write(snap or "")

    @staticmethod
    def _event_capture_js() -> str:
        return """
<script>
// pcl_tpu event capture: the interactive analog of PCLVisualizer's
// keyboard/point-picking callbacks. Events accumulate in EVENTS; press E
// to download them as JSON for Visualizer.dispatch_events().
const EVENTS=[];
window.addEventListener('keydown',e=>{
 EVENTS.push({type:'key',key:e.key,down:true,alt:e.altKey,ctrl:e.ctrlKey,shift:e.shiftKey});
 if(e.key==='E'||e.key==='e'){
  const blob=new Blob([JSON.stringify(EVENTS)],{type:'application/json'});
  const a=document.createElement('a');a.href=URL.createObjectURL(blob);
  a.download='pcl_tpu_events.json';a.click();}});
document.getElementById('c').addEventListener('dblclick',ev=>{
 // nearest projected point = the point pick (PointPickingEvent analog)
 const rect=ev.target.getBoundingClientRect();
 const mx=ev.clientX-rect.left,my=ev.clientY-rect.top;
 // project all points with the current mvp (mat() from the viewer script)
 const m=mat();let best=-1,bd=25;  // 5px pick tolerance
 for(let i=0;i<N;i++){
  const x=xyz[3*i],y=xyz[3*i+1],z=xyz[3*i+2];
  const w=m[3]*x+m[7]*y+m[11]*z+m[15];
  if(w<=0)continue;
  const sx=(m[0]*x+m[4]*y+m[8]*z+m[12])/w,sy=(m[1]*x+m[5]*y+m[9]*z+m[13])/w;
  const px=(sx*0.5+0.5)*ev.target.width,py=(1-(sy*0.5+0.5))*ev.target.height;
  const d=(px-mx)*(px-mx)+(py-my)*(py-my);
  if(d<bd){bd=d;best=i;}}
 if(best>=0){
  EVENTS.push({type:'pick',index:best,x:xyz[3*best],y:xyz[3*best+1],z:xyz[3*best+2]});
  document.getElementById('info').textContent='picked #'+best;}});
['mousedown','mouseup'].forEach(t=>document.getElementById('c')
 .addEventListener(t,e=>EVENTS.push({type:'mouse',
  event:t==='mousedown'?'press':'release',
  button:['left','middle','right'][e.button]||'left',x:e.clientX,y:e.clientY})));
</script>"""

    def _inject_event_capture(self, path: str) -> None:
        with open(path) as f:
            html = f.read()
        html = html.replace("</body></html>",
                            self._event_capture_js() + "</body></html>")
        with open(path, "w") as f:
            f.write(html)
