"""Interactive scene editor over the port's `Renderer`.

Counterpart of `directcomputeraytracing_tpu.tools.editor` (the reference
renderer's ImGui editor, Source/ImGui.cpp:124-700: settings panel, scene
browser, inspector, fly camera): a stdlib HTTP server on the loopback
address whose page shows a progressively refined preview and posts
edits. Every edit goes through the renderer's `set_*` methods
(`scene.edit`). State lives in one `EditorSession`; the HTTP layer is a
thin JSON codec around it, so tests drive the session directly.

The renderer's camera is tensors on its device: `state` reads host
copies, and camera moves write new `CameraParams` fields on the
renderer's device.

Run:  python -m directcomputeraytracing_tpu_torch.tools.editor scene.xml \\
          --device cuda
Then open http://localhost:8008/.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import threading
import zlib

import numpy as np
import torch

__all__ = ["EditorSession", "serve", "main"]


def _png_bytes(img01):
    """Encode a (H, W, 3) float [0, 1] image as PNG bytes (in memory, no
    PIL on the serving path)."""
    a = np.clip(np.asarray(img01) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    h, w, _ = a.shape
    raw = b"".join(b"\x00" + a[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


class EditorSession:
    """One editable render session: a Renderer and the source Scene's
    names, with the editor's operations as methods. The preview
    accumulates between edits and restarts on any edit (the reference's
    film dirty flag, Scene.cpp:672-807). renderer_kwargs pass to
    `Renderer` (`device` defaults to "cuda")."""

    def __init__(self, scene, camera, width=960, height=540,
                 preview_scale=3, **renderer_kwargs):
        from ..integrator.renderer import Renderer

        self.scene = scene
        self.renderer = Renderer(scene, camera, width=width,
                                 height=height, **renderer_kwargs)
        self.preview_scale = preview_scale
        self._spp = 0
        self._acc = None
        self._lock = threading.Lock()

    # ---- state for the browser (the scene browser panel) ----
    def state(self):
        sc, r = self.scene, self.renderer
        cam_tf = r.camera.transform.cpu().numpy()
        return {
            "resolution": [r.cfg.width, r.cfg.height],
            "spp": self._spp,
            "max_bounce": r.cfg.max_bounce,
            "triangles": int(sum(len(m.indices) for m in sc.meshes)),
            "materials": [
                {"index": i, "name": m.name or f"material {i}",
                 "type": int(m.mtype),
                 "albedo": [float(x) for x in m.albedo],
                 "roughness": float(m.roughness),
                 "ior": [float(x) for x in np.atleast_1d(
                     np.asarray(m.ior, np.float32))][:3],
                 "opacity": float(m.opacity)}
                for i, m in enumerate(sc.materials)],
            "lights": [
                {"index": i, "kind": li.kind,
                 "radiance": [float(x) for x in li.radiance],
                 "position": [float(x) for x in li.position]}
                for i, li in enumerate(sc.lights)],
            "emitters": [
                {"instance": i, "name": inst.name or f"instance {i}",
                 "radiance": [float(x) for x in inst.radiance]}
                for i, inst in enumerate(sc.instances)
                if inst.is_emitter],
            "instances": [
                {"index": i, "name": inst.name or f"instance {i}",
                 "mesh": inst.mesh,
                 "material_override": int(inst.material_override)}
                for i, inst in enumerate(sc.instances)],
            "camera": {
                "position": [float(x) for x in cam_tf[3, :3]],
                "forward": [float(x) for x in cam_tf[2, :3]],
                "fov_x_deg": float(np.degrees(2.0 * np.arctan2(
                    0.5 * float(r.camera.film_size[0]),
                    float(r.camera.film_distance)))),
            },
        }

    # ---- edits (the inspector panel's writes) ----
    def edit_material(self, index, **fields):
        with self._lock:
            self.renderer.set_material(index, **fields)
            m = self.scene.materials[index]
            for k, v in fields.items():
                if v is not None and hasattr(m, k):
                    setattr(m, k, tuple(v) if isinstance(v, list) else v)
            self._reset()

    def edit_light(self, index, radiance=None, position=None):
        with self._lock:
            self.renderer.set_light(index, radiance=radiance,
                                    position=position)
            li = self.scene.lights[index]
            if radiance is not None:
                li.radiance = tuple(radiance)
            if position is not None:
                li.position = tuple(position)
            self._reset()

    def edit_emitter(self, instance, radiance):
        with self._lock:
            self.renderer.set_emitter_radiance(instance, radiance)
            self.scene.instances[instance].radiance = tuple(radiance)
            self._reset()

    def edit_instance_override(self, index, material_override):
        with self._lock:
            self.renderer.set_instance_override(index, material_override)
            self.scene.instances[index].material_override = \
                material_override
            self._reset()

    # ---- fly camera (the reference's Camera.cpp WASD and drag) ----
    def _with_transform(self, cam, tf):
        return cam._replace(transform=torch.from_numpy(
            np.asarray(tf, np.float32)).to(self.renderer.device))

    def move_camera(self, forward=0.0, right=0.0, up=0.0,
                    yaw_deg=0.0, pitch_deg=0.0):
        """Translate along the camera basis and yaw or pitch it (the
        reference's fly camera integrates WASD the same way)."""
        from ..camera.camera import look_at_transform

        with self._lock:
            cam = self.renderer.camera
            tf = cam.transform.cpu().numpy().astype(np.float64)
            eye = tf[3, :3] + (forward * tf[2, :3] + right * tf[0, :3]
                               + up * tf[1, :3])
            fwd = tf[2, :3]
            if yaw_deg:
                a = np.radians(yaw_deg)
                c, s = np.cos(a), np.sin(a)
                rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
                fwd = fwd @ rot
            if pitch_deg:
                a = np.radians(pitch_deg)
                right_ax = tf[0, :3]
                c, s = np.cos(a), np.sin(a)
                fwd = (c * fwd + s * np.cross(right_ax, fwd) * -1.0)
            self.renderer.camera = self._with_transform(
                cam, look_at_transform(eye, eye + fwd))
            self._reset()

    def set_camera(self, eye=None, target=None, fov_x_deg=None):
        from ..camera.camera import look_at_transform

        with self._lock:
            cam = self.renderer.camera
            if eye is not None or target is not None:
                tf = cam.transform.cpu().numpy()
                cur_eye = tf[3, :3]
                e = np.asarray(eye if eye is not None else cur_eye,
                               np.float64)
                t = np.asarray(target if target is not None
                               else cur_eye + tf[2, :3], np.float64)
                cam = self._with_transform(cam, look_at_transform(e, t))
            if fov_x_deg is not None:
                fs = float(cam.film_size[0])
                fd = 0.5 * fs / max(
                    np.tan(np.radians(fov_x_deg) * 0.5), 1e-4)
                cam = cam._replace(film_distance=torch.tensor(
                    fd, dtype=torch.float32, device=self.renderer.device))
            self.renderer.camera = cam
            self._reset()

    def set_settings(self, max_bounce=None):
        """Settings-panel edits that rebuild the RenderConfig (the
        reference flips a shader define and recompiles)."""
        with self._lock:
            r = self.renderer
            if max_bounce is not None:
                r.cfg = dataclasses.replace(r.cfg,
                                            max_bounce=int(max_bounce))
            self._reset()

    def _reset(self):
        self.renderer.reset()
        self._spp = 0
        self._acc = None

    # ---- progressive preview ----
    def preview_step(self, spp=1):
        """Accumulate `spp` more preview samples; returns the running
        average (H/s, W/s, 3) in [0, 1] after a gamma-2.2 display map."""
        with self._lock:
            img = self.renderer.preview(spp=spp,
                                        scale=self.preview_scale)
            if self._acc is None:
                self._acc = img * spp
            else:
                self._acc = self._acc + img * spp
            self._spp += spp
            lin = self._acc / self._spp
            return np.power(np.clip(lin, 0.0, 1.0), 1.0 / 2.2)

    def preview_png(self, spp=1):
        return _png_bytes(self.preview_step(spp))

    def save_image(self, path):
        """Full-size postprocessed still (the reference's 'Save Image to
        File' button, ImGui.cpp:182-186); 4 spp if none were rendered.
        `postprocessed` is display-ready sRGB, so no transfer is applied
        again."""
        from ..utils.image import save_image

        with self._lock:
            r = self.renderer
            if r.spp == 0:
                r.render(spp=4)
            save_image(path, r.postprocessed(), srgb=False)
            return {"path": path, "spp": r.spp}


_PAGE = """<!doctype html><meta charset="utf-8">
<title>dcrt-tpu editor</title>
<style>
body{font:13px system-ui;margin:0;display:flex;background:#16181d;color:#d7dae0}
#side{width:360px;padding:12px;overflow-y:auto;height:100vh;box-sizing:border-box}
#main{flex:1;display:flex;align-items:center;justify-content:center}
img{image-rendering:pixelated;max-width:100%;border:1px solid #333}
h3{margin:14px 0 4px;font-size:12px;text-transform:uppercase;color:#8fa0b8}
label{display:inline-block;width:86px;color:#9aa3af}
input{width:54px;background:#21242b;color:#e6e9ef;border:1px solid #3a3f4a;margin:1px}
button{background:#2a2f3a;color:#e6e9ef;border:1px solid #444;margin:2px;padding:3px 8px;cursor:pointer}
.row{margin:2px 0}
</style>
<div id=side>
  <h3>camera <span id=spp></span></h3>
  <div class=row>
    <button onclick="mv(0.5,0,0)">fwd</button><button onclick="mv(-0.5,0,0)">back</button>
    <button onclick="mv(0,-0.5,0)">left</button><button onclick="mv(0,0.5,0)">right</button>
    <button onclick="mv(0,0,0.5)">up</button><button onclick="mv(0,0,-0.5)">down</button>
  </div>
  <div class=row>
    <button onclick="rot(-10,0)">yaw-</button><button onclick="rot(10,0)">yaw+</button>
    <button onclick="rot(0,-5)">pitch-</button><button onclick="rot(0,5)">pitch+</button>
  </div>
  <div id=panels></div>
</div>
<div id=main><img id=view></div>
<script>
let busy=false;
async function refresh(){
  if(busy)return; busy=true;
  try{
    const r=await fetch('/preview?spp=1&t='+Date.now());
    const b=await r.blob();
    document.getElementById('view').src=URL.createObjectURL(b);
  }finally{busy=false;}
}
async function state(){
  const s=await (await fetch('/state')).json();
  document.getElementById('spp').textContent=' · '+s.spp+' spp · '+s.triangles+' tris';
  let h='';
  h+='<h3>materials</h3>';
  for(const m of s.materials){
    h+=`<div class=row><label>${m.name}</label>`;
    for(let c=0;c<3;c++)
      h+=`<input type=number step=0.05 min=0 max=1 value=${m.albedo[c].toFixed(2)}
          onchange="editMat(${m.index},'albedo',this.parentNode)">`;
    h+=`<input type=number step=0.05 min=0 max=1 value=${m.roughness.toFixed(2)}
        title=roughness onchange="editMatR(${m.index},this.value)"></div>`;
  }
  h+='<h3>lights</h3>';
  for(const l of s.lights){
    h+=`<div class=row><label>${l.kind} ${l.index}</label>`;
    for(let c=0;c<3;c++)
      h+=`<input type=number step=0.5 min=0 value=${l.radiance[c]}
          onchange="editLight(${l.index},this.parentNode)">`;
    h+='</div>';
  }
  for(const e of s.emitters){
    h+=`<div class=row><label>${e.name}</label>`;
    for(let c=0;c<3;c++)
      h+=`<input type=number step=0.5 min=0 value=${e.radiance[c]}
          onchange="editEmitter(${e.instance},this.parentNode)">`;
    h+='</div>';
  }
  document.getElementById('panels').innerHTML=h;
}
function vals(p){return [...p.querySelectorAll('input')].map(i=>+i.value);}
async function post(u,b){await fetch(u,{method:'POST',body:JSON.stringify(b)});await state();}
function editMat(i,f,p){post('/edit',{kind:'material',index:i,fields:{albedo:vals(p).slice(0,3)}});}
function editMatR(i,v){post('/edit',{kind:'material',index:i,fields:{roughness:+v}});}
function editLight(i,p){post('/edit',{kind:'light',index:i,radiance:vals(p).slice(0,3)});}
function editEmitter(i,p){post('/edit',{kind:'emitter',instance:i,radiance:vals(p).slice(0,3)});}
function mv(f,r,u){post('/camera',{forward:f,right:r,up:u});}
function rot(y,p){post('/camera',{yaw_deg:y,pitch_deg:p});}
state();setInterval(refresh,900);
</script>"""


def serve(session, port=8008, host="127.0.0.1", started=None):
    """Serve the editor page until interrupted. `started` (optional
    threading.Event) is set once the socket is bound, with the server as
    its `server` attribute (tests use it to shut the server down)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path.startswith("/state"):
                self._send(200, json.dumps(session.state()).encode())
            elif self.path.startswith("/preview"):
                spp = 1
                if "spp=" in self.path:
                    spp = int(self.path.split("spp=")[1].split("&")[0])
                self._send(200, session.preview_png(spp), "image/png")
            else:
                self._send(200, _PAGE.encode(), "text/html")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(n) or b"{}")
            try:
                if self.path.startswith("/edit"):
                    kind = body.pop("kind")
                    if kind == "material":
                        session.edit_material(body["index"],
                                              **body.get("fields", {}))
                    elif kind == "light":
                        session.edit_light(
                            body["index"],
                            radiance=body.get("radiance"),
                            position=body.get("position"))
                    elif kind == "emitter":
                        session.edit_emitter(body["instance"],
                                             body["radiance"])
                    elif kind == "override":
                        session.edit_instance_override(
                            body["index"], body["material_override"])
                elif self.path.startswith("/camera"):
                    if "eye" in body or "target" in body or \
                            "fov_x_deg" in body:
                        session.set_camera(**body)
                    else:
                        session.move_camera(**body)
                elif self.path.startswith("/settings"):
                    session.set_settings(**body)
                elif self.path.startswith("/save"):
                    out = session.save_image(body.get("path",
                                                      "editor_save.png"))
                    self._send(200, json.dumps(out).encode())
                    return
                self._send(200, b'{"ok": true}')
            except Exception as e:   # the page shows the error
                self._send(400, json.dumps({"error": repr(e)}).encode())

    httpd = ThreadingHTTPServer((host, port), Handler)
    if started is not None:
        started.server = httpd
        started.set()
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def build_parser():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scene", help="Mitsuba XML scene path")
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--preview-scale", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda; the "
                         "CPU runs the kernels' plain twins)")
    return ap


def main(argv=None):
    from ..cli.render import _device
    from ..scene.xml_loader import load_mitsuba_xml

    args = build_parser().parse_args(argv)
    device = _device(args.device)
    scene, settings = load_mitsuba_xml(args.scene)
    session = EditorSession(scene, settings.camera, width=args.width,
                            height=args.height,
                            preview_scale=args.preview_scale,
                            device=device)
    print(f"editor: http://localhost:{args.port}/", flush=True)
    serve(session, port=args.port)


if __name__ == "__main__":
    main()
