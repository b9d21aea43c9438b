"""Scene viewer — capability parity with the reference's OpenGL viewer.

The reference GLViewer (src/gl_viewer.cpp, include/gl_viewer.hpp:22-29)
offers: a render thread owning the GL context; a thread-safe scene store of
named point clouds, named pose triads and one path; orbit camera (left-drag
rotate with pitch clamped ±89°, middle-drag pan, scroll zoom); and the
window is LIVE — worker threads push clouds/poses and the render loop
repaints (gl_viewer.cpp:145-207). A compute host is headless, so the same
capability is delivered as:

  - the identical thread-safe scene store + dirty-flag API
    (``set_point_cloud`` / ``set_pose`` / ``set_path`` / ``clear``);
  - ``export_html``: a self-contained interactive WebGL viewer (vanilla JS,
    zero external deps/egress) with the same orbit controls, which TRACKS
    the running pipeline: a watcher thread re-writes a ``scene.json``
    sidecar whenever the scene mutates, and the page fetch-polls it (1 Hz)
    and rebuilds its buffers in place. Where ``fetch`` is unavailable
    (plain file:// in some browsers) the page falls back to self-reloading
    with the camera persisted in localStorage — either way an open tab
    shows the live scene with no user action;
  - ``serve``: an optional zero-dependency localhost HTTP server for the
    full fetch-poll experience;
  - ``export_png``: a static matplotlib snapshot for CI artifacts.

``start``/``stop``/``is_running`` keep the pipeline's viewer lifecycle
(pipeline.cpp:296-316, 374-379) intact.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

import numpy as np

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>tpu3d viewer</title>
<style>html,body{margin:0;height:100%;background:#111;overflow:hidden}
canvas{width:100%;height:100%;display:block}
#hud{position:fixed;top:8px;left:8px;color:#9a9;font:12px monospace}</style>
</head><body>
<canvas id="c"></canvas><div id="hud"></div>
<script>
let SCENE = __SCENE_JSON__;
const JSON_NAME = __JSON_NAME__;
const canvas = document.getElementById('c');
const gl = canvas.getContext('webgl');
const vs = `attribute vec3 p;attribute vec3 col;uniform mat4 mvp;
uniform float ps;varying vec3 vc;
void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=ps;vc=col;}`;
const fs = `precision mediump float;varying vec3 vc;
void main(){gl_FragColor=vec4(vc,1.0);}`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
gl.compileShader(o);return o;}
const prog = gl.createProgram();
gl.attachShader(prog, sh(gl.VERTEX_SHADER, vs));
gl.attachShader(prog, sh(gl.FRAGMENT_SHADER, fs));
gl.linkProgram(prog); gl.useProgram(prog);
const locP = gl.getAttribLocation(prog,'p');
const locC = gl.getAttribLocation(prog,'col');
const locM = gl.getUniformLocation(prog,'mvp');
const locS = gl.getUniformLocation(prog,'ps');
function buf(arr){const b=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b);
gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(arr),gl.STATIC_DRAW);return b;}
let draws = [];
let center=[0,0,0];
function rebuild(){
  for(const d of draws){gl.deleteBuffer(d.pb);gl.deleteBuffer(d.cb);}
  draws = []; center=[0,0,0]; let n=0;
  for (const [name, cl] of Object.entries(SCENE.clouds)) {
    draws.push({pb:buf(cl.points), cb:buf(cl.colors),
                n:cl.points.length/3, mode:'points'});
    for(let i=0;i<cl.points.length;i+=3){center[0]+=cl.points[i];
      center[1]+=cl.points[i+1];center[2]+=cl.points[i+2];n++;}
  }
  if(n>0){center=center.map(v=>v/n);}
  const AXLEN = 0.05;
  for (const [name, T] of Object.entries(SCENE.poses)) {
    const o=[T[3],T[7],T[11]]; const pts=[]; const cols=[];
    for(let a=0;a<3;a++){const d=[T[a],T[4+a],T[8+a]];
      pts.push(o[0],o[1],o[2],o[0]+AXLEN*d[0],o[1]+AXLEN*d[1],o[2]+AXLEN*d[2]);
      const c=[[1,.2,.2],[.2,1,.2],[.3,.4,1]][a];
      cols.push(...c,...c);}
    draws.push({pb:buf(pts),cb:buf(cols),n:6,mode:'lines'});
  }
  if (SCENE.path.length>1){
    const pts=[].concat(...SCENE.path); const cols=[];
    for(let i=0;i<SCENE.path.length;i++)cols.push(1,1,0.2);
    draws.push({pb:buf(pts),cb:buf(cols),n:SCENE.path.length,mode:'strip'});
  }
}
rebuild();
// Camera state persists across reloads (the fetch-less fallback reloads).
let cam = {yaw:-0.5, pitch:0.5, dist:1.5, pan:[0,0]};
try{const s=localStorage.getItem('tpu3d_cam');if(s)cam=JSON.parse(s);}catch(e){}
function saveCam(){try{localStorage.setItem('tpu3d_cam',
  JSON.stringify(cam));}catch(e){}}
let drag=null;
canvas.addEventListener('mousedown',e=>{drag={b:e.button,x:e.clientX,y:e.clientY};});
window.addEventListener('mouseup',()=>drag=null);
window.addEventListener('mousemove',e=>{
  if(!drag)return; const dx=e.clientX-drag.x, dy=e.clientY-drag.y;
  drag.x=e.clientX; drag.y=e.clientY;
  if(drag.b===0){cam.yaw+=dx*0.01;cam.pitch+=dy*0.01;
    cam.pitch=Math.max(-1.553,Math.min(1.553,cam.pitch));}
  else {cam.pan[0]+=dx*0.002*cam.dist; cam.pan[1]-=dy*0.002*cam.dist;}
  saveCam();});
canvas.addEventListener('wheel',e=>{cam.dist*=Math.exp(e.deltaY*0.001);
  cam.dist=Math.max(0.1,cam.dist);saveCam();e.preventDefault();});
canvas.addEventListener('contextmenu',e=>e.preventDefault());
function mat(){
  const yaw=cam.yaw, pitch=cam.pitch, dist=cam.dist, pan=cam.pan;
  const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
  const eye=[center[0]+dist*cp*sy+pan[0], center[1]+dist*sp+pan[1],
             center[2]+dist*cp*cy];
  const tgt=[center[0]+pan[0],center[1]+pan[1],center[2]];
  let f=[tgt[0]-eye[0],tgt[1]-eye[1],tgt[2]-eye[2]];
  const fl=Math.hypot(...f); f=f.map(v=>v/fl);
  const up0=[0,1,0];
  let r=[f[1]*up0[2]-f[2]*up0[1], f[2]*up0[0]-f[0]*up0[2], f[0]*up0[1]-f[1]*up0[0]];
  const rl=Math.hypot(...r)||1; r=r.map(v=>v/rl);
  const u=[r[1]*f[2]-r[2]*f[1], r[2]*f[0]-r[0]*f[2], r[0]*f[1]-r[1]*f[0]];
  const V=[r[0],u[0],-f[0],0, r[1],u[1],-f[1],0, r[2],u[2],-f[2],0,
    -(r[0]*eye[0]+r[1]*eye[1]+r[2]*eye[2]),
    -(u[0]*eye[0]+u[1]*eye[1]+u[2]*eye[2]),
    (f[0]*eye[0]+f[1]*eye[1]+f[2]*eye[2]),1];
  const a=canvas.width/canvas.height, fv=Math.tan(Math.PI/8), zn=0.01, zf=100;
  const P=[1/(a*fv),0,0,0, 0,1/fv,0,0, 0,0,-(zf+zn)/(zf-zn),-1,
           0,0,-2*zf*zn/(zf-zn),0];
  const M=new Array(16).fill(0);
  for(let i=0;i<4;i++)for(let j=0;j<4;j++)for(let k=0;k<4;k++)
    M[j*4+i]+=P[k*4+i]*V[j*4+k];
  return M;
}
let live = 'static';
// Live tracking: poll the scene.json sidecar the pipeline watcher
// re-writes (gl_viewer.cpp:145-207 live-window parity). Where fetch is
// unavailable (file:// origin), fall back to reloading the page — the
// camera survives via localStorage.
let reloadArmed = false;
async function poll(){
  try {
    const r = await fetch(JSON_NAME + '?t=' + Date.now(),
                          {cache:'no-store'});
    if (r.ok) {
      const s = await r.json();
      if (s.version !== SCENE.version) { SCENE = s; rebuild(); }
      live = 'live v' + SCENE.version;
      return;
    }
  } catch(e) {}
  if (!reloadArmed && location.protocol === 'file:') {
    reloadArmed = true; live = 'reload-poll';
    setInterval(()=>{saveCam(); location.reload();}, 3000);
  }
}
setInterval(poll, 1000); poll();
function frame(){
  canvas.width=canvas.clientWidth; canvas.height=canvas.clientHeight;
  gl.viewport(0,0,canvas.width,canvas.height);
  gl.clearColor(0.07,0.07,0.09,1);
  gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  gl.enable(gl.DEPTH_TEST);
  const M=mat();
  for(const d of draws){
    gl.bindBuffer(gl.ARRAY_BUFFER,d.pb);
    gl.enableVertexAttribArray(locP);
    gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
    gl.bindBuffer(gl.ARRAY_BUFFER,d.cb);
    gl.enableVertexAttribArray(locC);
    gl.vertexAttribPointer(locC,3,gl.FLOAT,false,0,0);
    gl.uniformMatrix4fv(locM,false,new Float32Array(M));
    gl.uniform1f(locS,2.0);
    gl.drawArrays(d.mode==='points'?gl.POINTS:
                  d.mode==='lines'?gl.LINES:gl.LINE_STRIP,0,d.n);
  }
  document.getElementById('hud').textContent =
    Object.keys(SCENE.clouds).join(' ') + '  [' + live + ']' +
    '  |  drag: rotate, right-drag: pan, wheel: zoom';
  requestAnimationFrame(frame);
}
frame();
</script></body></html>
"""


class SceneViewer:
    def __init__(self, html_path: str = "tpu3d_scene.html", max_points: int = 200000):
        self._lock = threading.Lock()
        self._clouds: Dict[str, dict] = {}
        self._poses: Dict[str, np.ndarray] = {}
        self._path: List[List[float]] = []
        self._dirty = False
        self._version = 0  # bumped on every mutation; the page polls it
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._server = None
        self.html_path = html_path
        self.max_points = max_points

    @property
    def json_path(self) -> str:
        base, _ = os.path.splitext(self.html_path)
        return base + ".json"

    # -- lifecycle (gl_viewer.hpp:22-24) ------------------------------------
    def start(self):
        if self._running:
            return
        self._running = True
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def stop(self):
        self._running = False
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._server is not None:
            self._server.shutdown()
            self._server = None

    def is_running(self) -> bool:
        return self._running

    def serve(self, port: int = 0) -> int:
        """Serve the viewer directory over localhost HTTP (zero deps) so
        the page's fetch-poll works from any browser. Returns the bound
        port. Optional — file:// viewing works too (reload fallback)."""
        import functools
        from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

        directory = os.path.dirname(os.path.abspath(self.html_path)) or "."
        handler = functools.partial(
            SimpleHTTPRequestHandler, directory=directory
        )
        self._server = ThreadingHTTPServer(("127.0.0.1", port), handler)
        threading.Thread(
            target=self._server.serve_forever, daemon=True
        ).start()
        bound = self._server.server_address[1]
        print(
            f"tpu3d viewer: http://127.0.0.1:{bound}/"
            f"{os.path.basename(self.html_path)}"
        )
        return bound

    def _watch(self):
        while not self._stop_evt.wait(0.5):
            with self._lock:
                dirty = self._dirty
                self._dirty = False
            if dirty:
                try:
                    self.export_scene_json(self.json_path)
                    self.export_html(self.html_path)
                except Exception as e:
                    print(f"Viewer export failed: {e}")

    # -- scene store (gl_viewer.hpp:26-29) ----------------------------------
    def set_point_cloud(self, name: str, points, colors=None):
        points = np.asarray(points, np.float32).reshape(-1, 3)
        if len(points) > self.max_points:
            step = -(-len(points) // self.max_points)
            points = points[::step]
            colors = None if colors is None else np.asarray(colors)[::step]
        if colors is None:
            colors = np.full_like(points, 0.8)
        with self._lock:
            self._clouds[name] = {
                "points": points,
                "colors": np.asarray(colors, np.float32).reshape(-1, 3),
            }
            self._dirty = True
            self._version += 1

    def set_pose(self, name: str, T: np.ndarray):
        with self._lock:
            self._poses[name] = np.asarray(T, np.float32).reshape(4, 4)
            self._dirty = True
            self._version += 1

    def set_path(self, positions):
        with self._lock:
            self._path = [list(map(float, p)) for p in positions]
            self._dirty = True
            self._version += 1

    def clear(self):
        with self._lock:
            self._clouds.clear()
            self._poses.clear()
            self._path = []
            self._dirty = True
            self._version += 1

    # -- exports --------------------------------------------------------------
    def _scene_json(self) -> str:
        with self._lock:
            scene = {
                "version": self._version,
                "clouds": {
                    k: {
                        "points": np.round(v["points"], 5).ravel().tolist(),
                        "colors": np.round(v["colors"], 3).ravel().tolist(),
                    }
                    for k, v in self._clouds.items()
                },
                "poses": {k: v.ravel().tolist() for k, v in self._poses.items()},
                "path": self._path,
            }
        return json.dumps(scene)

    def export_scene_json(self, path: str) -> str:
        """Write the scene sidecar the live page polls. Atomic (tmp+rename)
        so a mid-write poll never sees a torn file. The tmp name is unique
        per writer: the watcher thread and direct callers may export
        concurrently, and a shared tmp lets one rename the other's file
        away mid-write (observed as FileNotFoundError on os.replace)."""
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            f.write(self._scene_json())
        os.replace(tmp, path)
        return path

    def export_html(self, path: str) -> str:
        html = _HTML_TEMPLATE.replace(
            "__SCENE_JSON__", self._scene_json()
        ).replace(
            "__JSON_NAME__", json.dumps(os.path.basename(self.json_path))
        )
        with open(path, "w") as f:
            f.write(html)
        return path

    def export_png(self, path: str) -> Optional[str]:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return None
        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(projection="3d")
        with self._lock:
            for name, cl in self._clouds.items():
                p, c = cl["points"], np.clip(cl["colors"], 0, 1)
                step = max(1, len(p) // 20000)
                ax.scatter(
                    p[::step, 0], p[::step, 1], p[::step, 2],
                    c=c[::step], s=1, label=name,
                )
            for name, T in self._poses.items():
                o = T[:3, 3]
                for a, col in enumerate(["r", "g", "b"]):
                    d = T[:3, a] * 0.05
                    ax.plot([o[0], o[0] + d[0]], [o[1], o[1] + d[1]],
                            [o[2], o[2] + d[2]], col)
            if len(self._path) > 1:
                pp = np.asarray(self._path)
                ax.plot(pp[:, 0], pp[:, 1], pp[:, 2], "y-")
        ax.set_xlabel("x"), ax.set_ylabel("y"), ax.set_zlabel("z")
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path
