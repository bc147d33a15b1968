"""Render service + embedded web viewer (port of
`brush_tpu/viewer/service.py`).

The counterpart of the reference's egui viewer (SURVEY.md Appendix F
scopes this to "a render service + lightweight web client"): an HTTP server
that renders requested camera poses on the card and a self-contained
HTML/JS orbit-camera client. Loads .ply files, zips of plys (= animation
frames, alphanumerically sorted, brush-process/src/lib.rs:178-227), or live
training snapshots via a Slot. The HTML client and `/brush.js` are the JAX
package's, byte for byte.

A frame is `render` with `RenderConfig(forward_only=True)` on the
viewer's device, at the JAX viewer's fixed `isect_cap = 1 << 20`. As there,
nothing reads `num_isects` back: a pose that needs more remainder slots
than the cap (a million splats at 1920x1080 does) drops the slots past it
silently. `ThreadingHTTPServer` serves each request on a thread of its own;
`ViewerState.lock` serialises the renders. On the card with the kernel
path a frame is a replay of a CUDA graph (`graphs.RENDER_GRAPHS`, the
counterpart of the JAX viewer's jitted `_jitted_render`), captured at the
first frame of each size.

Stages (utils/tracing.py): a frame is a `viewer.frame` of unit the
`ViewerState`'s frame number, with device marks from before the fold to
after the host copy; inside it `viewer.lock` (the wait for the lock,
counted `viewer.lock_contended` where another render held it),
`viewer.fold` (the 3D filter floor and the scale), `viewer.camera` (the
pose and its upload) and `viewer.copy` (the uint8 frame to the host,
with device marks).
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import PurePosixPath
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from brush_tpu_torch.camera import Camera
from brush_tpu_torch.utils.device import resolve_device
from brush_tpu_torch.utils.tracing import count, stage
from brush_tpu_torch.viewer.slot import MessageBus, Slot

_CLIENT_HTML = """<!DOCTYPE html>
<html><head><title>brush_tpu viewer</title><style>
body{margin:0;background:#111;color:#ddd;font-family:monospace;overflow:hidden}
#hud{position:fixed;top:8px;left:8px;z-index:2;background:#0008;padding:6px}
#stats{position:fixed;top:8px;right:8px;z-index:2;background:#0008;
padding:6px;display:none}
#cmp{position:fixed;bottom:8px;left:8px;z-index:2;background:#0008;
padding:6px;display:none}
canvas.full{display:block}
</style></head><body>
<div id="hud">brush_tpu — drag orbit, wheel zoom, space play/pause,
N snap view, P points<br>
splat scale <input id="ss" type="range" min="-2" max="1" step="0.1" value="0">
fov <input id="fv" type="range" min="0.3" max="2.4" step="0.1" value="1">
bg <input id="bgc" type="color" value="#000000">
<span id="meta"></span></div>
<div id="stats"><canvas id="sc" width="240" height="136"></canvas>
<div id="sl"></div><div id="rl"></div></div>
<div id="cmp">view <span id="vn"></span> — GT wipe
<input id="wipe" type="range" min="0" max="1" step="0.01" value="0.5"></div>
<canvas id="c" class="full"></canvas>
<script>
const c=document.getElementById('c'),x=c.getContext('2d');
// Camera-pose URL params (CHANGELOG #309): #yaw=..&pitch=..&dist=..&frame=..
const hp=new URLSearchParams(location.hash.slice(1));
let yaw=+(hp.get('yaw')||0),pitch=+(hp.get('pitch')||0.3),
    dist=+(hp.get('dist')||5),frame=+(hp.get('frame')||0);
let drag=null,playing=false,nframes=1,busy=false;
let views=[],snap=null,points=false,cloud=null,cloudV=-1;
const losses=[],psnrs=[],splatsArr=[];let lastRefine=null;
const ss=document.getElementById('ss'),fv=document.getElementById('fv'),
      bgc=document.getElementById('bgc'),wipe=document.getElementById('wipe');
const hex2rgb=h=>[1,3,5].map(i=>parseInt(h.slice(i,i+2),16)/255).join(',');
function resize(){c.width=innerWidth;c.height=innerHeight}resize();
onresize=resize;
function saveHash(){history.replaceState(null,'',
 `#yaw=${yaw.toFixed(3)}&pitch=${pitch.toFixed(3)}&dist=${dist.toFixed(2)}&frame=${frame}`)}
c.onmousedown=e=>drag=[e.clientX,e.clientY];
onmouseup=()=>drag=null;
onmousemove=e=>{if(drag){snap=null;yaw+=(e.clientX-drag[0])*0.008;
pitch=Math.max(-1.5,Math.min(1.5,pitch+(e.clientY-drag[1])*0.008));
drag=[e.clientX,e.clientY];saveHash();}};
onwheel=e=>{snap=null;dist*=Math.exp(e.deltaY*0.001);saveHash()};
onkeydown=e=>{
  if(e.code==='Space')playing=!playing;
  if(e.code==='KeyP')points=!points;
  if(e.code==='KeyN')snapNearest();};
function camPos(){return snap?snap.position:
 [dist*Math.cos(pitch)*Math.sin(yaw),dist*Math.sin(pitch),
  -dist*Math.cos(pitch)*Math.cos(yaw)]}
function snapNearest(){
  // Nearest-dataset-view snapping (apps/brush-app scene.rs).
  if(!views.length)return;
  const p=camPos();let best=null,bd=1e30;
  views.forEach((v,i)=>{const d=(v.position[0]-p[0])**2+
    (v.position[1]-p[1])**2+(v.position[2]-p[2])**2;
    if(d<bd){bd=d;best=i}});
  snap={...views[best],idx:best};
  document.getElementById('vn').textContent=
    `${best} (${snap.name}, ${snap.split})`;
  document.getElementById('cmp').style.display='block';
  gtimg=null;
  fetch(`/gt?view=${best}&maxdim=640`).then(r=>r.blob())
    .then(createImageBitmap).then(b=>gtimg=b).catch(()=>{});}
let gtimg=null;
fetch('/info').then(r=>r.json()).then(i=>{nframes=i.n_frames||1;
document.getElementById('meta').textContent=
  ` | ${i.n_splats} splats, ${nframes} frame(s)`});
fetch('/views').then(r=>r.json()).then(v=>views=v).catch(()=>{});
// Live training telemetry: loss/PSNR sparklines (brush-rerun parity).
try{const es=new EventSource('/events');
es.onmessage=e=>{const m=JSON.parse(e.data);
  if(m.kind==='step'&&isFinite(m.loss)){losses.push(m.loss);
    if(losses.length>240)losses.shift();}
  if(m.kind==='eval'&&isFinite(m.psnr)){psnrs.push(m.psnr);
    if(psnrs.length>240)psnrs.shift();}
  // Refine histograms + memory cadence (visualize_tools.rs:86-707 parity).
  if(m.kind==='refine'){lastRefine=m;splatsArr.push(m.total);
    if(splatsArr.length>240)splatsArr.shift();
    document.getElementById('rl').textContent=
      `refine +${m.added} (split ${m.oversized} resample ${m.resampled} `+
      `grow ${m.grad_grown}) -${m.pruned} = ${m.total}`+
      (isFinite(m.mem_used_mb)?` | hbm ${(m.mem_used_mb/1024).toFixed(2)}G`
       +(isFinite(m.mem_limit_mb)?`/${(m.mem_limit_mb/1024).toFixed(0)}G`:'')
       :'');}
  document.getElementById('stats').style.display='block';
  document.getElementById('sl').textContent=
    `it ${m.iter} ${m.kind==='step'?'loss '+m.loss.toFixed(4):''}`+
    (psnrs.length?` psnr ${psnrs[psnrs.length-1].toFixed(2)}`:'');
  drawStats();};}catch(e){}
function spark(g,arr,y0,h,color){if(arr.length<2)return;
  const lo=Math.min(...arr),hi=Math.max(...arr),s=hi-lo||1;
  g.strokeStyle=color;g.beginPath();
  arr.forEach((v,i)=>{const X=i/(arr.length-1)*238+1,
    Y=y0+h-1-(v-lo)/s*(h-2);i?g.lineTo(X,Y):g.moveTo(X,Y)});g.stroke();}
function drawStats(){const g=document.getElementById('sc').getContext('2d');
  g.clearRect(0,0,240,136);spark(g,losses,0,44,'#e66');
  spark(g,psnrs,46,44,'#6e6');spark(g,splatsArr,92,44,'#69e');}
async function fetchSplats(){
  // Live splat point-cloud snapshot (visualize_tools.rs splat streams).
  const buf=await(await fetch(`/splats?frame=${frame}`)).arrayBuffer();
  const u=new Uint32Array(buf,0,4);if(u[0]!==0x4c505342)return;
  cloud=new Float32Array(buf,16,u[2]*3);}
function drawPoints(){if(!cloud)return;
  const p=camPos();const fwd=snap?null:[-p[0],-p[1],-p[2]];
  // simple look-at projection matching the server's orbit camera
  let f=fwd||[0,0,1];const fl=Math.hypot(...f)||1;f=f.map(v=>v/fl);
  const up=[0,1,0];
  const r=[up[1]*f[2]-up[2]*f[1],up[2]*f[0]-up[0]*f[2],up[0]*f[1]-up[1]*f[0]];
  const rl=Math.hypot(...r)||1;const R=r.map(v=>v/rl);
  const u2=[f[1]*R[2]-f[2]*R[1],f[2]*R[0]-f[0]*R[2],f[0]*R[1]-f[1]*R[0]];
  const fx=c.width/(2*Math.tan(+fv.value/2));
  x.fillStyle='#8f8';
  const n=cloud.length/3,step=Math.max(1,Math.floor(n/20000));
  for(let i=0;i<n;i+=step){
    const dx=cloud[3*i]-p[0],dy=cloud[3*i+1]-p[1],dz=cloud[3*i+2]-p[2];
    const cz=dx*f[0]+dy*f[1]+dz*f[2];if(cz<0.05)continue;
    const cx=dx*R[0]+dy*R[1]+dz*R[2],cy=dx*u2[0]+dy*u2[1]+dz*u2[2];
    x.fillRect(c.width/2+cx/cz*fx,c.height/2-cy/cz*fx,1,1);}}
async function loop(){
  if(!busy){busy=true;
    const p=camPos();
    if(playing){frame=(frame+1)%nframes;saveHash();}
    const w=Math.min(640,c.width),h=Math.min(480,c.height);
    try{
      let url=`/render?px=${p[0]}&py=${p[1]}&pz=${p[2]}&yaw=${yaw}&pitch=${pitch}&w=${w}&h=${h}&frame=${frame}&scale=${Math.pow(10,ss.value)}&bg=${hex2rgb(bgc.value)}`;
      url+=snap?`&q=${snap.rotation.join(',')}&fov=${snap.fov_x}&fovy=${snap.fov_y}`
               :`&fov=${fv.value}`;
      const r=await fetch(url);
      const b=await r.blob();const img=await createImageBitmap(b);
      x.drawImage(img,0,0,c.width,c.height);
      if(snap&&gtimg){
        // Training-view compare: GT wipe over the render.
        const wx=+wipe.value*c.width;
        x.save();x.beginPath();x.rect(0,0,wx,c.height);x.clip();
        x.drawImage(gtimg,0,0,c.width,c.height);x.restore();
        x.strokeStyle='#fff';x.beginPath();x.moveTo(wx,0);
        x.lineTo(wx,c.height);x.stroke();}
      if(points){if(cloudV<0||cloudV%60===0)fetchSplats();cloudV++;
        drawPoints();}
    }catch(e){}
    busy=false;}
  requestAnimationFrame(loop);}
loop();
</script></body></html>"""

# JS client library (counterpart of the reference's wasm-bindgen JS API,
# apps/brush-js/src/lib.rs: init, message stream, raw splat-buffer access
# for host render pipelines). Served at /brush.js; works from any origin.
_BRUSH_JS = """// brush_tpu JS API
// const b = new BrushClient('http://host:8080');
// await b.info();                        -> {n_splats, n_frames, version}
// await b.render({yaw, pitch, dist, w, h, frame}) -> Blob (JPEG)
// await b.splats(frame)                  -> {count, shCoeffs, means,
//                                            logScales, quats, sh, opacity}
//                                           (Float32Array views, zero-copy
//                                            over one fetched ArrayBuffer)
// b.messages(cb)                         -> EventSource of training
//                                           messages ({kind, iter, ...});
//                                           returns a close() handle.
class BrushClient {
  constructor(base = '') { this.base = base; }
  async info() { return (await fetch(this.base + '/info')).json(); }
  async render(o = {}) {
    const dist = o.dist ?? 5, yaw = o.yaw ?? 0, pitch = o.pitch ?? 0.3;
    const px = o.px ?? dist * Math.cos(pitch) * Math.sin(yaw);
    const py = o.py ?? dist * Math.sin(pitch);
    const pz = o.pz ?? -dist * Math.cos(pitch) * Math.cos(yaw);
    const q = new URLSearchParams({
      px, py, pz, yaw, pitch, w: o.w ?? 640, h: o.h ?? 480,
      frame: o.frame ?? 0, scale: o.scale ?? 1, fov: o.fov ?? 1,
      bg: o.bg ?? '0,0,0'});
    return (await fetch(this.base + '/render?' + q)).blob();
  }
  async splats(frame = 0) {
    const buf = await (await fetch(
      this.base + '/splats?frame=' + frame)).arrayBuffer();
    const u32 = new Uint32Array(buf, 0, 4);
    if (u32[0] !== 0x4c505342) throw new Error('bad magic');   // 'BSPL'
    const [, version, count, shCoeffs] = u32;
    let off = 16;
    const take = (n) => {
      const a = new Float32Array(buf, off, n); off += 4 * n; return a; };
    return {
      version, count, shCoeffs,
      means: take(count * 3), logScales: take(count * 3),
      quats: take(count * 4),                 // wxyz
      sh: take(count * shCoeffs * 3),         // [n, coeffs, rgb]
      opacity: take(count),                   // raw logits; a=sigmoid(o)
    };
  }
  messages(cb) {
    const es = new EventSource(this.base + '/events');
    es.onmessage = (e) => cb(JSON.parse(e.data));
    return { close: () => es.close() };
  }
}
if (typeof module !== 'undefined') module.exports = { BrushClient };
"""


class ViewerState:
    def __init__(self, slot: Slot, sh_degree: int, isect_cap: int = 1 << 20,
                 use_pallas: bool = True, bus: MessageBus | None = None,
                 mip_splatting: bool = False, device="cuda"):
        self.slot = slot
        self.sh_degree = sh_degree
        self.isect_cap = isect_cap
        self.use_pallas = use_pallas
        self.bus = bus
        self.mip_splatting = mip_splatting  # from ply header render mode
        self.device = resolve_device(device)
        self.lock = threading.Lock()  # one card: serialize renders
        self._frame_ids = itertools.count()   # render_pose's stage units

    def splat_buffer(self, frame: int) -> bytes:
        """Packed splat snapshot for the JS API (see _BRUSH_JS.splats):
        16-byte header (magic 'BSPL', version, count, sh_coeffs) + f32
        means/log_scales/quats/sh/opacity arrays, alive splats only."""
        import struct

        splats = self.slot.get(frame)
        if splats is None:
            return struct.pack("<4sIII", b"BSPL", 1, 0, 0)
        n = int(splats.n_alive)

        def rows(x):   # the alive rows are the first n_alive
            return x[:n].detach().to(torch.float32).cpu().numpy()

        sh = rows(splats.sh_coeffs)
        parts = [
            struct.pack("<4sIII", b"BSPL", 1, n, sh.shape[1]),
            rows(splats.means).tobytes(),
            rows(splats.log_scales).tobytes(),
            rows(splats.quats).tobytes(),
            sh.tobytes(),
            rows(splats.raw_opacities).tobytes(),
        ]
        return b"".join(parts)

    def pose_camera(self, pos, w: int, h: int, fov: float = 1.0,
                    quat=None, fov_y=None) -> Camera:
        """The camera of a request: at `pos`, looking at the origin (the
        orbit) unless `quat` (wxyz c2w) gives its orientation; `fov` the
        horizontal field of view in radians, `fov_y` the vertical one
        (default: `fov` scaled by the aspect)."""
        if quat is not None:
            rotation = np.asarray(quat, np.float64)
            rotation /= max(np.linalg.norm(rotation), 1e-9)
        else:
            # Look-at-origin orbit pose: forward = -pos dir = +z cam.
            fwd = -np.asarray(pos)
            fwd = fwd / max(np.linalg.norm(fwd), 1e-9)
            up = np.array([0.0, 1.0, 0.0])
            right = np.cross(up, fwd)
            right /= max(np.linalg.norm(right), 1e-9)
            up2 = np.cross(fwd, right)
            r = np.stack([right, up2, fwd], axis=1)  # c2w columns
            from brush_tpu_torch.data.colmap import _rotmat_to_quat
            rotation = _rotmat_to_quat(r)
        return Camera(position=np.asarray(pos), rotation=rotation,
                      fov_x=fov, fov_y=fov_y if fov_y else fov * h / w)

    def render_config(self, w: int, h: int):
        """The RenderConfig of a w x h frame. forward_only: the viewer
        never differentiates, so it takes the diet forward
        (rasterize.rs:172-177, no backward bookkeeping)."""
        from brush_tpu_torch.render import RenderConfig
        return RenderConfig(img_size=(w, h), sh_degree=self.sh_degree,
                            isect_cap=self.isect_cap,
                            use_pallas=self.use_pallas, forward_only=True,
                            mip_splatting=self.mip_splatting)

    def render_pose(self, pos, yaw, pitch, w, h, frame,
                    splat_scale=1.0, fov=1.0, bg=(0.0, 0.0, 0.0),
                    quat=None, fov_y=None):
        """[h, w, 3] uint8 frame. `splat_scale` multiplies every splat's
        scale at render time (the reference's viewer slider,
        gaussian_splats.rs:388-393), after the 3D filter floor is folded;
        `fov` is the horizontal field of view in radians; `bg` the
        background color. `quat` (wxyz c2w) overrides the look-at-origin
        orbit orientation — used by nearest-dataset-view snapping /
        training-view compare (SURVEY Appendix F). `yaw` and `pitch` are
        the client's and not used: `pos` places the orbit camera."""
        from brush_tpu_torch.graphs import RENDER_GRAPHS
        from brush_tpu_torch.render import camera_inputs, render
        from brush_tpu_torch.utils.device import device_constant

        with stage("viewer.frame", device=True,
                   unit=next(self._frame_ids)) as frame_span:
            splats = self.slot.get(frame)
            if splats is None:
                return np.zeros((h, w, 3), np.uint8)
            cfg = self.render_config(w, h)
            dev = self.device
            with self._locked(), torch.no_grad():
                frame_span.mark_device_start()
                with stage("viewer.fold"):
                    folded = splats.fold_min_scale()
                    log_scales = folded.log_scales
                    if splat_scale != 1.0:
                        log_scales = log_scales + math.log(
                            max(splat_scale, 1e-6))
                with stage("viewer.camera"):
                    cam = camera_inputs(self.pose_camera(
                        pos, w, h, fov=fov, quat=quat, fov_y=fov_y), (w, h),
                        device=dev)
                args = (folded.means, log_scales, folded.quats,
                        folded.sh_coeffs, folded.raw_opacities, cam,
                        device_constant(bg, dev))
                if dev.type == "cuda" and cfg.use_pallas:
                    img, _ = RENDER_GRAPHS.get(render, cfg,
                                               folded.capacity)(*args)
                else:
                    img, _ = render(*args, cfg)
                with stage("viewer.copy", device=True):
                    return frame_u8(img).cpu().numpy()

    @contextlib.contextmanager
    def _locked(self):
        """`self.lock`, its wait a `viewer.lock` stage (and a
        `viewer.lock_contended` count where another render held it)."""
        with stage("viewer.lock"):
            if not self.lock.acquire(blocking=False):
                count("viewer.lock_contended")
                self.lock.acquire()
        try:
            yield
        finally:
            self.lock.release()


def frame_u8(img: torch.Tensor) -> torch.Tensor:
    """[H, W, 4] f32 render -> [H, W, 3] uint8, as the JAX viewer converts
    on the host: clip to [0, 1], times 255 in float32, truncated."""
    return (torch.clamp(img[..., :3], 0.0, 1.0) * 255.0).to(torch.uint8)


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                self._send(200, "text/html", _CLIENT_HTML.encode())
            elif u.path == "/brush.js":
                self._send(200, "application/javascript",
                           _BRUSH_JS.encode())
            elif u.path == "/splats":
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                self._send(200, "application/octet-stream",
                           state.splat_buffer(int(q.get("frame", 0))))
            elif u.path == "/events":
                if state.bus is None:
                    self._send(404, "text/plain", b"no training attached")
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Access-Control-Allow-Origin", "*")
                self.end_headers()
                sub = state.bus.subscribe()
                try:
                    while True:
                        try:
                            msg = sub.get(timeout=15.0)
                            payload = json.dumps(msg, default=float)
                            self.wfile.write(
                                f"data: {payload}\n\n".encode())
                        except Exception:
                            self.wfile.write(b": keepalive\n\n")
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass
                finally:
                    state.bus.unsubscribe(sub)
            elif u.path == "/views":
                # Dataset camera poses (train + eval splits): nearest-view
                # snapping / training-view compare (SURVEY Appendix F).
                self._send(200, "application/json",
                           json.dumps(state.slot.scene_views).encode())
            elif u.path == "/gt":
                if state.slot.gt_fn is None:
                    self._send(404, "text/plain", b"no dataset attached")
                    return
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                i = int(q.get("view", 0))
                if not 0 <= i < len(state.slot.scene_views):
                    self._send(404, "text/plain", b"view out of range")
                    return
                arr = state.slot.gt_fn(i, int(q.get("maxdim", 640)))
                from PIL import Image
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, "JPEG", quality=88)
                self._send(200, "image/jpeg", buf.getvalue())
            elif u.path == "/info":
                s = state.slot.get(0)
                info = dict(
                    n_splats=0 if s is None else int(s.n_alive),
                    n_frames=state.slot.n_frames,
                    version=state.slot.version)
                self._send(200, "application/json", json.dumps(info).encode())
            elif u.path == "/render":
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                pos = [float(q.get("px", 0)), float(q.get("py", 0)),
                       float(q.get("pz", -5))]
                w = min(int(q.get("w", 512)), 1920)
                h = min(int(q.get("h", 384)), 1080)
                bg = tuple(float(x) for x in
                           q.get("bg", "0,0,0").split(","))[:3]
                quat = (tuple(float(x) for x in q["q"].split(","))[:4]
                        if "q" in q else None)
                arr = state.render_pose(
                    pos, float(q.get("yaw", 0)), float(q.get("pitch", 0)),
                    w, h, int(q.get("frame", 0)),
                    splat_scale=float(q.get("scale", 1.0)),
                    fov=min(max(float(q.get("fov", 1.0)), 0.1), 3.0),
                    bg=bg, quat=quat,
                    fov_y=float(q["fovy"]) if "fovy" in q else None)
                from PIL import Image
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, "JPEG", quality=88)
                self._send(200, "image/jpeg", buf.getvalue())
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def load_source_into_slot(source: str, slot: Slot, sh_degree: int = 3,
                          progressive: bool = True, device="cuda"):
    """.ply or zip/dir of plys -> frames (alphanumeric order = animation).

    With `progressive`, large plys publish growing prefixes to the slot as
    rows are parsed, so the viewer shows content immediately — the
    reference streams a SplatMessage every 1.5 s while parsing
    (import.rs:183). The splats go to `device`."""
    from brush_tpu_torch.data.vfs import Vfs
    from brush_tpu_torch.io.ply import load_splat_ply, stream_splat_ply
    from brush_tpu_torch.train.splat_init import to_init_splats

    vfs = Vfs(source)
    plys = sorted(vfs.files_with_extension("ply"),
                  key=lambda p: PurePosixPath(p).name)
    if not plys:
        raise ValueError(f"no .ply files in {source}")
    render_mode = None
    for i, p in enumerate(plys):
        if progressive:
            for d in stream_splat_ply(vfs.open(p)):
                splats = to_init_splats(d.means, d.log_scales, d.rotations,
                                        d.sh_coeffs, d.raw_opacities,
                                        device=device)
                slot.set(i, splats.with_sh_degree(sh_degree))
        else:
            d = load_splat_ply(vfs.open(p))
            splats = to_init_splats(d.means, d.log_scales, d.rotations,
                                    d.sh_coeffs, d.raw_opacities,
                                    device=device)
            slot.set(i, splats.with_sh_degree(sh_degree))
        render_mode = render_mode or d.render_mode
    return render_mode


def serve(source: str | None = None, slot: Slot | None = None,
          host: str = "0.0.0.0", port: int = 8080, sh_degree: int = 3,
          use_pallas: bool = True, blocking: bool = True,
          bus: MessageBus | None = None, device="cuda"):
    """Start the viewer, rendering on `device`. Either a ply `source` or a
    live `slot` (+ optional MessageBus for the /events training stream).
    Returns the server (its `viewer_state` the ViewerState it renders
    with); `blocking=False` serves from a daemon thread (stop it with
    `server.shutdown()`)."""
    dev = resolve_device(device)
    slot = slot or Slot()
    render_mode = None
    if source:
        render_mode = load_source_into_slot(source, slot, sh_degree,
                                            device=dev)
    state = ViewerState(slot, sh_degree, use_pallas=use_pallas, bus=bus,
                        mip_splatting=(render_mode or "").lower() == "mip",
                        device=dev)
    server = ThreadingHTTPServer((host, port), make_handler(state))
    server.viewer_state = state
    if blocking:
        print(f"viewer on http://{host}:{port}")
        server.serve_forever()
    else:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
    return server
