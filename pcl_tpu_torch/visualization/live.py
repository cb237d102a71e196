"""Live interactive viewer — the PCLVisualizer windowed-render-loop analog
for headless hosts: a local bridge between the browser's HTML/JS viewer
and the Python side.

``LiveViewer`` wraps a ``Visualizer`` with a threaded local HTTP server
(stdlib only — no external deps in the image):

- ``GET /``        the WebGL viewer page (same renderer as export.py's
                   offline HTML) whose data arrives over a LONG-POLL
                   stream — each ``push()`` on the Python side re-renders
                   every connected browser within one round trip (the
                   long-poll plays the websocket's role with zero
                   protocol dependencies; frames are pushed, not polled
                   on a timer);
- ``GET /frame?seq=N``   blocks until a frame newer than N exists, then
                   returns it (JSON header + base64 f32/u8 payloads);
- ``POST /events`` browser events (key / point-pick / mouse) in the same
                   JSON schema the offline HTML exports — dispatched
                   straight into the Visualizer's callback registry
                   (``dispatch_events``), so ``register_keyboard_callback``
                   etc. fire live, matching
                   pcl::visualization::PCLVisualizer::registerKeyboard-
                   Callback (reference: visualization/include/pcl/
                   visualization/pcl_visualizer.h:93 spin/spinOnce loop).

Typical loop (the RegistrationVisualizer pattern)::

    vis = Visualizer(); vis.add_point_cloud(cloud)
    live = LiveViewer(vis)          # prints live.url
    for T in icp_iterations:
        vis.update_point_cloud(transform(T, cloud))
        live.push()                 # every browser re-renders
    live.close()

Counterpart of ``pcl_tpu/visualization/live.py``: a copy of its code (stdlib
and numpy); the page and the frames are the JAX package's byte for byte.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>pcl_tpu live viewer</title>
<style>html,body{margin:0;height:100%;overflow:hidden;background:#111}
canvas{width:100%;height:100%;display:block}
#info{position:absolute;top:8px;left:8px;color:#ccc;font:12px monospace}</style>
</head><body><div id="info">connecting…</div>
<canvas id="c"></canvas><script>
let xyz=new Float32Array(0), N=0, seq=0;
function b64f32(s){const b=atob(s);const a=new Uint8Array(b.length);
for(let i=0;i<b.length;i++)a[i]=b.charCodeAt(i);return new Float32Array(a.buffer);}
function b64u8(s){const b=atob(s);const a=new Uint8Array(b.length);
for(let i=0;i<b.length;i++)a[i]=b.charCodeAt(i);return a;}
const cv=document.getElementById('c');
const gl=cv.getContext('webgl');
const vsrc=`attribute vec3 p;attribute vec3 c;uniform mat4 mvp;varying vec3 vc;
void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=2.0;vc=c;}`;
const fsrc=`precision mediump float;varying vec3 vc;
void main(){gl_FragColor=vec4(vc,1.0);}`;
function sh(t,s){const h=gl.createShader(t);gl.shaderSource(h,s);gl.compileShader(h);return h;}
const pr=gl.createProgram();gl.attachShader(pr,sh(gl.VERTEX_SHADER,vsrc));
gl.attachShader(pr,sh(gl.FRAGMENT_SHADER,fsrc));gl.linkProgram(pr);gl.useProgram(pr);
const pb=gl.createBuffer(), cb=gl.createBuffer();
const lp=gl.getAttribLocation(pr,'p'), lc=gl.getAttribLocation(pr,'c');
let cx=0,cy=0,cz=0,r=1,rotX=0.3,rotY=0.5,dist=2.5;
function setFrame(f){
 xyz=b64f32(f.pts); N=f.n; seq=f.seq;
 let cols;
 if(f.col){const u=b64u8(f.col);cols=new Float32Array(N*3);
  for(let i=0;i<N*3;i++)cols[i]=u[i]/255;}
 else{cols=new Float32Array(N*3);
  let zmin=1e9,zmax=-1e9;for(let i=0;i<N;i++){const z=xyz[3*i+2];
   if(z<zmin)zmin=z;if(z>zmax)zmax=z;}
  for(let i=0;i<N;i++){const t=(xyz[3*i+2]-zmin)/Math.max(zmax-zmin,1e-9);
   cols[3*i]=t;cols[3*i+1]=0.5;cols[3*i+2]=1.0-t;}}
 gl.bindBuffer(gl.ARRAY_BUFFER,pb);
 gl.bufferData(gl.ARRAY_BUFFER,xyz,gl.DYNAMIC_DRAW);
 gl.bindBuffer(gl.ARRAY_BUFFER,cb);
 gl.bufferData(gl.ARRAY_BUFFER,cols,gl.DYNAMIC_DRAW);
 if(f.reset_view||seq<=1){cx=0;cy=0;cz=0;
  for(let i=0;i<N;i++){cx+=xyz[3*i];cy+=xyz[3*i+1];cz+=xyz[3*i+2];}
  if(N){cx/=N;cy/=N;cz/=N;}
  r=1e-6;for(let i=0;i<N;i++){const dx=xyz[3*i]-cx,dy=xyz[3*i+1]-cy,
   dz=xyz[3*i+2]-cz;r=Math.max(r,Math.sqrt(dx*dx+dy*dy+dz*dz));}
  dist=2.5*r;}
 document.getElementById('info').textContent=
  f.info+' — frame '+seq+' ('+N+' pts)';}
async function pump(){
 for(;;){try{
  const resp=await fetch('/frame?seq='+seq);
  const f=await resp.json();
  if(f.n!==undefined&&f.seq>seq)setFrame(f);
 }catch(e){await new Promise(r=>setTimeout(r,500));}}}
pump();
cv.onmousedown=e=>{const sx=e.clientX,sy=e.clientY,rx=rotX,ry=rotY;
cv.onmousemove=m=>{rotY=ry+(m.clientX-sx)*0.01;rotX=rx+(m.clientY-sy)*0.01;};
cv.onmouseup=()=>cv.onmousemove=null;};
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();};
function mat(){const a=cv.width/Math.max(cv.height,1),f=1/Math.tan(0.4);
const near=0.01*r,far=100*r;
const cxr=Math.cos(rotX),sxr=Math.sin(rotX),cyr=Math.cos(rotY),syr=Math.sin(rotY);
function mul(A,B){const C=new Float32Array(16);
for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
for(let k=0;k<4;k++)s+=A[k*4+j]*B[i*4+k];C[i*4+j]=s;}return C;}
const zr=(far+near)/(near-far), zt=2*far*near/(near-far);
const T1=new Float32Array([1,0,0,0, 0,1,0,0, 0,0,1,0, -cx,-cy,-cz,1]);
const RY=new Float32Array([cyr,0,-syr,0, 0,1,0,0, syr,0,cyr,0, 0,0,0,1]);
const RX=new Float32Array([1,0,0,0, 0,cxr,sxr,0, 0,-sxr,cxr,0, 0,0,0,1]);
const T2=new Float32Array([1,0,0,0, 0,1,0,0, 0,0,1,0, 0,0,-dist,1]);
const P=new Float32Array([f/a,0,0,0, 0,f,0,0, 0,0,zr,-1, 0,0,zt,0]);
return mul(P,mul(T2,mul(RX,mul(RY,T1))));}
const lm=gl.getUniformLocation(pr,'mvp');
function frame(){cv.width=cv.clientWidth;cv.height=cv.clientHeight;
gl.viewport(0,0,cv.width,cv.height);gl.clearColor(0.07,0.07,0.07,1);
gl.enable(gl.DEPTH_TEST);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
if(N){gl.bindBuffer(gl.ARRAY_BUFFER,pb);gl.enableVertexAttribArray(lp);
gl.vertexAttribPointer(lp,3,gl.FLOAT,false,0,0);
gl.bindBuffer(gl.ARRAY_BUFFER,cb);gl.enableVertexAttribArray(lc);
gl.vertexAttribPointer(lc,3,gl.FLOAT,false,0,0);
gl.uniformMatrix4fv(lm,false,mat());gl.drawArrays(gl.POINTS,0,N);}
requestAnimationFrame(frame);}frame();
// --- event bridge: same schema as the offline HTML's event export ---
const EVENTS=[];
window.addEventListener('keydown',e=>EVENTS.push({type:'key',key:e.key,
 down:true,alt:e.altKey,ctrl:e.ctrlKey,shift:e.shiftKey}));
cv.addEventListener('dblclick',ev=>{
 const rect=cv.getBoundingClientRect();
 const mx=ev.clientX-rect.left,my=ev.clientY-rect.top;
 const m=mat();let best=-1,bd=25;
 for(let i=0;i<N;i++){
  const x=xyz[3*i],y=xyz[3*i+1],z=xyz[3*i+2];
  const w=m[3]*x+m[7]*y+m[11]*z+m[15];
  if(w<=0)continue;
  const sx=(m[0]*x+m[4]*y+m[8]*z+m[12])/w,sy=(m[1]*x+m[5]*y+m[9]*z+m[13])/w;
  const px=(sx*0.5+0.5)*cv.width,py=(1-(sy*0.5+0.5))*cv.height;
  const d=(px-mx)*(px-mx)+(py-my)*(py-my);
  if(d<bd){bd=d;best=i;}}
 if(best>=0)EVENTS.push({type:'pick',index:best,
  x:xyz[3*best],y:xyz[3*best+1],z:xyz[3*best+2]});});
['mousedown','mouseup'].forEach(t=>cv.addEventListener(t,e=>
 EVENTS.push({type:'mouse',event:t==='mousedown'?'press':'release',
 button:['left','middle','right'][e.button]||'left',x:e.clientX,y:e.clientY})));
setInterval(()=>{if(EVENTS.length){
 const batch=EVENTS.splice(0,EVENTS.length);
 fetch('/events',{method:'POST',headers:{'Content-Type':'application/json'},
  body:JSON.stringify(batch)}).catch(()=>{});}},300);
</script></body></html>"""


class LiveViewer:
    """Threaded local HTTP bridge between a Visualizer and live browsers."""

    def __init__(self, visualizer, host: str = "127.0.0.1", port: int = 0,
                 poll_timeout: float = 25.0):
        self.vis = visualizer
        self._cond = threading.Condition()
        self._seq = 0
        self._frame: Optional[dict] = None
        self._poll_timeout = poll_timeout
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request logging
                pass

            def _send(self, code, body, ctype="application/json"):
                data = body.encode() if isinstance(body, str) else body
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    self._send(200, _PAGE, "text/html")
                elif u.path == "/frame":
                    q = parse_qs(u.query)
                    seq = int(q.get("seq", ["0"])[0])
                    frame = outer._wait_frame(seq)
                    if frame is None:
                        self._send(200, json.dumps({"seq": seq}))
                    else:
                        self._send(200, json.dumps(frame))
                else:
                    self._send(404, "{}")

            def do_POST(self):
                if urlparse(self.path).path != "/events":
                    self._send(404, "{}")
                    return
                length = int(self.headers.get("Content-Length", "0"))
                try:
                    events = json.loads(self.rfile.read(length) or b"[]")
                    n = outer.vis.dispatch_events(events)
                    self._send(200, json.dumps({"dispatched": n}))
                except Exception as e:  # noqa: BLE001
                    self._send(400, json.dumps({"error": str(e)}))

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        self.push()  # initial frame

    @property
    def url(self) -> str:
        h, p = self._server.server_address[:2]
        return f"http://{h}:{p}/"

    def push(self, reset_view: bool = False) -> int:
        """Publish the Visualizer's current scene to all connected
        browsers. Returns the new frame sequence number."""
        xyz, cols, _sizes, info = self.vis._flatten()
        c8 = np.clip(np.asarray(cols, np.float32) * 255 + 0.5,
                     0, 255).astype(np.uint8)
        frame = {
            "n": int(len(xyz)),
            "pts": base64.b64encode(
                np.ascontiguousarray(xyz, np.float32).tobytes()).decode(),
            "col": base64.b64encode(
                np.ascontiguousarray(c8).tobytes()).decode(),
            "info": info,
            "reset_view": bool(reset_view),
        }
        with self._cond:
            self._seq += 1
            frame["seq"] = self._seq
            self._frame = frame
            self._cond.notify_all()
        return self._seq

    def _wait_frame(self, have_seq: int) -> Optional[dict]:
        with self._cond:
            if self._frame is not None and self._seq > have_seq:
                return self._frame
            self._cond.wait(self._poll_timeout)
            if self._frame is not None and self._seq > have_seq:
                return self._frame
            return None

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
