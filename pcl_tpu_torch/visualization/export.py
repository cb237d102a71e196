"""Self-contained HTML/WebGL viewers + terminal snapshots.

Replaces the interactive window of pcl::visualization::PCLVisualizer
(reference: visualization/include/pcl/visualization/pcl_visualizer.h:93)
with artifacts that work over a remote connection: one .html file per cloud
(raw WebGL point rendering, orbit controls, no network dependencies) and an
ASCII z-buffer snapshot for terminals/CI logs.

Counterpart of ``pcl_tpu/visualization/export.py``: a copy of its numpy code
and of its HTML template, so that the files are the JAX package's byte for
byte. Clouds are read back to the host once (``to_numpy``, the rows in the
cloud's order).
"""

from __future__ import annotations

import base64
import json
from typing import Optional

import numpy as np

from pcl_tpu_torch.core.cloud import Cloud, to_numpy

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>pcl_tpu viewer</title>
<style>html,body{margin:0;height:100%;overflow:hidden;background:#111}
canvas{width:100%;height:100%;display:block}
#info{position:absolute;top:8px;left:8px;color:#ccc;font:12px monospace}</style>
</head><body><div id="info">__INFO__ — drag: rotate, wheel: zoom</div>
<canvas id="c"></canvas><script>
const PTS = __PTS__;  // base64 f32 xyz
const COL = __COL__;  // base64 u8 rgb or null
const N = __N__;
function b64f32(s){const b=atob(s);const a=new Uint8Array(b.length);
for(let i=0;i<b.length;i++)a[i]=b.charCodeAt(i);return new Float32Array(a.buffer);}
function b64u8(s){const b=atob(s);const a=new Uint8Array(b.length);
for(let i=0;i<b.length;i++)a[i]=b.charCodeAt(i);return a;}
const xyz=b64f32(PTS); const col=COL?b64u8(COL):null;
const cv=document.getElementById('c');
const gl=cv.getContext('webgl');
const vs=`attribute vec3 p;attribute vec3 c;uniform mat4 mvp;varying vec3 vc;
void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=2.0;vc=c;}`;
const fs=`precision mediump float;varying vec3 vc;
void main(){gl_FragColor=vec4(vc,1.0);}`;
function sh(t,s){const h=gl.createShader(t);gl.shaderSource(h,s);gl.compileShader(h);return h;}
const pr=gl.createProgram();gl.attachShader(pr,sh(gl.VERTEX_SHADER,vs));
gl.attachShader(pr,sh(gl.FRAGMENT_SHADER,fs));gl.linkProgram(pr);gl.useProgram(pr);
const pb=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,pb);
gl.bufferData(gl.ARRAY_BUFFER,xyz,gl.STATIC_DRAW);
const lp=gl.getAttribLocation(pr,'p');gl.enableVertexAttribArray(lp);
gl.vertexAttribPointer(lp,3,gl.FLOAT,false,0,0);
const cb=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,cb);
let cols; if(col){cols=new Float32Array(N*3);for(let i=0;i<N*3;i++)cols[i]=col[i]/255;}
else{cols=new Float32Array(N*3);
let zmin=1e9,zmax=-1e9;for(let i=0;i<N;i++){const z=xyz[3*i+2];if(z<zmin)zmin=z;if(z>zmax)zmax=z;}
for(let i=0;i<N;i++){const t=(xyz[3*i+2]-zmin)/Math.max(zmax-zmin,1e-9);
cols[3*i]=t;cols[3*i+1]=0.5;cols[3*i+2]=1.0-t;}}
gl.bufferData(gl.ARRAY_BUFFER,cols,gl.STATIC_DRAW);
const lc=gl.getAttribLocation(pr,'c');gl.enableVertexAttribArray(lc);
gl.vertexAttribPointer(lc,3,gl.FLOAT,false,0,0);
let cx=0,cy=0,cz=0;for(let i=0;i<N;i++){cx+=xyz[3*i];cy+=xyz[3*i+1];cz+=xyz[3*i+2];}
cx/=N;cy/=N;cz/=N;
let r=0;for(let i=0;i<N;i++){const dx=xyz[3*i]-cx,dy=xyz[3*i+1]-cy,dz=xyz[3*i+2]-cz;
r=Math.max(r,Math.sqrt(dx*dx+dy*dy+dz*dz));}
let rotX=0.3,rotY=0.5,dist=2.5*r;
cv.onmousedown=e=>{const sx=e.clientX,sy=e.clientY,rx=rotX,ry=rotY;
cv.onmousemove=m=>{rotY=ry+(m.clientX-sx)*0.01;rotX=rx+(m.clientY-sy)*0.01;};
cv.onmouseup=()=>cv.onmousemove=null;};
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();};
function mat(){const a=cv.width/cv.height,f=1/Math.tan(0.4);
const near=0.01*r,far=100*r;
const cxr=Math.cos(rotX),sxr=Math.sin(rotX),cyr=Math.cos(rotY),syr=Math.sin(rotY);
// model: translate(-center) then rotY then rotX then translate(0,0,-dist), proj
const m=new Float32Array(16);
const zr=(far+near)/(near-far), zt=2*far*near/(near-far);
// combined manually
function mul(A,B){const C=new Float32Array(16);
for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
for(let k=0;k<4;k++)s+=A[k*4+j]*B[i*4+k];C[i*4+j]=s;}return C;}
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
gl.uniformMatrix4fv(lm,false,mat());gl.drawArrays(gl.POINTS,0,N);
requestAnimationFrame(frame);}frame();
</script></body></html>"""


def cloud_to_html(path, cloud: Cloud, max_points: int = 500_000,
                  title: Optional[str] = None) -> None:
    """Write a self-contained interactive viewer for the cloud."""
    xyz, attrs = to_numpy(cloud, compact=True)
    if len(xyz) > max_points:
        sel = np.random.default_rng(0).choice(len(xyz), max_points, replace=False)
        xyz = xyz[sel]
        attrs = {k: v[sel] for k, v in attrs.items()}
    pts_b64 = base64.b64encode(np.ascontiguousarray(xyz, np.float32).tobytes()).decode()
    col = "null"
    if "rgb" in attrs:
        c8 = np.clip(attrs["rgb"] * 255 + 0.5, 0, 255).astype(np.uint8)
        col = json.dumps(base64.b64encode(np.ascontiguousarray(c8).tobytes()).decode())
    html = (_HTML_TEMPLATE
            .replace("__PTS__", json.dumps(pts_b64))
            .replace("__COL__", col)
            .replace("__N__", str(len(xyz)))
            .replace("__INFO__", title or f"{len(xyz)} points"))
    with open(path, "w") as f:
        f.write(html)


def mesh_to_html(path, vertices: np.ndarray, triangles: np.ndarray,
                 title: Optional[str] = None) -> None:
    """Write a viewer for a triangle mesh (rendered as its vertex cloud +
    edge midpoints for density — full shaded meshes via the PLY export)."""
    tri = np.asarray(triangles)
    v = np.asarray(vertices, np.float32)
    mids = v[tri].mean(axis=1)
    from pcl_tpu_torch.core.cloud import from_numpy
    allp = np.concatenate([v, mids.astype(np.float32)])
    cloud_to_html(path, from_numpy(allp, device="cpu"),
                  title=title or f"mesh: {len(v)} verts / {len(tri)} tris")


def render_ascii(cloud: Cloud, width: int = 80, height: int = 40,
                 axis: int = 2) -> str:
    """Orthographic ASCII z-buffer snapshot (depth-shaded) — the terminal
    stand-in for CloudViewer."""
    xyz, _ = to_numpy(cloud, compact=True)
    if len(xyz) == 0:
        return "(empty cloud)"
    axes = [a for a in range(3) if a != axis]
    uv = xyz[:, axes]
    d = xyz[:, axis]
    lo = uv.min(axis=0)
    hi = uv.max(axis=0)
    span = np.maximum(hi - lo, 1e-9)
    u = np.clip(((uv[:, 0] - lo[0]) / span[0] * (width - 1)), 0, width - 1).astype(int)
    v = np.clip(((uv[:, 1] - lo[1]) / span[1] * (height - 1)), 0, height - 1).astype(int)
    depth = np.full((height, width), np.inf)
    np.minimum.at(depth, (v, u), d)
    shades = " .:-=+*#%@"
    dmin, dmax = d.min(), d.max()
    out = []
    for row in depth[::-1]:
        line = []
        for val in row:
            if np.isinf(val):
                line.append(" ")
            else:
                t = 1.0 - (val - dmin) / max(dmax - dmin, 1e-9)
                line.append(shades[int(t * (len(shades) - 1))])
        out.append("".join(line))
    return "\n".join(out)
