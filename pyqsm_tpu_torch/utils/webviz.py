"""Self-contained interactive 3D viewer export (counterpart of
``pyqsm_tpu/utils/webviz.py``, numpy on the host): one ``.html`` file with
an inline WebGL renderer and the data embedded base64, which opens in any
browser — orbit/pan/zoom, per-point label or RGB colouring, a point-size
slider, mesh and QSM-cylinder layers with headlight shading, and layer
toggles. Tensors (on any device) are read back to numpy first.
"""

from __future__ import annotations

import base64
import json
from pathlib import Path

import numpy as np
import torch

# 12 visually-distinct label colors (cycled); label -1 renders dim gray
_PALETTE = np.array([
    [230, 110, 60], [60, 150, 230], [90, 200, 110], [230, 200, 60],
    [170, 110, 230], [230, 120, 180], [110, 220, 220], [250, 160, 90],
    [140, 180, 70], [100, 120, 240], [220, 90, 90], [90, 230, 170],
], np.uint8)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()


def _cylinder_mesh_np(center, axis, height, radius, n_seg: int = 12):
    """Host-side lateral-surface triangulation of one cylinder."""
    axis = axis / max(float(np.linalg.norm(axis)), 1e-9)
    ref = np.array([0.0, 0, 1]) if abs(axis[2]) < 0.9 else np.array([1.0, 0, 0])
    u = np.cross(axis, ref)
    u /= max(float(np.linalg.norm(u)), 1e-9)
    v = np.cross(axis, u)
    th = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    ring = (np.outer(np.cos(th), u) + np.outer(np.sin(th), v)) * radius
    lo = center - 0.5 * height * axis
    hi = center + 0.5 * height * axis
    verts = np.concatenate([lo + ring, hi + ring]).astype(np.float32)
    i = np.arange(n_seg)
    j = (i + 1) % n_seg
    tris = np.concatenate([
        np.stack([i, j, i + n_seg], 1),
        np.stack([j, j + n_seg, i + n_seg], 1),
    ]).astype(np.int32)
    return verts, tris


def export_viewer(
    path: str | Path,
    points: np.ndarray | None = None,
    labels: np.ndarray | None = None,
    colors: np.ndarray | None = None,
    mesh_vertices: np.ndarray | None = None,
    mesh_triangles: np.ndarray | None = None,
    cylinders=None,
    title: str = "pyqsm_tpu viewer",
    max_points: int = 2_000_000,
) -> Path:
    """Write a standalone interactive HTML viewer.

    ``points`` [N,3]; ``labels`` [N] int (colored by palette, -1 = gray) or
    ``colors`` [N,3] float/uint8 RGB; ``mesh_vertices``/``mesh_triangles``
    a triangle mesh layer; ``cylinders`` a ``state.Cylinders`` batch (QSM
    output — rendered as capped tubes). Clouds larger than ``max_points``
    are uniformly subsampled (noted in the UI)."""
    layers = []
    note = ""

    if points is not None:
        pts = _np(points).astype(np.float32, copy=False)
        n = len(pts)
        keep = None
        if n > max_points:
            keep = np.linspace(0, n - 1, max_points).astype(np.int64)
            pts = pts[keep]
            note = f"subsampled {len(pts):,} of {n:,} points"
        if colors is not None:
            col = _np(colors)
            if keep is not None:
                col = col[keep]
            if col.dtype != np.uint8:
                cmax = float(col.max()) if col.size else 1.0
                col = (col * (255.0 if cmax <= 1.0 else 1.0)).clip(0, 255)
                col = col.astype(np.uint8)
        elif labels is not None:
            lab = _np(labels).astype(np.int64)
            if keep is not None:
                lab = lab[keep]
            col = np.where(
                lab[:, None] >= 0,
                _PALETTE[np.abs(lab) % len(_PALETTE)],
                np.uint8(90),
            ).astype(np.uint8)
        else:
            col = np.full((len(pts), 3), 200, np.uint8)
        layers.append(dict(
            kind="points", name="cloud",
            pos=_b64(pts), col=_b64(col), n=len(pts),
        ))

    if mesh_vertices is not None and mesh_triangles is not None:
        mv = _np(mesh_vertices).astype(np.float32, copy=False)
        mt = _np(mesh_triangles).astype(np.int32, copy=False)
        mt = mt[mt[:, 0] >= 0]
        layers.append(dict(
            kind="mesh", name="mesh",
            pos=_b64(mv[mt.reshape(-1)]), n=mt.size,
            rgb=[140, 190, 140],
        ))

    if cylinders is not None:
        c = cylinders
        m = _np(c.mask)
        center, axis, height, radius = (_np(a) for a in (c.center, c.axis, c.height,
                                                          c.radius))
        verts_all, tris_all = [], []
        off = 0
        for i in np.flatnonzero(m):
            v_, t_ = _cylinder_mesh_np(center[i], axis[i], float(height[i]),
                                       float(radius[i]))
            verts_all.append(v_)
            tris_all.append(t_ + off)
            off += len(v_)
        if verts_all:
            mv = np.concatenate(verts_all)
            mt = np.concatenate(tris_all)
            layers.append(dict(
                kind="mesh", name=f"qsm ({int(m.sum())} cylinders)",
                pos=_b64(mv[mt.reshape(-1)]), n=mt.size,
                rgb=[205, 133, 63],
            ))

    if not layers:
        raise ValueError("export_viewer: nothing to render")

    # scene center/extent for the initial camera
    first = layers[0]
    buf = np.frombuffer(base64.b64decode(first["pos"]),
                        np.float32).reshape(-1, 3)
    center = buf.mean(0).tolist()
    extent = float(np.abs(buf - buf.mean(0)).max()) * 2.0 + 1e-6

    html = _TEMPLATE.replace("__TITLE__", title) \
        .replace("__NOTE__", note) \
        .replace("__LAYERS__", json.dumps(layers)) \
        .replace("__CENTER__", json.dumps(center)) \
        .replace("__EXTENT__", repr(extent))
    out = Path(path)
    out.write_text(html)
    return out


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
html,body{margin:0;height:100%;background:#15171c;color:#cfd3dc;
font:13px system-ui,sans-serif;overflow:hidden}
#hud{position:fixed;top:10px;left:10px;background:rgba(20,22,28,.85);
padding:10px 14px;border-radius:8px;max-width:280px}
#hud h1{font-size:14px;margin:0 0 6px}
#hud label{display:block;margin:4px 0;cursor:pointer}
#hud .note{color:#8b93a3;font-size:11px}
canvas{display:block;width:100vw;height:100vh}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"><h1>__TITLE__</h1>
<div id="toggles"></div>
<label>point size <input id="psz" type="range" min="1" max="8" value="2"></label>
<div class="note">__NOTE__</div>
<div class="note">drag orbit &middot; shift-drag pan &middot; wheel zoom</div>
</div>
<script>
"use strict";
const LAYERS=__LAYERS__, CENTER=__CENTER__, EXTENT=__EXTENT__;
const cv=document.getElementById("c"),
      gl=cv.getContext("webgl",{antialias:true});
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
gl.compileShader(o);if(!gl.getShaderParameter(o,gl.COMPILE_STATUS))
throw gl.getShaderInfoLog(o);return o}
function prog(vs,fs){const p=gl.createProgram();
gl.attachShader(p,sh(gl.VERTEX_SHADER,vs));
gl.attachShader(p,sh(gl.FRAGMENT_SHADER,fs));gl.linkProgram(p);return p}
const PV=`attribute vec3 p;attribute vec3 c;uniform mat4 mvp;
uniform float ps;varying vec3 vc;void main(){gl_Position=mvp*vec4(p,1.);
gl_PointSize=ps;vc=c;}`;
const PF=`precision mediump float;varying vec3 vc;
void main(){gl_FragColor=vec4(vc,1.);}`;
const MV=`attribute vec3 p;uniform mat4 mvp;varying vec3 wp;
void main(){gl_Position=mvp*vec4(p,1.);wp=p;}`;
const hasDer=!!gl.getExtension("OES_standard_derivatives");
const MF=(hasDer?
`#extension GL_OES_standard_derivatives : enable
precision mediump float;uniform vec3 rgb;uniform vec3 eye;
varying vec3 wp;void main(){vec3 nx=normalize(cross(dFdx(wp),dFdy(wp)));
float l=.35+.65*abs(dot(nx,normalize(eye-wp)));
gl_FragColor=vec4(rgb*l,1.);}`:
`precision mediump float;uniform vec3 rgb;uniform vec3 eye;varying vec3 wp;
void main(){gl_FragColor=vec4(rgb,1.);}`);
const pp=prog(PV,PF), mp=prog(MV,MF);
function b64f(s){const b=atob(s),a=new Uint8Array(b.length);
for(let i=0;i<b.length;i++)a[i]=b.charCodeAt(i);return a}
const objs=[];
for(const L of LAYERS){
  const pos=gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER,pos);
  gl.bufferData(gl.ARRAY_BUFFER,b64f(L.pos),gl.STATIC_DRAW);
  let col=null;
  if(L.kind==="points"){col=gl.createBuffer();
    gl.bindBuffer(gl.ARRAY_BUFFER,col);
    gl.bufferData(gl.ARRAY_BUFFER,b64f(L.col),gl.STATIC_DRAW);}
  objs.push({L,pos,col,on:true});
}
const tg=document.getElementById("toggles");
objs.forEach((o,i)=>{const l=document.createElement("label");
const cb=document.createElement("input");cb.type="checkbox";cb.checked=true;
cb.onchange=()=>{o.on=cb.checked;draw()};
l.appendChild(cb);l.appendChild(document.createTextNode(" "+o.L.name));
tg.appendChild(l);});
let az=.7,el=.5,dist=EXTENT*1.3,tgt=CENTER.slice(),psz=2;
document.getElementById("psz").oninput=e=>{psz=+e.target.value;draw()};
function mat(){
  const ce=Math.cos(el),se=Math.sin(el),ca=Math.cos(az),sa=Math.sin(az);
  const eye=[tgt[0]+dist*ce*ca,tgt[1]+dist*ce*sa,tgt[2]+dist*se];
  const f=norm3(sub3(tgt,eye)),r=norm3(cross3(f,[0,0,1])),u=cross3(r,f);
  const V=[r[0],u[0],-f[0],0, r[1],u[1],-f[1],0, r[2],u[2],-f[2],0,
    -dot3(r,eye),-dot3(u,eye),dot3(f,eye),1];
  const a=cv.width/cv.height,fv=1/Math.tan(.4),
    n=EXTENT*.001,fr=EXTENT*20;
  const P=[fv/a,0,0,0, 0,fv,0,0, 0,0,(fr+n)/(n-fr),-1, 0,0,2*fr*n/(n-fr),0];
  return {mvp:mul44(P,V),eye};
}
function sub3(a,b){return[a[0]-b[0],a[1]-b[1],a[2]-b[2]]}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2]}
function cross3(a,b){return[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
a[0]*b[1]-a[1]*b[0]]}
function norm3(a){const l=Math.hypot(a[0],a[1],a[2])||1;
return[a[0]/l,a[1]/l,a[2]/l]}
function mul44(A,B){const o=new Array(16);
for(let c=0;c<4;c++)for(let r=0;r<4;r++){let s=0;
for(let k=0;k<4;k++)s+=A[k*4+r]*B[c*4+k];o[c*4+r]=s}return o}
function draw(){
  cv.width=innerWidth*devicePixelRatio;cv.height=innerHeight*devicePixelRatio;
  gl.viewport(0,0,cv.width,cv.height);
  gl.clearColor(.082,.090,.11,1);gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  const {mvp,eye}=mat();
  for(const o of objs){if(!o.on)continue;
    if(o.L.kind==="points"){
      gl.useProgram(pp);
      gl.uniformMatrix4fv(gl.getUniformLocation(pp,"mvp"),false,mvp);
      gl.uniform1f(gl.getUniformLocation(pp,"ps"),psz*devicePixelRatio);
      const ap=gl.getAttribLocation(pp,"p"),ac=gl.getAttribLocation(pp,"c");
      gl.bindBuffer(gl.ARRAY_BUFFER,o.pos);
      gl.enableVertexAttribArray(ap);
      gl.vertexAttribPointer(ap,3,gl.FLOAT,false,0,0);
      gl.bindBuffer(gl.ARRAY_BUFFER,o.col);
      gl.enableVertexAttribArray(ac);
      gl.vertexAttribPointer(ac,3,gl.UNSIGNED_BYTE,true,0,0);
      gl.drawArrays(gl.POINTS,0,o.L.n);
    }else{
      gl.useProgram(mp);
      gl.uniformMatrix4fv(gl.getUniformLocation(mp,"mvp"),false,mvp);
      gl.uniform3fv(gl.getUniformLocation(mp,"rgb"),
        o.L.rgb.map(x=>x/255));
      gl.uniform3fv(gl.getUniformLocation(mp,"eye"),eye);
      const ap=gl.getAttribLocation(mp,"p");
      gl.bindBuffer(gl.ARRAY_BUFFER,o.pos);
      gl.enableVertexAttribArray(ap);
      gl.vertexAttribPointer(ap,3,gl.FLOAT,false,0,0);
      gl.drawArrays(gl.TRIANGLES,0,o.L.n);
    }
  }
}
let drag=null;
cv.onmousedown=e=>drag={x:e.clientX,y:e.clientY,pan:e.shiftKey};
onmouseup=()=>drag=null;
onmousemove=e=>{if(!drag)return;
  const dx=e.clientX-drag.x,dy=e.clientY-drag.y;
  if(drag.pan){const ce=Math.cos(el),ca=Math.cos(az),sa=Math.sin(az);
    const r=[-sa,ca,0],u=[-Math.sin(el)*ca,-Math.sin(el)*sa,Math.cos(el)];
    const s=dist*.0015;
    for(let i=0;i<3;i++)tgt[i]+=(-dx*r[i]+dy*u[i])*s;
  }else{az-=dx*.008;el=Math.min(1.5,Math.max(-1.5,el+dy*.008));}
  drag={x:e.clientX,y:e.clientY,pan:drag.pan};draw()};
cv.onwheel=e=>{e.preventDefault();dist*=Math.exp(e.deltaY*.001);draw()};
onresize=draw;
draw();
</script></body></html>
"""
