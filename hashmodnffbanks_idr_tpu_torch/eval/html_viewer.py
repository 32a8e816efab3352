"""Self-contained HTML 3D scene viewer (zero dependencies).

Parity artifact for the reference's plotly 3D HTML scenes
(utils/plots.py:11-120 in the reference writes `surface_{epoch}.html` via
plotly.offline): one standalone .html file containing the marching-tets mesh,
the camera frusta, and an orbit-controls WebGL viewer — no plotly, no CDN,
works offline in any browser.

Geometry is embedded as base64 Float32/Uint32 buffers (not JSON number
arrays) to keep files small: a 100k-vertex mesh is ~1.6 MB.

A copy of ``hashmodnffbanks_idr_tpu/eval/html_viewer.py``.
"""

from __future__ import annotations

import base64
import json

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 html,body{{margin:0;height:100%;overflow:hidden;background:#111;color:#ddd;
   font:12px sans-serif}}
 #hud{{position:absolute;top:8px;left:10px;user-select:none}}
 canvas{{display:block;width:100vw;height:100vh}}
</style></head><body>
<div id="hud">{title} &mdash; drag: orbit &middot; wheel: zoom &middot;
 shift-drag: pan &middot; c: toggle cameras</div>
<canvas id="c"></canvas>
<script>
"use strict";
const SCENE = {scene_json};
function buf(s, T) {{
  const raw = atob(s), n = raw.length, u8 = new Uint8Array(n);
  for (let i = 0; i < n; i++) u8[i] = raw.charCodeAt(i);
  return new T(u8.buffer);
}}
const verts = buf(SCENE.verts, Float32Array);
const faces = buf(SCENE.faces, Uint32Array);
const camSegs = buf(SCENE.cam_segs, Float32Array);

// --- flat-shaded, per-face expanded buffers (no index -> easy normals)
const nf = faces.length / 3;
const pos = new Float32Array(nf * 9), nrm = new Float32Array(nf * 9);
for (let f = 0; f < nf; f++) {{
  const a = faces[3*f]*3, b = faces[3*f+1]*3, c = faces[3*f+2]*3;
  const ax=verts[a],ay=verts[a+1],az=verts[a+2];
  const bx=verts[b],by=verts[b+1],bz=verts[b+2];
  const cx=verts[c],cy=verts[c+1],cz=verts[c+2];
  const ux=bx-ax,uy=by-ay,uz=bz-az, vx=cx-ax,vy=cy-ay,vz=cz-az;
  let nx=uy*vz-uz*vy, ny=uz*vx-ux*vz, nz=ux*vy-uy*vx;
  const l = Math.hypot(nx,ny,nz) || 1; nx/=l; ny/=l; nz/=l;
  pos.set([ax,ay,az,bx,by,bz,cx,cy,cz], f*9);
  nrm.set([nx,ny,nz,nx,ny,nz,nx,ny,nz], f*9);
}}

const cv = document.getElementById("c");
const gl = cv.getContext("webgl");
function sh(type, src) {{
  const s = gl.createShader(type); gl.shaderSource(s, src); gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(s);
  return s;
}}
function prog(vs, fs) {{
  const p = gl.createProgram();
  gl.attachShader(p, sh(gl.VERTEX_SHADER, vs));
  gl.attachShader(p, sh(gl.FRAGMENT_SHADER, fs));
  gl.linkProgram(p); return p;
}}
const meshProg = prog(
 `attribute vec3 p; attribute vec3 n; uniform mat4 mvp; uniform mat3 nm;
  varying vec3 vn;
  void main(){{ gl_Position = mvp*vec4(p,1.0); vn = nm*n; }}`,
 `precision mediump float; varying vec3 vn;
  void main(){{
    vec3 n = normalize(vn);
    float d = max(dot(n, normalize(vec3(0.4,0.7,1.0))), 0.0);
    float d2 = max(dot(-n, normalize(vec3(0.4,0.7,1.0))), 0.0);
    vec3 c = vec3(0.17,0.45,0.75)*(0.25+0.75*d) + vec3(0.3,0.2,0.1)*0.4*d2;
    gl_FragColor = vec4(c, 1.0);
  }}`);
const lineProg = prog(
 `attribute vec3 p; uniform mat4 mvp;
  void main(){{ gl_Position = mvp*vec4(p,1.0); }}`,
 `precision mediump float; void main(){{ gl_FragColor = vec4(1.0,0.6,0.1,1.0); }}`);

function vbo(data) {{
  const b = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, b);
  gl.bufferData(gl.ARRAY_BUFFER, data, gl.STATIC_DRAW); return b;
}}
const posB = vbo(pos), nrmB = vbo(nrm), camB = vbo(camSegs);

// --- tiny mat4 lib (column-major)
function persp(fov, asp, zn, zf) {{
  const f = 1/Math.tan(fov/2), m = new Float32Array(16);
  m[0]=f/asp; m[5]=f; m[10]=(zf+zn)/(zn-zf); m[11]=-1;
  m[14]=2*zf*zn/(zn-zf); return m;
}}
function mul(a, b) {{
  const o = new Float32Array(16);
  for (let i=0;i<4;i++) for (let j=0;j<4;j++) {{
    let s=0; for (let k=0;k<4;k++) s += a[k*4+j]*b[i*4+k]; o[i*4+j]=s;
  }}
  return o;
}}
let theta = 0.8, phi = 1.0, dist = SCENE.radius*3, panX=0, panY=0, showCams=true;
const ctr = SCENE.center;
function view() {{
  const ct=Math.cos(theta), st=Math.sin(theta), cp=Math.cos(phi), sp=Math.sin(phi);
  const eye=[ctr[0]+dist*sp*ct, ctr[1]+dist*cp, ctr[2]+dist*sp*st];
  const f=[ctr[0]-eye[0],ctr[1]-eye[1],ctr[2]-eye[2]];
  const fl=Math.hypot(...f); f[0]/=fl;f[1]/=fl;f[2]/=fl;
  const up=[0,1,0];
  const s=[f[1]*up[2]-f[2]*up[1], f[2]*up[0]-f[0]*up[2], f[0]*up[1]-f[1]*up[0]];
  const sl=Math.hypot(...s)||1; s[0]/=sl;s[1]/=sl;s[2]/=sl;
  const u=[s[1]*f[2]-s[2]*f[1], s[2]*f[0]-s[0]*f[2], s[0]*f[1]-s[1]*f[0]];
  const m=new Float32Array(16);
  m[0]=s[0];m[4]=s[1];m[8]=s[2];
  m[1]=u[0];m[5]=u[1];m[9]=u[2];
  m[2]=-f[0];m[6]=-f[1];m[10]=-f[2];
  m[12]=-(s[0]*eye[0]+s[1]*eye[1]+s[2]*eye[2])+panX;
  m[13]=-(u[0]*eye[0]+u[1]*eye[1]+u[2]*eye[2])+panY;
  m[14]= (f[0]*eye[0]+f[1]*eye[1]+f[2]*eye[2]);
  m[15]=1; return m;
}}
function draw() {{
  const w=cv.clientWidth, h=cv.clientHeight;
  if (cv.width!==w||cv.height!==h){{cv.width=w;cv.height=h;}}
  gl.viewport(0,0,w,h);
  gl.enable(gl.DEPTH_TEST);
  gl.clearColor(0.07,0.07,0.08,1);
  gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  const V = view();
  const mvp = mul(persp(0.9, w/h, SCENE.radius*0.01, SCENE.radius*100), V);
  gl.useProgram(meshProg);
  gl.uniformMatrix4fv(gl.getUniformLocation(meshProg,"mvp"), false, mvp);
  const nm = new Float32Array([V[0],V[1],V[2],V[4],V[5],V[6],V[8],V[9],V[10]]);
  gl.uniformMatrix3fv(gl.getUniformLocation(meshProg,"nm"), false, nm);
  let loc = gl.getAttribLocation(meshProg,"p");
  gl.bindBuffer(gl.ARRAY_BUFFER, posB);
  gl.enableVertexAttribArray(loc); gl.vertexAttribPointer(loc,3,gl.FLOAT,false,0,0);
  loc = gl.getAttribLocation(meshProg,"n");
  gl.bindBuffer(gl.ARRAY_BUFFER, nrmB);
  gl.enableVertexAttribArray(loc); gl.vertexAttribPointer(loc,3,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.TRIANGLES, 0, nf*3);
  if (showCams && camSegs.length) {{
    gl.useProgram(lineProg);
    gl.uniformMatrix4fv(gl.getUniformLocation(lineProg,"mvp"), false, mvp);
    loc = gl.getAttribLocation(lineProg,"p");
    gl.bindBuffer(gl.ARRAY_BUFFER, camB);
    gl.enableVertexAttribArray(loc); gl.vertexAttribPointer(loc,3,gl.FLOAT,false,0,0);
    gl.drawArrays(gl.LINES, 0, camSegs.length/3);
  }}
  requestAnimationFrame(draw);
}}
let drag=false, px=0, py=0, shift=false;
cv.onmousedown = e => {{drag=true;px=e.clientX;py=e.clientY;shift=e.shiftKey;}};
window.onmouseup = () => drag=false;
window.onmousemove = e => {{
  if (!drag) return;
  const dx=e.clientX-px, dy=e.clientY-py; px=e.clientX; py=e.clientY;
  if (shift) {{ panX += dx*dist*0.002; panY -= dy*dist*0.002; }}
  else {{
    theta += dx*0.01;
    phi = Math.min(Math.PI-0.01, Math.max(0.01, phi - dy*0.01));
  }}
}};
cv.onwheel = e => {{ dist *= Math.exp(e.deltaY*0.001); e.preventDefault(); }};
window.onkeydown = e => {{ if (e.key==="c") showCams=!showCams; }};
requestAnimationFrame(draw);
</script></body></html>
"""


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode("ascii")


def _camera_segments(poses: np.ndarray, scale: float) -> np.ndarray:
    """Wireframe frusta as line segments (pairs of endpoints), (S*2, 3)."""
    segs = []
    for p in np.asarray(poses, dtype=np.float32):
        c = p[:3, 3]
        x, y, z = p[:3, 0], p[:3, 1], p[:3, 2]
        corners = [c + scale * (z + sx * 0.6 * x + sy * 0.45 * y)
                   for sx, sy in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
        for i in range(4):
            segs += [c, corners[i]]                      # apex -> corner
            segs += [corners[i], corners[(i + 1) % 4]]   # rim
    if not segs:
        return np.zeros((0, 3), dtype=np.float32)
    return np.asarray(segs, dtype=np.float32)


def write_scene_html(
    path: str,
    verts: np.ndarray,
    faces: np.ndarray,
    poses: np.ndarray | None = None,
    title: str = "surface",
    cam_scale: float = 0.15,
) -> None:
    """Write a standalone interactive 3D viewer for one mesh + camera rig.

    Drop-in role of the reference's `plt.offline.plot(fig, filename=...)`
    surface scenes — open the file in a browser, no server or network.
    """
    verts = np.asarray(verts, dtype=np.float32).reshape(-1, 3)
    faces = np.asarray(faces, dtype=np.uint32).reshape(-1, 3)
    poses = np.zeros((0, 4, 4), np.float32) if poses is None else poses
    if len(verts):
        lo, hi = verts.min(axis=0), verts.max(axis=0)
        center = ((lo + hi) / 2).tolist()
        radius = float(np.linalg.norm(hi - lo) / 2) or 1.0
    else:
        center, radius = [0.0, 0.0, 0.0], 1.0
    scene = {
        "verts": _b64(verts),
        "faces": _b64(faces),
        "cam_segs": _b64(_camera_segments(poses, cam_scale)),
        "center": center,
        "radius": radius,
    }
    import html as _html

    html = _TEMPLATE.format(title=_html.escape(title), scene_json=json.dumps(scene))
    with open(path, "w") as f:
        f.write(html)
