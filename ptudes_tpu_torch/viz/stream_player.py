"""Self-contained WebGL2 raw-stream player (export + inline HTML), a copy
of ``ptudes_tpu.viz.stream_player``.

It reproduces the reference's live ``ptudes viz`` experience (channel
image strip + 3D point cloud playing at sensor rate with pause/rate
keys, ``src/ptudes/cli/viz.py:49-62``) as a browser player over blobs
exported by :func:`export_stream`. The 3D view re-projects
every frame on the GPU from a u16 range texture and the sensor's
direction/offset LUT, so playback is one small texture upload per scan.
The command's ``viz --serve`` and ``--stream-dir`` write it.
"""
import functools
import http.server
import json
import os

import numpy as np

RANGE_UNIT_M = 0.002  # u16 export unit: 2 mm steps -> 131 m max

HTML = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>ptudes-tpu stream</title>
<style>
 body{margin:0;background:#0e0e12;color:#ddd;font:13px monospace;overflow:hidden}
 #hud{position:absolute;left:10px;top:10px;white-space:pre;pointer-events:none}
 #help{position:absolute;right:10px;top:10px;text-align:right;color:#888}
 canvas{display:block}
</style></head><body>
<div id="hud"></div>
<div id="help">space play/pause | &larr;/&rarr; step | &uarr;/&darr; rate |
f channel<br>drag orbit | wheel zoom</div>
<canvas id="c"></canvas>
<script>
"use strict";
const canvas=document.getElementById("c");
const gl=canvas.getContext("webgl2");
const hud=document.getElementById("hud");
function mat4mul(a,b){const o=new Float32Array(16);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
  for(let k=0;k<4;k++)s+=a[k*4+j]*b[i*4+k];o[i*4+j]=s;}return o;}
function persp(f,asp,n,fr){const t=1/Math.tan(f/2);const o=new Float32Array(16);
 o[0]=t/asp;o[5]=t;o[10]=(fr+n)/(n-fr);o[11]=-1;o[14]=2*fr*n/(n-fr);return o;}
function lookAtOrbit(az,el,r){
 const ce=Math.cos(el),se=Math.sin(el),ca=Math.cos(az),sa=Math.sin(az);
 const eye=[r*ce*ca,r*ce*sa,r*se];
 const f=[-ce*ca,-ce*sa,-se];const up=[0,0,1];
 const s=[f[1]*up[2]-f[2]*up[1],f[2]*up[0]-f[0]*up[2],f[0]*up[1]-f[1]*up[0]];
 const sl=Math.hypot(s[0],s[1],s[2])||1;s[0]/=sl;s[1]/=sl;s[2]/=sl;
 const u=[s[1]*f[2]-s[2]*f[1],s[2]*f[0]-s[0]*f[2],s[0]*f[1]-s[1]*f[0]];
 const d=(a,b)=>a[0]*b[0]+a[1]*b[1]+a[2]*b[2];
 return new Float32Array([s[0],u[0],-f[0],0, s[1],u[1],-f[1],0,
  s[2],u[2],-f[2],0, -d(s,eye),-d(u,eye),d(f,eye),1]);}
function compile(t,s){const sh=gl.createShader(t);gl.shaderSource(sh,s);
 gl.compileShader(sh);if(!gl.getShaderParameter(sh,gl.COMPILE_STATUS))
 throw gl.getShaderInfoLog(sh);return sh;}
function prog(vs,fs){const p=gl.createProgram();
 p.vs=compile(gl.VERTEX_SHADER,vs);p.fs=compile(gl.FRAGMENT_SHADER,fs);
 gl.attachShader(p,p.vs);gl.attachShader(p,p.fs);gl.linkProgram(p);
 if(!gl.getProgramParameter(p,gl.LINK_STATUS))throw gl.getProgramInfoLog(p);
 return p;}
// viridis-ish ramp shared by both shaders
const RAMP=`vec3 ramp(float t){t=clamp(t,0.0,1.0);
 return vec3(clamp(1.8*t-0.84,0.0,0.98)*t+0.27*(1.0-t),
             clamp(1.6*t*(1.0-0.45*t)+0.1,0.0,1.0)*0.9,
             clamp(1.1-1.4*t,0.12,0.86));}`;
const cloudVS=`#version 300 es
uniform highp usampler2D rng; uniform highp usampler2D fld;
uniform sampler2D dir; uniform sampler2D off;
uniform mat4 mvp; uniform int W; uniform float scale;
uniform int useField; uniform float fmax;
out float v;
void main(){
 int col=gl_VertexID % W, row=gl_VertexID / W;
 ivec2 px=ivec2(col,row);
 float r=float(texelFetch(rng,px,0).r)*scale;
 if(r<=0.0){gl_Position=vec4(2.0,2.0,2.0,1.0);gl_PointSize=0.0;v=0.0;return;}
 vec3 d=texelFetch(dir,px,0).rgb, o=texelFetch(off,px,0).rgb;
 gl_Position=mvp*vec4(d*r+o,1.0);
 gl_PointSize=1.8;
 v=(useField==1)?float(texelFetch(fld,px,0).r)/fmax:r/60.0;}`;
const cloudFS=`#version 300 es
precision mediump float; in float v; out vec4 o;
`+RAMP+`
void main(){o=vec4(ramp(v),1.0);}`;
const imgVS=`#version 300 es
const vec2 q[4]=vec2[4](vec2(-1.,1.),vec2(1.,1.),vec2(-1.,0.),vec2(1.,0.));
out vec2 uv;
void main(){vec2 p=q[gl_VertexID];
 uv=vec2(p.x*0.5+0.5,p.y);           // y in [0,1] of the strip
 float top=1.0-p.y*STRIP;            // strip height as clip fraction
 gl_Position=vec4(p.x,1.0-(1.0-p.y)*STRIP*2.0,0.0,1.0);}`;
const imgFS=`#version 300 es
precision mediump float;
uniform highp usampler2D rng; uniform highp usampler2D fld;
uniform int W; uniform int H; uniform float scale;
uniform int useField; uniform float fmax;
in vec2 uv; out vec4 o;
`+RAMP+`
void main(){
 ivec2 px=ivec2(int(uv.x*float(W)),int((1.0-uv.y)*float(H)));
 float v=(useField==1)
   ?float(texelFetch(fld,px,0).r)/fmax
   :float(texelFetch(rng,px,0).r)*scale/60.0;
 o=vec4(ramp(v)*0.95,1.0);}`;

let meta=null,ranges=null,fields={},fieldNames=["range"],fieldIdx=0;
let dirTex=null,offTex=null,rngTex=null,fldTex=null;
let cur=-1,t=0,playing=true,rate=1.0,last=null;
let az=2.3,el=0.5,dist=40;
const pCloud=prog(cloudVS,cloudFS);
const STRIP=0.22;
const pImg=prog(imgVS.replace(/STRIP/g,STRIP.toFixed(3)),
                imgFS);
function makeTex(ifmt,w,h,fmt,type,data){
 const tx=gl.createTexture();gl.bindTexture(gl.TEXTURE_2D,tx);
 gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_MIN_FILTER,gl.NEAREST);
 gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_MAG_FILTER,gl.NEAREST);
 gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_WRAP_S,gl.CLAMP_TO_EDGE);
 gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_WRAP_T,gl.CLAMP_TO_EDGE);
 gl.texStorage2D(gl.TEXTURE_2D,1,ifmt,w,h);
 if(data)gl.texSubImage2D(gl.TEXTURE_2D,0,0,0,w,h,fmt,type,data);
 return tx;}
function uploadScan(i){
 const {h,w}=meta;const n=h*w;
 gl.bindTexture(gl.TEXTURE_2D,rngTex);
 gl.texSubImage2D(gl.TEXTURE_2D,0,0,0,w,h,gl.RED_INTEGER,
  gl.UNSIGNED_SHORT,ranges.subarray(i*n,(i+1)*n));
 const fn=fieldNames[fieldIdx];
 if(fn!=="range"&&fields[fn]){
  gl.bindTexture(gl.TEXTURE_2D,fldTex);
  gl.texSubImage2D(gl.TEXTURE_2D,0,0,0,w,h,gl.RED_INTEGER,
   gl.UNSIGNED_SHORT,fields[fn].subarray(i*n,(i+1)*n));}
 cur=i;}
function scanAt(tt){
 const ts=meta.scan_ts;let lo=0,hi=ts.length-1;
 if(tt<=ts[0])return 0;if(tt>=ts[hi])return hi;
 while(hi-lo>1){const m=(lo+hi)>>1;if(ts[m]<=tt)lo=m;else hi=m;}
 return lo;}
function draw(){
 const w=canvas.clientWidth,h=canvas.clientHeight;
 if(canvas.width!==w||canvas.height!==h){canvas.width=w;canvas.height=h;}
 gl.viewport(0,0,w,h);
 gl.clearColor(0.055,0.055,0.07,1);gl.clear(gl.COLOR_BUFFER_BIT);
 const i=scanAt(t);
 if(i!==cur)uploadScan(i);
 const useField=fieldNames[fieldIdx]!=="range"?1:0;
 const fmax=meta.field_max[fieldNames[fieldIdx]]||1.0;
 // 3D cloud (below the strip)
 gl.useProgram(pCloud);
 const mvp=mat4mul(persp(1.0,w/h,0.1,400),lookAtOrbit(az,el,dist));
 gl.uniformMatrix4fv(gl.getUniformLocation(pCloud,"mvp"),false,mvp);
 gl.uniform1i(gl.getUniformLocation(pCloud,"W"),meta.w);
 gl.uniform1f(gl.getUniformLocation(pCloud,"scale"),meta.range_unit_m);
 gl.uniform1i(gl.getUniformLocation(pCloud,"useField"),useField);
 gl.uniform1f(gl.getUniformLocation(pCloud,"fmax"),fmax);
 gl.activeTexture(gl.TEXTURE0);gl.bindTexture(gl.TEXTURE_2D,rngTex);
 gl.uniform1i(gl.getUniformLocation(pCloud,"rng"),0);
 gl.activeTexture(gl.TEXTURE1);gl.bindTexture(gl.TEXTURE_2D,dirTex);
 gl.uniform1i(gl.getUniformLocation(pCloud,"dir"),1);
 gl.activeTexture(gl.TEXTURE2);gl.bindTexture(gl.TEXTURE_2D,offTex);
 gl.uniform1i(gl.getUniformLocation(pCloud,"off"),2);
 gl.activeTexture(gl.TEXTURE3);gl.bindTexture(gl.TEXTURE_2D,fldTex);
 gl.uniform1i(gl.getUniformLocation(pCloud,"fld"),3);
 gl.drawArrays(gl.POINTS,0,meta.h*meta.w);
 // 2D strip (already destaggered at export)
 gl.useProgram(pImg);
 gl.uniform1i(gl.getUniformLocation(pImg,"W"),meta.w);
 gl.uniform1i(gl.getUniformLocation(pImg,"H"),meta.h);
 gl.uniform1f(gl.getUniformLocation(pImg,"scale"),meta.range_unit_m);
 gl.uniform1i(gl.getUniformLocation(pImg,"useField"),useField);
 gl.uniform1f(gl.getUniformLocation(pImg,"fmax"),fmax);
 gl.activeTexture(gl.TEXTURE0);gl.bindTexture(gl.TEXTURE_2D,rngTex);
 gl.uniform1i(gl.getUniformLocation(pImg,"rng"),0);
 gl.activeTexture(gl.TEXTURE3);gl.bindTexture(gl.TEXTURE_2D,fldTex);
 gl.uniform1i(gl.getUniformLocation(pImg,"fld"),3);
 gl.drawArrays(gl.TRIANGLE_STRIP,0,4);
 const ts=meta.scan_ts;
 hud.textContent=`scan ${i+1}/${ts.length}  t ${t.toFixed(2)} s  `+
  `${playing?"playing":"paused"}  rate x${rate}\n`+
  `channel ${fieldNames[fieldIdx]}  ${meta.h}x${meta.w}`;}
function tick(now){
 const ts=meta.scan_ts,t0=ts[0],t1=ts[ts.length-1];
 if(last!==null&&playing){t+=(now-last)/1000*rate;
  if(t>t1)t=t0;}
 last=now;draw();requestAnimationFrame(tick);}
window.addEventListener("keydown",e=>{
 const ts=meta.scan_ts;
 if(e.key===" ")playing=!playing;
 else if(e.key==="ArrowRight"){
  playing=false;t=ts[Math.min(ts.length-1,scanAt(t)+(e.shiftKey?10:1))];}
 else if(e.key==="ArrowLeft"){
  playing=false;t=ts[Math.max(0,scanAt(t)-(e.shiftKey?10:1))];}
 else if(e.key==="ArrowUp")rate=Math.min(16,rate*2);
 else if(e.key==="ArrowDown")rate=Math.max(0.125,rate/2);
 else if(e.key==="f"){fieldIdx=(fieldIdx+1)%fieldNames.length;cur=-1;}
 else return; e.preventDefault();});
let dragging=false,lx=0,ly=0;
canvas.addEventListener("mousedown",e=>{dragging=true;lx=e.clientX;ly=e.clientY;});
window.addEventListener("mouseup",()=>dragging=false);
window.addEventListener("mousemove",e=>{if(!dragging)return;
 az-=(e.clientX-lx)*0.008;
 el=Math.max(-1.5,Math.min(1.5,el+(e.clientY-ly)*0.008));
 lx=e.clientX;ly=e.clientY;});
canvas.addEventListener("wheel",e=>{dist*=Math.exp(e.deltaY*0.001);
 e.preventDefault();});
(async()=>{
 meta=await (await fetch("stream.json")).json();
 const {h,w,n}=meta;
 ranges=new Uint16Array(await (await fetch("ranges.bin")).arrayBuffer());
 const dirs=new Float32Array(await (await fetch("dirs.bin")).arrayBuffer());
 const offs=new Float32Array(await (await fetch("offs.bin")).arrayBuffer());
 for(const f of meta.fields){
  fields[f]=new Uint16Array(
   await (await fetch("f_"+f+".bin")).arrayBuffer());
  fieldNames.push(f);}
 dirTex=makeTex(gl.RGBA32F,w,h,gl.RGBA,gl.FLOAT,dirs);
 offTex=makeTex(gl.RGBA32F,w,h,gl.RGBA,gl.FLOAT,offs);
 rngTex=makeTex(gl.R16UI,w,h,gl.RED_INTEGER,gl.UNSIGNED_SHORT,null);
 fldTex=makeTex(gl.R16UI,w,h,gl.RED_INTEGER,gl.UNSIGNED_SHORT,null);
 t=meta.scan_ts[0];
 // CLI-seeded initial playback rate; 0 = start paused (ptudes viz -r 0)
 if(typeof meta.rate==="number"){
  if(meta.rate===0){playing=false;rate=1.0;}
  else rate=meta.rate;}
 requestAnimationFrame(tick);
})();
</script></body></html>
"""


def export_stream(out_dir, info, scans, keep_fields=True, rate=1.0):
    """Write the player + binary stream blobs. Returns the HTML path.

    ``rate`` seeds the player's initial playback rate (the reference's
    ``ptudes viz -r``, ``src/ptudes/cli/viz.py:24-29``); ``rate=0`` uses
    the reference's start-paused convention (paused at scan 0, rate x1).

    Everything is exported DESTAGGERED (per-row roll by
    ``pixel_shift_by_row``) — ranges, extra channels, and the direction/
    offset LUT get the SAME permutation, so the 2D panel is spatially
    coherent while the 3D projection stays exact (the roll reorders
    (range, dir, off) triplets together)."""
    from ..ops.projection import make_xyz_lut_np

    os.makedirs(out_dir, exist_ok=True)
    h, w = info.h, info.w
    n = len(scans)
    # SensorInfo constructed directly (not via read_metadata_json) may
    # carry an empty/short shift list — missing shifts mean 0
    raw_shifts = np.asarray(info.pixel_shift_by_row or [], np.int64)
    shifts = np.zeros(h, np.int64)
    shifts[:min(h, raw_shifts.size)] = raw_shifts[:h]
    shifts %= w

    def destag(img):  # [..., H, W] roll each row by its shift
        out = np.empty_like(img)
        for r in range(h):
            out[..., r, :] = np.roll(img[..., r, :], shifts[r], axis=-1)
        return out

    rng_u16 = np.clip(np.round(
        np.asarray(scans.range_mm, np.float64) * (0.001 / RANGE_UNIT_M)),
        0, 65535).astype(np.uint16)
    destag(rng_u16).tofile(os.path.join(out_dir, "ranges.bin"))

    direction, offset = make_xyz_lut_np(
        w, h, info.beam_altitude_angles, info.beam_azimuth_angles,
        info.lidar_origin_to_beam_origin_mm,
        info.lidar_to_sensor_transform)

    def pad4(a3):  # [H, W, 3] -> RGBA32F-friendly [H, W, 4]
        return np.concatenate(
            [a3, np.zeros(a3.shape[:-1] + (1,), a3.dtype)], axis=-1)

    dirs = destag(np.moveaxis(np.asarray(direction, np.float32), -1, 0))
    offs = destag(np.moveaxis(np.asarray(offset, np.float32), -1, 0))
    pad4(np.moveaxis(dirs, 0, -1)).astype("<f4").tofile(
        os.path.join(out_dir, "dirs.bin"))
    pad4(np.moveaxis(offs, 0, -1)).astype("<f4").tofile(
        os.path.join(out_dir, "offs.bin"))

    field_names, field_max = [], {}
    if keep_fields and scans.fields:
        for name, img in sorted(scans.fields.items()):
            if name.startswith("range"):
                u16 = np.clip(np.round(
                    img.astype(np.float64) * (0.001 / RANGE_UNIT_M)),
                    0, 65535).astype(np.uint16)
            else:
                u16 = np.clip(img.astype(np.float64), 0,
                              65535).astype(np.uint16)
            destag(u16).tofile(os.path.join(out_dir, f"f_{name}.bin"))
            field_names.append(name)
            field_max[name] = float(max(int(u16.max()), 1))
    field_max["range"] = 1.0

    with open(os.path.join(out_dir, "stream.json"), "w") as f:
        json.dump({
            "h": h, "w": w, "n": n,
            "scan_ts": [float(t) - float(scans.ts[0])
                        for t in np.asarray(scans.ts)],
            "range_unit_m": RANGE_UNIT_M,
            "fields": field_names,
            "field_max": field_max,
            "sensor": f"{info.prod_line} {info.mode}",
            "rate": float(rate),
        }, f)

    out = os.path.join(out_dir, "viewer_stream.html")
    with open(out, "w") as f:
        f.write(HTML)
    return out




def serve_dir(d, port):
    handler = functools.partial(
        http.server.SimpleHTTPRequestHandler, directory=d)
    with http.server.ThreadingHTTPServer(("127.0.0.1", port),
                                         handler) as srv:
        print(f"serving http://127.0.0.1:{port}/viewer_stream.html "
              "(ctrl-c to stop)")
        srv.serve_forever()
