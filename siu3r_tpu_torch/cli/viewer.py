"""Gaussian scene viewer, counterpart of ``siu3r_tpu/cli/viewer.py``.

Loads ``output.ply`` (with ``semantic_label`` / ``instance_label`` /
``seg_query_class_logits_*``) and renders RGB, depth, semantic and instance
views through the port's rasterizer, with the query-class lift of the
pipeline.

Usage:
    python -m siu3r_tpu_torch.cli.viewer --ply output.ply --orbit \
        [--mode rgb|semantic|instance|depth] [--frames 24] [--output_path viewer_out]
    python -m siu3r_tpu_torch.cli.viewer --ply output.ply --serve [--port 8080]

``--orbit`` renders an orbit to PNGs; ``--serve`` is a dependency-free web
viewer (stdlib HTTP on loopback, frames rendered per request); without
either, the viser viewer of the reference, which is not wired. Renders on
the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from siu3r_tpu_torch.device import resolve_device


def load_gaussian_ply(path):
    """PLY -> dict of numpy arrays (means, scales (linear), rotations xyzw,
    harmonics, opacities, labels, qc_logits [G, Q, C] or None)."""
    from siu3r_tpu_torch.io import read_ply

    data = read_ply(path)
    g = data["x"].shape[0]
    means = np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float32)
    scales = np.exp(np.stack([data[f"scale_{i}"] for i in range(3)], -1)).astype(np.float32)
    w, x, y, z = (data[f"rot_{i}"] for i in range(4))
    rot_xyzw = np.stack([x, y, z, w], -1).astype(np.float32)
    f_dc = np.stack([data[f"f_dc_{i}"] for i in range(3)], -1)
    rest_keys = sorted((k for k in data if k.startswith("f_rest_")), key=lambda k: int(k.split("_")[-1]))
    if rest_keys:
        f_rest = np.stack([data[k] for k in rest_keys], -1).reshape(g, 3, -1)
        harmonics = np.concatenate([f_dc[..., None], f_rest], axis=-1)
    else:
        harmonics = f_dc[..., None]
    qc_keys = sorted(
        (k for k in data if k.startswith("seg_query_class_logits_")), key=lambda k: int(k.split("_")[-1])
    )
    qc = None
    if qc_keys:
        flat = np.stack([data[k] for k in qc_keys], -1)
        n_cols = flat.shape[-1]
        # the reference PLY stores q*c columns with c = num_labels + 1
        for c in (21, 151, 134):  # scannet / ade20k / coco class counts + 1
            if n_cols % c == 0:
                qc = flat.reshape(g, n_cols // c, c)
                break
    return {
        "means": means,
        "scales": scales,
        "rotations": rot_xyzw,
        "harmonics": harmonics.astype(np.float32),
        "opacities": data["opacity"].astype(np.float32),
        "semantic": data.get("semantic_label"),
        "instance": data.get("instance_label"),
        "qc": qc,
    }


def render_views(scene, viewmats, intr_px, image_size, mode="rgb", device="cuda"):
    """Render ``scene`` from cameras viewmats [N, 4, 4] (world-to-camera) and
    intr_px [N, 3, 3] (pixels). mode: rgb | semantic | instance | depth.
    Returns [N, H, W, 3] uint8."""
    from siu3r_tpu_torch.gaussians import build_covariance
    from siu3r_tpu_torch.ops.sh import eval_sh_colors
    from siu3r_tpu_torch.render.rasterizer import rasterize
    from siu3r_tpu_torch.utils.scannet_constant import PANOPTIC_COLOR_PALLETE

    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    vm, ki = t(viewmats), t(intr_px)
    means, opac = t(scene["means"]), t(scene["opacities"])
    covs = build_covariance(t(scene["scales"]), t(scene["rotations"]))
    with torch.inference_mode():
        if mode == "rgb":
            deg = int(round(scene["harmonics"].shape[-1] ** 0.5)) - 1
            cam_pos = t(np.linalg.inv(viewmats))[:, :3, 3]
            dirs = means[None] - cam_pos[:, None]
            dirs = dirs / (torch.linalg.vector_norm(dirs, dim=-1, keepdim=True) + 1e-8)
            colors = eval_sh_colors(t(scene["harmonics"])[None], dirs, deg)  # [N, G, 3]
            img, _, _ = rasterize(means, covs, opac, colors, vm, ki, image_size)
            return (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        if mode == "depth":
            _, depth, _ = rasterize(means, covs, opac, means.new_zeros(means.shape[0], 1), vm, ki, image_size)
            d = depth.cpu().numpy()
            d = d / max(d.max(), 1e-6)
            return (np.stack([d] * 3, -1) * 255).astype(np.uint8)
        if mode not in ("semantic", "instance"):
            raise ValueError(f"unknown mode {mode!r}")
        # semantic / instance: rasterize the query-class confidences, then the
        # argmax lift of the pipeline (reference viewer.py:403-446)
        if scene["qc"] is None:
            raise ValueError("the PLY has no seg_query_class_logits_* columns")
        g, q, c = scene["qc"].shape
        rendered, _, _ = rasterize(means, covs, opac, t(scene["qc"]).reshape(g, q * c), vm, ki, image_size)
        # [N, H, W, q*c]
    n, h, w = rendered.shape[:3]
    r = rendered.cpu().numpy().reshape(n, h, w, q, c)
    c_logit = r.max(axis=3)  # [N, H, W, C]
    q_index = r.argmax(axis=3)
    c_logit = np.concatenate([c_logit[..., -1:], c_logit[..., :-1]], -1)
    q_index = np.concatenate([q_index[..., -1:], q_index[..., :-1]], -1)
    sem_logit = c_logit.max(-1)
    sem_id = c_logit.argmax(-1)
    qi = np.take_along_axis(q_index, sem_id[..., None], -1)[..., 0] + 1
    sem_id[sem_logit < 0.3] = 0
    qi[sem_id == 0] = 0
    if mode == "semantic":
        palette = np.array([PANOPTIC_COLOR_PALLETE.get(i, [127, 127, 127]) for i in range(21)], np.uint8)
        return palette[np.clip(sem_id, 0, 20)]
    rng = np.random.RandomState(0)
    inst_palette = np.concatenate(
        [np.zeros((1, 3), np.uint8), rng.randint(40, 255, (256, 3)).astype(np.uint8)]
    )
    return inst_palette[np.clip(qi, 0, 256)]


def _look_at(center, eye, intr):
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    nrm = np.linalg.norm(right)
    if nrm < 1e-6:
        right, nrm = np.array([1.0, 0.0, 0.0]), 1.0
    right = right / nrm
    up2 = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up2, fwd, eye
    return np.linalg.inv(c2w).astype(np.float32), intr


def _intrinsics(image_size, fov_deg):
    h, w = image_size
    f = 0.5 * w / np.tan(np.radians(fov_deg) / 2)
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


def orbit_cameras(scene, n_frames=24, image_size=(256, 256), fov_deg=60.0):
    """An orbit around the scene's median: (viewmats [N, 4, 4], intr [N, 3, 3])."""
    means = scene["means"]
    center = np.median(means, axis=0)
    radius = np.percentile(np.linalg.norm(means - center, axis=-1), 70)
    intr = _intrinsics(image_size, fov_deg)
    viewmats = []
    for i in range(n_frames):
        ang = 2 * np.pi * i / n_frames
        eye = center + radius * np.array([np.sin(ang) * 0.4, -0.15, -0.4 * np.cos(ang)])
        viewmats.append(_look_at(center, eye, intr)[0])
    return np.stack(viewmats), np.stack([intr] * n_frames)


def camera_from_spherical(center, yaw, pitch, radius, image_size, fov_deg=60.0):
    """(yaw, pitch, radius) orbit camera around ``center`` -> (viewmat [4, 4],
    intr_px [3, 3])."""
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    eye = center + radius * np.array([sy * cp, -sp, -cy * cp])
    return _look_at(center, eye, _intrinsics(image_size, fov_deg))


_VIEWER_HTML = """<!doctype html>
<html><head><title>siu3r_tpu_torch viewer</title><style>
body{margin:0;background:#111;color:#ddd;font-family:sans-serif;display:flex;
flex-direction:column;align-items:center}
#img{cursor:grab;image-rendering:pixelated;width:512px;height:512px;margin:12px}
button{margin:2px;padding:6px 10px}button.on{background:#4a8}
</style></head><body>
<div id="bar">
<button data-m="rgb" class="on">rgb</button>
<button data-m="semantic">semantic</button>
<button data-m="instance">instance</button>
<button data-m="depth">depth</button>
<span id="st"></span></div>
<img id="img" width=512 height=512/>
<script>
let yaw=0, pitch=0.15, radius=1.0, mode="rgb", busy=false, dirty=true;
const img=document.getElementById("img"), st=document.getElementById("st");
function refresh(){
  if(busy){dirty=true;return;} busy=true; dirty=false;
  const t0=performance.now();
  const u=`/render?yaw=${yaw.toFixed(3)}&pitch=${pitch.toFixed(3)}`+
          `&radius=${radius.toFixed(3)}&mode=${mode}&t=${Date.now()}`;
  const pre=new Image();
  pre.onload=()=>{img.src=pre.src;
    st.textContent=` ${(performance.now()-t0).toFixed(0)} ms`;
    busy=false; if(dirty) refresh();};
  pre.onerror=()=>{busy=false;};
  pre.src=u;
}
let drag=null;
img.onmousedown=e=>{drag=[e.clientX,e.clientY];e.preventDefault();};
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;
  yaw+=(e.clientX-drag[0])*0.01; pitch+=(e.clientY-drag[1])*0.01;
  pitch=Math.max(-1.4,Math.min(1.4,pitch)); drag=[e.clientX,e.clientY];
  refresh();};
img.onwheel=e=>{e.preventDefault();radius*=Math.exp(e.deltaY*0.001);refresh();};
document.querySelectorAll("#bar button").forEach(b=>b.onclick=()=>{
  mode=b.dataset.m;
  document.querySelectorAll("#bar button").forEach(x=>x.classList.remove("on"));
  b.classList.add("on"); refresh();});
refresh();
</script></body></html>"""


def serve(scene, port: int, image_size=(256, 256), block: bool = True, host: str = "127.0.0.1",
          device="cuda"):
    """Interactive web viewer: frames rendered on ``device`` per request.

    Binds loopback by default: the render endpoint is unauthenticated, so
    exposing it on all interfaces is an explicit opt-in (``--host 0.0.0.0``).
    With ``block=False`` returns the server unstarted. Requests are served
    one at a time: the renders share one device."""
    import io
    from http.server import BaseHTTPRequestHandler, HTTPServer
    from urllib.parse import parse_qs, urlparse

    from PIL import Image

    dev = resolve_device(device)
    center = np.median(scene["means"], axis=0)
    base_radius = float(np.percentile(np.linalg.norm(scene["means"] - center, axis=-1), 70))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, ctype: str, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                self._send(200, "text/html", _VIEWER_HTML.encode())
                return
            if url.path != "/render":
                self._send(404, "text/plain", b"not found")
                return
            q = parse_qs(url.query)
            try:
                yaw, pitch, radius = (float(q.get(k, [d])[0]) for k, d in
                                      (("yaw", 0.0), ("pitch", 0.15), ("radius", 1.0)))
                mode = q.get("mode", ["rgb"])[0]
                vm, intr = camera_from_spherical(center, yaw, pitch, radius * base_radius, image_size)
                img = render_views(scene, vm[None], intr[None], image_size, mode=mode, device=dev)[0]
            except ValueError as e:
                self._send(400, "text/plain", str(e).encode())
                return
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "PNG")
            self._send(200, "image/png", buf.getvalue())

    server = HTTPServer((host, port), Handler)
    if not block:
        return server
    print(f"[viewer] serving on http://localhost:{server.server_port}/ (ctrl-c to stop)")
    try:
        server.serve_forever()
    finally:
        server.server_close()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ply", type=str, required=True)
    parser.add_argument("--orbit", action="store_true", help="headless orbit render")
    parser.add_argument("--serve", action="store_true", help="interactive web viewer")
    parser.add_argument("--mode", default="rgb", choices=["rgb", "semantic", "instance", "depth"])
    parser.add_argument("--output_path", default="viewer_out")
    parser.add_argument("--frames", type=int, default=24)
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument(
        "--host", default="127.0.0.1",
        help="bind address for --serve (default loopback; 0.0.0.0 exposes the "
        "unauthenticated render endpoint on all interfaces)",
    )
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    scene = load_gaussian_ply(args.ply)
    print(f"[viewer] {scene['means'].shape[0]} gaussians, "
          f"qc: {None if scene['qc'] is None else scene['qc'].shape}")

    if args.serve:
        serve(scene, args.port, host=args.host, device=device)
        return

    if not args.orbit:
        try:
            import viser  # noqa: F401
        except ImportError:
            raise SystemExit(
                "viser is not installed in this environment; use --serve for "
                "the built-in interactive web viewer or --orbit for headless rendering"
            )
        raise SystemExit("viser mode not wired; use --serve or --orbit")

    from PIL import Image

    out = Path(args.output_path)
    out.mkdir(parents=True, exist_ok=True)
    viewmats, intr = orbit_cameras(scene, args.frames)
    imgs = render_views(scene, viewmats, intr, (256, 256), mode=args.mode, device=device)
    for i, img in enumerate(imgs):
        Image.fromarray(img).save(out / f"{args.mode}_{i:03d}.png")
    print(f"[viewer] wrote {len(imgs)} frames to {out}")


if __name__ == "__main__":
    main()
