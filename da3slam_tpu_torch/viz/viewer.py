"""Incremental SLAM viewer on viser (counterpart of ``da3slam_tpu/viz/viewer.py``).

An accumulating world point cloud with confidence-percentile filtering,
per-frame camera frusta with fly-to on click, frame-selector filtering, a
fly-through of the recorded trajectory and a mesh overlay.  Each frame owns
its scene handle, so steady-state ingest sends only the new frame's points;
everything is re-sent only on a GUI filter change or when the global point
budget forces a coarser display stride.

The geometry runs on the viewer's ``device`` (the card by default):
backprojection, the ingest stride, the validity mask and the camera poses
(``se3_inverse``, ``rotmat_to_quat``) of a batch of frames
(``add_frames``, as the solver sends a chunk) are computed where the frames
live and come back in one device→host transfer (``utils/transfer.py:fetch_packed``);
host arrays go up through pinned memory without waiting.  The scene
bookkeeping, the percentile and the sends stay on the host.

``viser`` is imported by the constructor, not by this module: without it
``SLAMViewer(...)`` raises ``ImportError``, which the callers (the solver,
``main_align``, ``show_prediction``) take as "run headless", like the JAX
package.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from da3slam_tpu_torch.core.geometry import backproject_depth
from da3slam_tpu_torch.core.transforms import rotmat_to_quat, se3_inverse
from da3slam_tpu_torch.utils.profiling import span
from da3slam_tpu_torch.utils.transfer import fetch_packed

# every frustum shows its frame at this stride
THUMB_STRIDE = 4


def _slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Spherical interpolation between wxyz quaternions."""
    d = float(np.dot(q0, q1))
    if d < 0.0:  # take the short arc
        q1, d = -q1, -d
    if d > 0.9995:  # nearly parallel: lerp + renormalise
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(d, -1.0, 1.0))
    s = np.sin(theta)
    return (np.sin((1.0 - t) * theta) * q0 + np.sin(t * theta) * q1) / s


class SLAMViewer:
    def __init__(
        self,
        port: int = 8080,
        point_stride: int = 4,
        max_depth: float = 50.0,
        min_depth: float = 0.1,
        max_points: int = 2_000_000,
        device: str | torch.device = "cuda",
    ):
        import viser  # ImportError → the caller runs headless

        self.server = viser.ViserServer(host="0.0.0.0", port=port)
        self.device = torch.device(device)
        self.point_stride = point_stride
        self.max_depth = max_depth
        self.min_depth = min_depth
        self.max_points = max_points

        self.all_points: list[np.ndarray] = []
        self.all_colors: list[np.ndarray] = []
        self.all_confs: list[np.ndarray] = []
        self.frame_ids: list[int] = []
        self.cam_poses: list[tuple[np.ndarray, np.ndarray]] = []  # (wxyz, pos)
        self._frame_count = 0
        self._lock = threading.Lock()

        self.gui_conf_percentile = self.server.gui.add_slider(
            "conf percentile", min=0, max=99, step=1, initial_value=0
        )
        self.gui_frame_filter = self.server.gui.add_dropdown(
            "frames", options=["all"], initial_value="all"
        )
        self.gui_point_size = self.server.gui.add_slider(
            "point size", min=0.0005, max=0.02, step=0.0005, initial_value=0.002
        )

        @self.gui_conf_percentile.on_update
        def _(_evt) -> None:
            self._refresh_all()

        @self.gui_frame_filter.on_update
        def _(_evt) -> None:
            self._refresh_all()

        @self.gui_point_size.on_update
        def _(_evt) -> None:
            self._refresh_all()

        # per-frame scene handles; the display stride applies on top of the
        # ingest stride once the point budget is exceeded
        self._clouds: dict[int, object] = {}
        self._display_stride = 1

    # -- ingestion ---------------------------------------------------------
    def add_frame(self, image, depth, conf, extrinsic, intrinsic) -> None:
        """image [H,W,3] uint8 or [3,H,W] float; depth/conf [H,W];
        extrinsic [3,4] w2c; intrinsic [3,3].  Numpy arrays or tensors."""
        depth, conf = depth.squeeze(), conf.squeeze()
        self.add_frames(image[None], depth[None], conf[None], extrinsic[None], intrinsic[None])

    def add_frames(self, images, depth, conf, extrinsics, intrinsics) -> None:
        """A batch of frames, in order, as ``add_frame`` takes each: images
        ``[N,H,W,3]`` uint8 or ``[N,3,H,W]`` float, depth/conf ``[N,H,W]``,
        w2c ``[N,3,4]``, ``[N,3,3]``.  The batch's geometry runs on the
        viewer's device and comes back in one transfer."""
        for frame in self._prepare(images, depth, conf, extrinsics, intrinsics):
            self._ingest(*frame)

    def _upload(self, a, dtype: torch.dtype | None = None) -> torch.Tensor:
        """On the viewer's device: a tensor moves there (no copy if it is
        already), a host array goes up from pinned memory without a wait."""
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        if a.device.type == "cpu" and self.device.type == "cuda":
            a = a.pin_memory()
        a = a.to(self.device, non_blocking=True)
        return a if dtype is None else a.to(dtype)

    def _prepare(self, images, depth, conf, extrinsics, intrinsics) -> list[tuple]:
        """Backproject, stride and mask the frames on the device; one fetch.
        Returns per frame ``(image, pts, cols, confs, quat, pos, K)`` on the
        host: ``image`` the frustum's thumbnail in the add_frame convention."""
        f32 = torch.float32
        imgs = self._upload(images)
        chw = imgs.ndim == 4 and imgs.shape[1] == 3
        if chw:  # CHW -> HWC
            imgs = imgs.permute(0, 2, 3, 1)
        n, h, w = imgs.shape[:3]
        depth = self._upload(depth, f32).reshape(n, h, w)
        conf = self._upload(conf, f32).reshape(n, h, w)
        E = self._upload(extrinsics, f32)
        K = self._upload(intrinsics, f32)

        pts = backproject_depth(depth, K, E)
        s = self.point_stride
        pts_s = pts[:, ::s, ::s].reshape(n, -1, 3)
        d_s = depth[:, ::s, ::s].reshape(n, -1)
        valid = (torch.isfinite(pts_s).all(-1) & (d_s > self.min_depth)
                 & (d_s < self.max_depth))
        c2w = se3_inverse(E)
        quat = rotmat_to_quat(c2w[..., :3, :3])
        # a float CHW image in [0, 1] becomes uint8 (add_frame's convention):
        # decided on each whole image's max, applied after the fetch
        peak = (imgs.reshape(n, -1).amax(-1).to(f32) if chw
                else torch.zeros(n, dtype=f32, device=self.device))
        fetched = [pts_s, imgs[:, ::s, ::s].reshape(n, -1, 3), conf[:, ::s, ::s].reshape(n, -1),
                   valid, quat, c2w[..., :3, 3], imgs[:, ::THUMB_STRIDE, ::THUMB_STRIDE], K, peak]
        with span("viewer.fetch", bytes=8 * sum(t.numel() for t in fetched)):  # one f64 buffer
            host = fetch_packed(fetched)
        pts_s, cols_s, conf_s, valid, quat, pos, thumb, K, peak = host
        frames = []
        for i in range(n):
            cols, img = cols_s[i], thumb[i]
            if chw and peak[i] <= 1.0:
                cols = (cols * 255).astype(np.uint8)
                img = (img * 255).astype(np.uint8)
            keep = valid[i]
            frames.append((img, (h, w), pts_s[i][keep], cols[keep], conf_s[i][keep],
                           quat[i], pos[i], K[i]))
        return frames

    def _ingest(self, thumb, hw, pts, cols, confs, quat, pos, K) -> None:
        with self._lock:
            idx = self._frame_count
            self._frame_count += 1
            self.all_points.append(pts)
            self.all_colors.append(cols)
            self.all_confs.append(confs)
            self.frame_ids.append(idx)
            self.gui_frame_filter.options = ["all"] + [str(i) for i in self.frame_ids]

        self._add_camera_visualization(idx, quat, pos, K, hw, thumb)

        total = sum(p.shape[0] for p in self.all_points)
        stride = max(1, int(np.ceil(total / self.max_points)))
        if stride != self._display_stride:
            self._display_stride = stride
            self._refresh_all()  # budget crossed: re-send everything coarser
        else:
            self._send_frame(idx)  # steady state: send only the new frame

    # -- camera frusta -----------------------------------------------------
    def _add_camera_visualization(self, idx, quat, pos, K, hw, thumb) -> None:
        with self._lock:
            self.cam_poses.append((quat, pos))
        h, w = hw
        fov = 2 * np.arctan2(h / 2, float(K[1, 1]))
        frustum = self.server.scene.add_camera_frustum(
            f"/cameras/frame_{idx}",
            fov=float(fov),
            aspect=w / h,
            scale=0.03,
            wxyz=quat,
            position=pos,
            image=thumb,
        )

        @frustum.on_click
        def _(_evt) -> None:
            for client in self.server.get_clients().values():
                with client.atomic():
                    client.camera.wxyz = quat
                    client.camera.position = pos

    # -- point cloud -------------------------------------------------------
    def _conf_threshold(self) -> float | None:
        """Global confidence-percentile threshold over all kept points."""
        pct = self.gui_conf_percentile.value
        if pct <= 0 or not self.all_confs:
            return None
        confs = np.concatenate(self.all_confs)
        return float(np.percentile(confs, pct)) if confs.size else None

    def _send_frame(self, idx: int, thresh: float | None = ...) -> None:
        """(Re-)send one frame's points under the current filters."""
        with self._lock:
            pts = self.all_points[idx]
            cols = self.all_colors[idx]
            confs = self.all_confs[idx]
        if thresh is ...:
            thresh = self._conf_threshold()
        sel = self.gui_frame_filter.value
        visible = sel == "all" or int(sel) == idx
        if thresh is not None:
            keep = confs >= thresh
            pts, cols = pts[keep], cols[keep]
        ds = self._display_stride
        if ds > 1:
            pts, cols = pts[::ds], cols[::ds]
        if not visible:
            pts = pts[:0]
            cols = cols[:0]

        old = self._clouds.get(idx)
        self._clouds[idx] = self.server.scene.add_point_cloud(
            f"/map/frame_{idx}",
            points=pts.astype(np.float32),
            colors=cols.astype(np.uint8),
            point_size=float(self.gui_point_size.value),
        )
        if old is not None:
            try:
                old.remove()
            except Exception:
                pass

    def _refresh_all(self) -> None:
        thresh = self._conf_threshold()
        for idx in list(self.frame_ids):
            self._send_frame(idx, thresh)

    # -- mesh overlay --------------------------------------------------------
    def set_mesh(self, vertices, faces, colors=None) -> None:
        """Show (or replace) a fused TSDF mesh beside the per-frame clouds.
        Per-vertex ``colors`` (uint8) render as such where the viser build
        has a vertex-colour mesh API (``scene.add_mesh``); older builds take
        one colour a mesh (``add_mesh_simple``), so the mean colour is used
        there."""
        verts = np.asarray(vertices, np.float32)
        tris = np.asarray(faces, np.int32)
        with self._lock:
            if getattr(self, "_mesh_handle", None) is not None:
                self._mesh_handle.remove()
            handle = None
            add_mesh = getattr(self.server.scene, "add_mesh", None)
            if colors is not None and add_mesh is not None:
                try:
                    handle = add_mesh(
                        "/scene_mesh", vertices=verts, faces=tris,
                        colors=np.asarray(colors, np.uint8).reshape(-1, 3),
                    )
                except TypeError:  # an older signature without vertex colours
                    handle = None
            if handle is None:
                color = (
                    tuple(int(c) for c in np.asarray(colors).reshape(-1, 3).mean(0))
                    if colors is not None
                    else (160, 160, 170)
                )
                handle = self.server.scene.add_mesh_simple(
                    "/scene_mesh", vertices=verts, faces=tris, color=color,
                )
            self._mesh_handle = handle

    # -- demo mode ---------------------------------------------------------
    def run_demo_flythrough(self, interval_s: float = 0.5, steps_per_edge: int = 12) -> None:
        """Fly the client camera along the recorded trajectory, slerping
        rotation and lerping position between consecutive camera poses."""
        with self._lock:
            poses = list(self.cam_poses)
        if not poses:
            return
        dt = interval_s / max(steps_per_edge, 1)
        for (q0, p0), (q1, p1) in zip(poses[:-1], poses[1:]):
            for step in range(steps_per_edge):
                t = (step + 1) / steps_per_edge
                quat = _slerp(q0, q1, t)
                pos = (1.0 - t) * p0 + t * p1
                for client in self.server.get_clients().values():
                    with client.atomic():
                        client.camera.wxyz = quat
                        client.camera.position = pos
                time.sleep(dt)

    def keep_alive(self) -> None:
        while True:
            time.sleep(1.0)
