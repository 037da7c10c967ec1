"""VGGT-1B in the port (``models/vggt.py``): a tiny VGGT against the
benchmark's plain reference (``slambench/reference/vggt.py``, written from
VGGT's equations) in float32 and bfloat16 activations; RoPE, QK-norm, the
``absT_quaR_FoV`` decode and the first view's own tokens on known inputs; the
published shapes and parameter count on the meta device; and the SLAM path:
``SLAMSolver`` and ``cli/main_slam.py`` loading a VGGT model by name."""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from da3slam_tpu_torch.core.transforms import abs_t_quat_fov_to_camera
from da3slam_tpu_torch.models import vggt
from da3slam_tpu_torch.utils import profiling
from slambench.reference import vggt as ref

TINY = vggt.PRESETS["vggt-tiny"]


def test_the_tiny_preset_has_the_test_sizes():
    """Width 64, 4 heads of 16, 2 DINO blocks, 2 frame + 2 global blocks,
    camera trunk 2 blocks, 2 iterations."""
    assert (TINY.embed_dim, TINY.num_heads, TINY.head_dim) == (64, 4, 16)
    assert (TINY.dino_depth, TINY.depth, TINY.camera_depth, TINY.camera_iters) == (2, 2, 2, 2)


def _views(seed: int, n: int = 3, hw: tuple[int, int] = (70, 70)) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, *hw, 3), generator=g, dtype=torch.uint8)


def _rel(a, b) -> float:
    a, b = torch.as_tensor(np.asarray(a), dtype=torch.float64), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _gaps(pred, want: dict) -> dict:
    out = {k: _rel(getattr(pred, k), want[k]) for k in ("depth", "conf", "frame_desc")}
    E = torch.as_tensor(pred.extrinsics, dtype=torch.float64)
    K = torch.as_tensor(pred.intrinsics, dtype=torch.float64)
    out["pose_gap"] = float((E - want["extrinsics"].double()).abs().max())
    out["intrinsics_rel"] = float((K - want["intrinsics"].double()).abs().max()
                                  / want["intrinsics"].abs().max())
    return out


# float32: the same formula at the same rounding points, so rounding only
# (sound runs read at most 8e-7). bfloat16: the port's CPU bf16 matmuls and
# convolutions accumulate otherwise than the reference's float32 operations
# rounded to bf16, so a rounding tips here and there by one bf16 unit (2^-8)
# and the tips travel through 6 blocks and the head: sound runs read at most
# 1.8e-3 (depth), 6e-4 (conf), 6e-5 (poses), 2e-5 (intrinsics), 1.1e-5 (desc);
# the limits leave 5x and more
TOLERANCES = {
    "float32": {"depth": 1e-5, "conf": 1e-5, "frame_desc": 1e-5, "pose_gap": 1e-5,
                "intrinsics_rel": 1e-5},
    "bfloat16": {"depth": 1e-2, "conf": 5e-3, "frame_desc": 1e-3, "pose_gap": 5e-4,
                 "intrinsics_rel": 2e-4},
}


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 2])
def test_the_port_matches_the_plain_reference(act, seed):
    dtype = getattr(torch, act)
    model = vggt.VGGT(TINY, vggt.init_params(TINY, seed), dtype)
    raw = _views(seed)
    pred = model.inference(image=raw, process_res=70)
    want = ref.forward(model.net.state_dict(), dataclasses.asdict(TINY), raw, 70, dtype)
    gaps = _gaps(pred, want)
    assert all(gaps[k] <= lim for k, lim in TOLERANCES[act].items()), gaps
    assert pred.depth.shape == (3, 70, 70) and pred.frame_desc.shape == (3, 2 * TINY.embed_dim)
    assert np.allclose(pred.extrinsics[0], np.eye(3, 4), atol=1e-6)  # the first view anchors


def test_attention_goes_through_multi_head_attention_and_the_spans(monkeypatch):
    """Every attention of the patch embed and the aggregator reaches
    ``vit.multi_head_attention`` as [B, S, H, D]; each aggregator attention
    opens a ``model.qk`` span with its shape and kind."""
    from da3slam_tpu_torch.models import vit

    shapes = []
    inner = vit.multi_head_attention
    monkeypatch.setattr(vit, "multi_head_attention",
                        lambda q, k, v: shapes.append(tuple(q.shape)) or inner(q, k, v))
    model = vggt.VGGT(TINY, vggt.init_params(TINY, 1))
    t0 = time.perf_counter()
    model.inference(image=_views(1), process_res=70)
    S = 5 * 5 + TINY.n_prefix  # 70 → a 5×5 patch grid
    frame, glob = (3, S, 4, 16), (1, 3 * S, 4, 16)
    assert shapes == [frame] * TINY.dino_depth + [frame, glob] * TINY.depth
    recs = [r for r in profiling.records(since=t0) if r.name.startswith("model.")]
    qk = [r.attrs for r in recs if r.name == "model.qk"]
    assert qk == [dict(B=3, S=S, H=4, D=16, kind="frame"),
                  dict(B=1, S=3 * S, H=4, D=16, kind="global")] * TINY.depth
    assert [r.name for r in recs].count("model.camera") == 1
    assert {"model.inference", "model.dpt", "model.fetch"} <= {r.name for r in recs}


# -- RoPE, QK-norm, the decode, the first view's tokens --------------------------

@pytest.mark.parametrize("token", [0, 4, 5, 6, 11])  # specials 0-4; patches at (0, 0), (0, 1), (2, 0)
def test_rope_rotates_pairs_by_the_patch_row_and_column(token):
    hd, freq, grid, n_special = 8, 100.0, (3, 3), 5
    cos, sin = vggt.rope_tables(grid, hd, n_special, freq)
    g = torch.Generator().manual_seed(token)
    y = torch.randn(1, n_special + 9, 2, hd, generator=g)
    out = vggt.apply_rope(y, cos, sin)
    if token < n_special:  # p = 0: not rotated
        assert torch.equal(out[0, token], y[0, token])
        return
    row, col = divmod(token - n_special, grid[1])
    for half, p in ((0, row + 1), (1, col + 1)):
        for j in range(hd // 4):  # channel j of the half pairs with j + hd/4
            a_i, b_i = half * hd // 2 + j, half * hd // 2 + j + hd // 4
            th = p * freq ** (-j / (hd // 4))
            a, b = y[0, token, :, a_i], y[0, token, :, b_i]
            assert torch.allclose(out[0, token, :, a_i], a * math.cos(th) - b * math.sin(th),
                                  atol=1e-6)
            assert torch.allclose(out[0, token, :, b_i], b * math.cos(th) + a * math.sin(th),
                                  atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qk_norm_is_a_layer_norm_over_each_head(dtype):
    g = torch.Generator().manual_seed(3)
    ln = torch.nn.LayerNorm(16)
    with torch.no_grad():
        ln.weight.copy_(torch.randn(16, generator=g))
        ln.bias.copy_(torch.randn(16, generator=g))
    t = (3 * torch.randn(2, 7, 4, 16, generator=g) + 1).to(dtype)
    zeros = torch.zeros(7, 2, 4)  # no rotation: cos 1, sin 0
    got = vggt.qk_norm_rope(ln, t, zeros + 1, zeros)
    want = F.layer_norm(t.float(), (16,), ln.weight, ln.bias, 1e-5).to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)


def test_the_pose_decode_is_scalar_last_and_fov_to_focal():
    H, W = 280, 420
    s = math.sqrt(0.5)
    pose = torch.tensor([[0.1, -0.2, 0.3, 0.0, 0.0, 0.0, 1.0, 1.0, 1.2],  # identity, w last
                         [0.0, 0.0, 0.0, 0.0, 0.0, s, s, 0.5, 0.5]])  # 90° about z
    E, K = abs_t_quat_fov_to_camera(pose, (H, W))
    assert torch.allclose(E[0], torch.tensor([[1.0, 0, 0, 0.1], [0, 1, 0, -0.2], [0, 0, 1, 0.3]]))
    assert torch.allclose(E[1, :, :3], torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]]),
                          atol=1e-6)
    assert K[0, 0, 0] == pytest.approx((W / 2) / math.tan(1.2 / 2))  # f_x from FoV_w
    assert K[0, 1, 1] == pytest.approx((H / 2) / math.tan(1.0 / 2))  # f_y from FoV_h
    assert (K[0, 0, 2], K[0, 1, 2], K[0, 2, 2]) == (W / 2, H / 2, 1.0)
    assert float(K[0, 0, 1]) == 0.0


def test_the_first_view_has_its_own_camera_and_register_tokens():
    """With every LayerScale at 0 the blocks pass their input through, so a
    tap is the prefixed token sequence twice."""
    net = vggt.init_params(TINY, 4)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("gamma"):
                p.zero_()
        net.aggregator.camera_token.copy_(torch.tensor([1.0, 2.0])[None, :, None, None])
        net.aggregator.register_token.copy_(torch.tensor([3.0, 4.0])[None, :, None, None])
    images = torch.randn(3, 70, 70, 3)
    taps, grid = vggt.aggregate(net.aggregator, images, TINY, torch.float32)
    tap = taps[TINY.depth - 1]
    D, R = TINY.embed_dim, TINY.num_register_tokens
    assert grid == (5, 5) and tap.shape == (3, 5 + 25, 2 * D)
    assert torch.equal(tap[:, :, :D], tap[:, :, D:])
    assert (tap[0, 0] == 1.0).all() and (tap[1:, 0] == 2.0).all()
    assert (tap[0, 1:1 + R] == 3.0).all() and (tap[1:, 1:1 + R] == 4.0).all()


# -- the published model -----------------------------------------------------------

def _published_count(c: vggt.VGGTConfig) -> int:
    """VGGT-1B's parameters without the point and track heads, from its sizes."""
    d, R, hd = c.embed_dim, c.num_register_tokens, c.head_dim

    def block(w):  # two LayerNorms, qkv, proj, two LayerScales, fc1, fc2
        return 12 * w * w + 15 * w

    def conv(cin, cout, k, bias=True):
        return cin * cout * k * k + (cout if bias else 0)

    dino = conv(3, d, c.patch_size) + d + R * d + (c.base_grid ** 2 + 1) * d + d \
        + c.dino_depth * block(d) + 2 * d
    agg = 2 * c.depth * (block(d) + 4 * hd) + 2 * d + 2 * R * d
    w = 2 * d
    camera = c.camera_depth * block(w) + 4 * w + 9 + (9 * w + w) + (3 * w * w + 3 * w) \
        + (w * d + d) + (d * 9 + 9)
    f, F_ = c.dpt_features, c.dpt_dim
    head = 2 * w + sum(conv(w, fk, 1) for fk in f) + conv(f[0], f[0], 4) + conv(f[1], f[1], 2) \
        + conv(f[3], f[3], 3) + sum(conv(fk, F_, 3, bias=False) for fk in f) \
        + 3 * (4 * conv(F_, F_, 3) + conv(F_, F_, 1)) + 2 * conv(F_, F_, 3) + conv(F_, F_, 1) \
        + conv(F_, F_ // 2, 3) + conv(F_ // 2, 32, 3) + conv(32, 2, 1)
    return dino + agg + camera + head


def test_from_pretrained_on_the_meta_device_has_the_published_shapes():
    model = vggt.VGGT.from_pretrained("VGGT-1B", device="meta")
    sd = model.net.state_dict()
    n = sum(p.numel() for p in model.net.parameters())
    assert n == _published_count(vggt.PRESETS["vggt-1b"]) == 1_157_941_492
    shapes = {
        "aggregator.patch_embed.pos_embed": (1, 1 + 37 * 37, 1024),
        "aggregator.patch_embed.register_tokens": (1, 4, 1024),
        "aggregator.patch_embed.blocks.23.mlp.fc1.weight": (4096, 1024),
        "aggregator.camera_token": (1, 2, 1, 1024),
        "aggregator.register_token": (1, 2, 4, 1024),
        "aggregator.frame_blocks.23.attn.q_norm.weight": (64,),
        "aggregator.global_blocks.23.attn.k_norm.bias": (64,),
        "aggregator.global_blocks.0.attn.qkv.weight": (3072, 1024),
        "camera_head.trunk.3.attn.qkv.weight": (6144, 2048),
        "camera_head.trunk.3.mlp.fc1.weight": (8192, 2048),
        "camera_head.poseLN_modulation.1.weight": (6144, 2048),
        "camera_head.embed_pose.weight": (2048, 9),
        "camera_head.empty_pose_tokens": (1, 1, 9),
        "camera_head.pose_branch.fc1.weight": (1024, 2048),
        "camera_head.pose_branch.fc2.weight": (9, 1024),
        "depth_head.norm.weight": (2048,),
        "depth_head.projects.0.weight": (256, 2048, 1, 1),
        "depth_head.scratch.layer4_rn.weight": (256, 1024, 3, 3),
        "depth_head.scratch.output_conv2.2.weight": (2, 32, 1, 1),
    }
    assert {k: tuple(sd[k].shape) for k in shapes} == shapes
    assert not any(k.startswith(("point_head", "track_head")) for k in sd)
    assert "depth_head.scratch.refinenet4.resConfUnit1.conv1.weight" not in sd
    assert sum(k.startswith("aggregator.frame_blocks.") and k.endswith(".attn.qkv.weight")
               for k in sd) == 24


# -- the SLAM path -----------------------------------------------------------------

def _frames_dir(path, n=7, hw=(70, 84)):
    rng = np.random.default_rng(5)
    path.mkdir()
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, size=(*hw, 3)).astype(np.uint8)).save(
            path / f"{i:06d}.png")
    return path


def test_the_solver_loads_vggt_by_name_and_runs_two_chunks(tmp_path):
    from da3slam_tpu_torch.slam.solver import SLAMSolver

    config = {"Weights": {"DA3": "vggt-tiny"},
              "Model": {"chunk_size": 4, "overlap_size": 1, "port": 8080}}
    solver = SLAMSolver(str(_frames_dir(tmp_path / "f")), config, viewer=None, device="cpu")
    assert isinstance(solver.model, vggt.VGGT) and solver.prefetch is True
    solver.run()
    assert [len(r["image_paths"]) for r in solver.results] == [4, 4]
    poses, intrs = solver.trajectory()
    assert len(poses) == 7 and np.isfinite(np.asarray(poses)).all()
    assert np.isfinite(np.asarray(intrs)).all()
    # 70×84 frames at the solver's process_res 504: 420×504, principal point at the centre
    assert np.allclose(np.asarray(solver.results[0]["intrinsics"])[:, :2, 2], [252.0, 210.0])


def test_main_slam_runs_a_vggt_config(tmp_path):
    from da3slam_tpu_torch.cli import main_slam

    cfg = tmp_path / "vggt.yaml"
    cfg.write_text("Weights: {DA3: vggt-tiny}\nModel: {chunk_size: 4, overlap_size: 1}\n")
    out = tmp_path / "o"
    solver = main_slam.main(["--device", "cpu", "--config", str(cfg), "--headless",
                             "--image_dir", str(_frames_dir(tmp_path / "f")),
                             "--output_dir", str(out)])
    assert isinstance(solver.model, vggt.VGGT)
    assert any(out.iterdir())
