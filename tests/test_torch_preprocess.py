"""The port's frame preprocessing (``preprocess/``, ``cli/preprocess.py``)
against ``da3slam_tpu.preprocess`` on the CPU.

Both packages take the same seeded numpy frames.  Tolerances: LAB and back
within 1e-4 abs (f32 colour math in two libraries, measured 6e-5 on L in
[0, 255]); CLAHE on the same float L within 1e-3 abs (same bins, sums in
another order); uint8 outputs within 1 LSB.  CLAHE bins a pixel by
truncating its float L, so an L within rounding of an integer can change bin
between the packages (and between the JAX package's eager and jitted
programs): such bin flips are counted and bounded, at most ``FLIP_SHARE`` of
the pixels or 2 pixels in a smaller set (measured: 25 of the 2^24 8-bit
colours, 1.5e-6), and a frame's output may break its tolerance only where a
flip reaches (the flipped bin's pixels in the tiles around it: 3 LSB seen).
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from da3slam_tpu.cli import preprocess as jcli
from da3slam_tpu.preprocess import device as jdev
from da3slam_tpu.preprocess import host as jhost
from da3slam_tpu_torch.cli import preprocess as tcli
from da3slam_tpu_torch.preprocess import (
    adjust_brightness,
    clahe,
    crop_square,
    lab_to_rgb,
    preprocess_batch,
    rgb_to_lab,
)
from da3slam_tpu_torch.preprocess import device as tdev
from da3slam_tpu_torch.preprocess import host as thost

torch.set_num_threads(2)

FLIP_SHARE = 1e-5
LAB_TOL = 1e-4
CLAHE_TOL = 1e-3
# preprocess_batch(normalize=True): 1 LSB of the uint8 frame through the
# ImageNet std (0.225), plus the antialiased resize's own 1e-4
NORMALIZED_TOL = 1.0 / (255.0 * 0.225) + 1e-4


def frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def smooth_frames(n, h, w, seed):
    """Low-frequency colour fields (the structure of a real frame)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = []
    for _ in range(n):
        a = rng.uniform(2, 9, size=(3, 2))
        ph = rng.uniform(0, 2 * np.pi, size=3)
        img = np.stack([0.5 + 0.3 * np.sin(a[c, 0] * xx + ph[c]) + 0.2 * np.cos(a[c, 1] * yy)
                        for c in range(3)], -1)
        out.append(np.clip(img * 255, 0, 255).astype(np.uint8))
    return np.stack(out)


CASES = {
    "random": frames((4, 60, 80, 3), 0),
    "ragged": frames((1, 45, 70, 3), 1),
    "smooth": smooth_frames(2, 64, 96, 2),
}


def bin_flips(lab_j: np.ndarray, lab_t: np.ndarray) -> np.ndarray:
    """Pixels whose CLAHE bin (int32 truncation of L) differs."""
    return lab_j[..., 0].astype(np.int32) != lab_t[..., 0].astype(np.int32)


def flip_bound(n_pixels: int) -> float:
    return max(2.0, FLIP_SHARE * n_pixels)


def jax_brightness(batch: np.ndarray, **kw) -> np.ndarray:
    return np.asarray(jax.vmap(lambda f: jdev.adjust_brightness(f, **kw))(jnp.asarray(batch)))


class TestColorSpace:
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_lab_matches_jax(self, case):
        x = CASES[case]
        lab_j = np.asarray(jdev.rgb_to_lab(jnp.asarray(x)))
        lab_t = rgb_to_lab(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(lab_t, lab_j, atol=LAB_TOL, rtol=0)
        np.testing.assert_allclose(lab_to_rgb(torch.from_numpy(lab_j)).numpy(),
                                   np.asarray(jdev.lab_to_rgb(jnp.asarray(lab_j))),
                                   atol=LAB_TOL, rtol=0)
        assert bin_flips(lab_j, lab_t).sum() <= flip_bound(x[..., 0].size)

    def test_bin_flips_over_every_colour(self):
        """Every 16th 8-bit colour (2^20 of them): the flips stay within
        FLIP_SHARE, and each sits within 1e-4 of an integer L."""
        c = np.arange(0, 2**24, 16, dtype=np.uint32)
        rgb = np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255], -1).astype(np.uint8)
        rgb = rgb.reshape(64, -1, 3)
        lab_j = np.asarray(jdev.rgb_to_lab(jnp.asarray(rgb)))
        lab_t = rgb_to_lab(torch.from_numpy(rgb)).numpy()
        flips = bin_flips(lab_j, lab_t)
        assert flips.sum() <= FLIP_SHARE * flips.size
        L = lab_j[..., 0][flips]
        assert (np.abs(L - np.round(L)) < 1e-4).all()

    def test_roundtrip_and_gray_axis(self):
        """tests/test_preprocess.py's colour cases, on the port."""
        rgb = frames((32, 32, 3), 0)
        back = lab_to_rgb(rgb_to_lab(torch.from_numpy(rgb))).numpy() * 255.0
        assert np.abs(back - rgb).max() < 2.0
        grays = torch.stack([torch.full((4, 4, 3), v, dtype=torch.uint8) for v in (0, 64, 128, 255)])
        lab = rgb_to_lab(grays).numpy()
        np.testing.assert_allclose(lab[..., 1:], 128.0, atol=1.0)
        Ls = lab[:, 0, 0, 0]
        assert (np.diff(Ls) > 0).all() and abs(Ls[-1] - 255.0) < 1.0


class TestTileHistograms:
    def test_matches_numpy_bincount(self):
        rng = np.random.default_rng(0)
        bins = rng.integers(0, 256, size=(4, 4, 999)).astype(np.int32)
        hist = tdev._tile_histograms(torch.from_numpy(bins), 256).numpy()
        ref = np.stack([np.stack([np.bincount(bins[i, j], minlength=256) for j in range(4)])
                        for i in range(4)]).astype(np.float32)
        np.testing.assert_array_equal(hist, ref)
        np.testing.assert_array_equal(
            hist, np.asarray(jdev._tile_histograms(jnp.asarray(bins), 256)))

    def test_degenerate_single_value(self):
        hist = tdev._tile_histograms(torch.full((2, 2, 50), 7, dtype=torch.int32), 16).numpy()
        assert hist[0, 0, 7] == 50 and hist.sum() == 4 * 50 and hist.dtype == np.float32


class TestCLAHE:
    @pytest.mark.parametrize("case", sorted(CASES))
    @pytest.mark.parametrize("clip_limit,grid", [(2.0, 8), (4.0, 4)])
    def test_matches_jax_on_the_same_l(self, case, clip_limit, grid):
        """One float L through both (the same bins by construction), frame by
        frame in JAX, the batch at once in the port."""
        L = np.asarray(jdev.rgb_to_lab(jnp.asarray(CASES[case])))[..., 0]
        ref = np.stack([np.asarray(jdev.clahe(jnp.asarray(l), clip_limit, grid)) for l in L])
        got = clahe(torch.from_numpy(L), clip_limit, grid).numpy()
        np.testing.assert_allclose(got, ref, atol=CLAHE_TOL, rtol=0)
        np.testing.assert_allclose(clahe(torch.from_numpy(L[0]), clip_limit, grid).numpy(),
                                   ref[0], atol=CLAHE_TOL, rtol=0)

    def test_raises_contrast_and_clip_limit_bounds_gain(self):
        """tests/test_preprocess.py's behavioural cases, on the port."""
        rng = np.random.default_rng(1)
        img = 100.0 + 20.0 * rng.random((64, 64)).astype(np.float32)
        assert clahe(torch.from_numpy(img)).numpy().std() > img.std() * 1.5
        img = 120.0 + 5.0 * rng.random((64, 64)).astype(np.float32)
        hi = clahe(torch.from_numpy(img), clip_limit=8.0).numpy().std()
        lo = clahe(torch.from_numpy(img), clip_limit=1.0).numpy().std()
        assert lo < hi
        flat = clahe(torch.full((64, 64), 100.0)).numpy()
        assert flat.shape == (64, 64) and 0 <= flat.min() and flat.max() <= 255.0


class TestBrightness:
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_matches_jax(self, case):
        x = CASES[case]
        ref = jax_brightness(x).astype(int)
        got = adjust_brightness(torch.from_numpy(x)).numpy()
        assert got.dtype == np.uint8 and got.shape == x.shape
        flips = bin_flips(np.asarray(jdev.rgb_to_lab(jnp.asarray(x))),
                          rgb_to_lab(torch.from_numpy(x)).numpy())
        assert flips.sum() <= flip_bound(flips.size)
        diff = np.abs(got.astype(int) - ref)
        # beyond 1 LSB only in the frames a bin flip reaches
        for i in range(len(x)):
            if not flips[i].any():
                assert diff[i].max() <= 1, (case, i, diff[i].max())
        # one frame alone: the batch's first frame (its sums blocked otherwise)
        single = adjust_brightness(torch.from_numpy(x[0])).numpy()
        assert np.abs(single.astype(int) - got[0].astype(int)).max() <= 1

    def test_keyword_arguments_match_jax(self):
        x = CASES["smooth"]
        kw = dict(bright_threshold=200.0, dark_threshold=50.0, bright_reduction=0.5,
                  dark_enhancement=2.0, clip_limit=3.0, grid_size=4)
        diff = np.abs(adjust_brightness(torch.from_numpy(x), **kw).numpy().astype(int)
                      - jax_brightness(x, **kw).astype(int))
        assert diff.max() <= 1

    def test_behaviour(self):
        """tests/test_preprocess.py's cases: over-bright darkened, dark
        brightened, exposure spread reduced."""
        bright = np.full((64, 64, 3), 250, np.uint8)
        assert adjust_brightness(torch.from_numpy(bright)).numpy().mean() < bright.mean()
        rng = np.random.default_rng(4)
        dark = rng.integers(5, 40, (64, 64, 3)).astype(np.uint8)
        assert adjust_brightness(torch.from_numpy(dark)).numpy().astype(float).mean() \
            > dark.astype(float).mean()
        base = np.random.default_rng(5).random((64, 64, 3))
        lo, hi = (base * 60).astype(np.uint8), (base * 150 + 100).astype(np.uint8)
        od = adjust_brightness(torch.from_numpy(lo)).numpy().mean()
        ob = adjust_brightness(torch.from_numpy(hi)).numpy().mean()
        assert abs(ob - od) < (hi.mean() - lo.mean()) * 0.6


class TestCrop:
    @pytest.mark.parametrize("preset", sorted(jhost.CROP_PRESETS))
    @pytest.mark.parametrize("shape", [(2, 100, 160, 3), (1, 160, 100, 3), (1, 50, 60, 3)])
    def test_matches_jax_exactly(self, preset, shape):
        """Both presets, a portrait frame (S clamped to the width) and a frame
        too small for the offset (left clamped)."""
        assert thost.CROP_PRESETS == jhost.CROP_PRESETS
        x = frames(shape, 6)
        p = thost.CROP_PRESETS[preset]
        ref = np.asarray(jdev.crop_square(jnp.asarray(x), p["ratio"], p["x_offset"]))
        np.testing.assert_array_equal(
            crop_square(torch.from_numpy(x), p["ratio"], p["x_offset"]).numpy(), ref)

    def test_clamps_at_boundary(self):
        imgs = torch.arange(2 * 50 * 60 * 3, dtype=torch.int64).to(torch.uint8).reshape(2, 50, 60, 3)
        out = crop_square(imgs, 0.9, x_offset=1000)
        assert out.shape == (2, 45, 45, 3)
        np.testing.assert_array_equal(out[0, :, -1].numpy(), imgs[0, 2:47, -1].numpy())


class TestPreprocessBatch:
    """The JAX package jits the whole pipeline; its bins are held against
    the jitted ``rgb_to_lab`` of the crop."""

    @staticmethod
    def flipped_frames(x: np.ndarray) -> np.ndarray:
        crop = np.asarray(jdev.crop_square(jnp.asarray(x)))
        flips = bin_flips(np.asarray(jax.jit(jdev.rgb_to_lab)(jnp.asarray(crop))),
                          rgb_to_lab(torch.from_numpy(crop)).numpy())
        assert flips.sum() <= flip_bound(flips.size)
        return flips.any(axis=(1, 2))

    @pytest.mark.parametrize("out_hw", [(56, 56), (80, 80)])
    def test_normalized_matches_jax(self, out_hw):
        x = frames((4, 100, 160, 3), 7)
        ref = np.asarray(jdev.preprocess_batch(jnp.asarray(x), out_hw=out_hw))
        got = preprocess_batch(torch.from_numpy(x), out_hw=out_hw).numpy()
        assert got.dtype == np.float32 and got.shape == (4, *out_hw, 3)
        flipped = self.flipped_frames(x)
        assert not flipped.all()
        np.testing.assert_allclose(got[~flipped], ref[~flipped], atol=NORMALIZED_TOL, rtol=0)

    @pytest.mark.parametrize("out_hw", [(56, 56), None])
    def test_unnormalized_matches_jax(self, out_hw):
        """uint8 frames: the antialiased resize of frames 1 LSB apart,
        truncated to uint8, may land 2 apart."""
        x = frames((4, 100, 160, 3), 7)
        ref = np.asarray(jdev.preprocess_batch(jnp.asarray(x), out_hw=out_hw, normalize=False))
        got = preprocess_batch(torch.from_numpy(x), out_hw=out_hw, normalize=False).numpy()
        assert got.dtype == np.uint8 and got.shape == ref.shape
        flipped = self.flipped_frames(x)
        assert np.abs(got[~flipped].astype(int) - ref[~flipped].astype(int)).max() <= 2


def write_frames(folder, batch, ext=".png"):
    folder.mkdir(parents=True)
    for i, f in enumerate(batch):
        Image.fromarray(f).save(folder / f"{i:03d}{ext}")


class TestCli:
    def test_crop_matches_jax_file_for_file(self, tmp_path):
        write_frames(tmp_path / "in", frames((3, 100, 160, 3), 9))
        common = ["crop", "--input", str(tmp_path / "in"), "--dataset", "c3vd2"]
        jcli.main(common + ["--output", str(tmp_path / "j")])
        tcli.main(common + ["--output", str(tmp_path / "t"), "--device", "cpu"])
        names = sorted(p.name for p in (tmp_path / "t").iterdir())
        assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
        assert len(names) == 3 and names[0].startswith("cropped_")
        for n in names:
            assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes()
        assert Image.open(tmp_path / "t" / names[0]).size == (65, 65)

    def test_brightness_matches_jax_file_for_file(self, tmp_path):
        x = np.concatenate([smooth_frames(2, 64, 64, 10),
                            np.random.default_rng(10).integers(5, 60, (1, 64, 64, 3))
                            .astype(np.uint8)])
        write_frames(tmp_path / "in", x)
        common = ["brightness", "--input", str(tmp_path / "in"), "--clip_limit", "3.0"]
        jcli.main(common + ["--output", str(tmp_path / "j")])
        tcli.main(common + ["--output", str(tmp_path / "t"), "--device", "cpu"])
        names = sorted(p.name for p in (tmp_path / "t").iterdir())
        assert names == sorted(p.name for p in (tmp_path / "j").iterdir()) and len(names) == 3
        for n in names:
            a = np.asarray(Image.open(tmp_path / "t" / n)).astype(int)
            b = np.asarray(Image.open(tmp_path / "j" / n)).astype(int)
            assert np.abs(a - b).max() <= 1
        # the dark input brightened
        assert np.asarray(Image.open(tmp_path / "t" / names[2])).mean() > x[2].mean()

    def test_batches_of_the_folder_pass(self, tmp_path):
        """batch_size 2 over 5 frames: the same files as one batch."""
        write_frames(tmp_path / "in", smooth_frames(5, 40, 48, 11))
        thost.adjust_brightness_in_folder(tmp_path / "in", tmp_path / "a", batch_size=2,
                                          device="cpu")
        thost.adjust_brightness_in_folder(tmp_path / "in", tmp_path / "b", device="cpu")
        for p in sorted((tmp_path / "a").iterdir()):
            assert p.read_bytes() == (tmp_path / "b" / p.name).read_bytes()

    def test_video2frame_gated_error(self, tmp_path):
        fake = tmp_path / "v.mp4"
        fake.write_bytes(b"not a video")
        with pytest.raises(RuntimeError, match="ffmpeg"):
            thost.video_to_frames(fake, tmp_path / "frames")
        with pytest.raises(RuntimeError, match="ffmpeg"):
            tcli.main(["video2frame", "--video", str(fake), "--output", str(tmp_path / "f")])

    def test_missing_cuda_refused(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device runs")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(["crop", "--input", str(tmp_path), "--output", str(tmp_path / "o")])
