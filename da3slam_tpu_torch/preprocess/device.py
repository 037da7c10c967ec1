"""Frame preprocessing on the device (counterpart of
``da3slam_tpu/preprocess/device.py``): ratio-square crop, LAB-space
brightness normalisation (CLAHE on L, highlight attenuation, shadow boost,
adaptive gamma, a 3x3 sharpen blended in), resize and ImageNet
normalisation, as plain PyTorch over ``[N, H, W, 3]`` batches.

The JAX package vmaps its per-frame functions; here ``clahe`` and
``adjust_brightness`` take a leading batch axis themselves.  Each function
runs on its input's device.

CLAHE bins a pixel by truncating its float L to an integer, so an L within
rounding of an integer can land in the neighbouring bin in another library
(or on another device): a bin flip moves one count of one tile's histogram
and the pixels of that bin around it, by up to a few LSB.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from da3slam_tpu_torch.core.transforms import highest_precision
from da3slam_tpu_torch.ops.resize import resize_bilinear, resize_normalize

# ---------------------------------------------------------------------------
# color space
# ---------------------------------------------------------------------------

_RGB2XYZ = ((0.412453, 0.357580, 0.180423),
            (0.212671, 0.715160, 0.072169),
            (0.019334, 0.119193, 0.950227))
_XYZ_WHITE = (0.950456, 1.0, 1.088754)
# the f32 inverse, as the JAX package takes it (jnp.linalg.inv of the f32 matrix)
_XYZ2RGB = torch.linalg.inv(torch.tensor(_RGB2XYZ, dtype=torch.float32)).tolist()


def _srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp_min(c, 0.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1 / 2.4) - 0.055)


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    d = 6.0 / 29.0
    # the cube root of the branch's own (positive) values
    return torch.where(t > d**3, torch.clamp_min(t, d**3) ** (1.0 / 3.0),
                       t / (3 * d * d) + 4.0 / 29.0)


def _lab_f_inv(t: torch.Tensor) -> torch.Tensor:
    d = 6.0 / 29.0
    return torch.where(t > d, t**3, 3 * d * d * (t - 4.0 / 29.0))


def _const(values, like: torch.Tensor) -> torch.Tensor:
    """A constant vector or matrix on ``like``'s device, filled there: a copy
    from pageable host memory would wait for the stream."""
    if isinstance(values[0], (tuple, list)):
        return torch.stack([_const(row, like) for row in values])
    return torch.stack([torch.full((), v, dtype=torch.float32, device=like.device)
                        for v in values])


@highest_precision()
def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """uint8/float RGB ``[..., 3]`` → LAB in OpenCV uint8 scaling
    (L ∈ [0, 255], a/b centred at 128)."""
    x = rgb.to(torch.float32)
    if rgb.dtype == torch.uint8:
        x = x / 255.0
    lin = _srgb_to_linear(x)
    xyz = lin @ _const(_RGB2XYZ, x).T / _const(_XYZ_WHITE, x)
    f = _lab_f(xyz)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([L * 255.0 / 100.0, a + 128.0, b + 128.0], dim=-1)


@highest_precision()
def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rgb_to_lab`; returns float RGB in [0, 1]."""
    L = lab[..., 0] * 100.0 / 255.0
    a = lab[..., 1] - 128.0
    b = lab[..., 2] - 128.0
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    xyz = torch.stack([_lab_f_inv(fx), _lab_f_inv(fy), _lab_f_inv(fz)], -1) \
        * _const(_XYZ_WHITE, lab)
    lin = xyz @ _const(_XYZ2RGB, lab).T
    return torch.clamp(_linear_to_srgb(lin), 0.0, 1.0)


# ---------------------------------------------------------------------------
# CLAHE
# ---------------------------------------------------------------------------

def _tile_histograms(bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Per-tile histograms of integer bin indices ``[..., P]`` → ``[..., B]``
    (f32 counts): one scatter-add over ``tile · n_bins + bin``.  The output
    size is known, so nothing waits for the device (``torch.bincount`` on a
    CUDA tensor reads its input's max back)."""
    lead = bins.shape[:-1]
    n_tiles = 1
    for d in lead:
        n_tiles *= d
    flat = bins.reshape(n_tiles, -1).to(torch.int64)
    idx = flat + torch.arange(n_tiles, device=bins.device)[:, None] * n_bins
    counts = torch.zeros(n_tiles * n_bins, dtype=torch.int64, device=bins.device)
    counts.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))
    return counts.reshape(*lead, n_bins).to(torch.float32)


def _bins(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Bin of a float L in [0, 255]: int32 truncation, as the JAX package."""
    return torch.clamp(x.to(torch.int32) * n_bins // 256, 0, n_bins - 1)


def clahe(
    l_channel: torch.Tensor,
    clip_limit: float = 2.0,
    grid_size: int = 8,
    n_bins: int = 256,
) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalisation of luminance
    ``[H, W]`` or ``[N, H, W]`` in [0, 255].

    Tiles each image ``grid_size × grid_size``, clips each tile's histogram at
    ``clip_limit ×`` the uniform level (redistributing the excess), builds
    per-tile CDF lookup curves, and maps each pixel through the bilinear
    interpolation of its 4 neighbouring tile curves.
    """
    single = l_channel.ndim == 2
    x_all = l_channel[None] if single else l_channel
    N, H, W = x_all.shape
    G = grid_size
    th, tw = H // G, W // G
    Hc, Wc = th * G, tw * G  # crop ragged edge for the histogram pass only
    x = x_all[:, :Hc, :Wc].reshape(N, G, th, G, tw).permute(0, 1, 3, 2, 4).reshape(
        N, G, G, th * tw)

    hist = _tile_histograms(_bins(x, n_bins), n_bins)  # [N, G, G, B]

    # clip + redistribute excess uniformly
    clip = clip_limit * (th * tw) / n_bins
    excess = torch.sum(torch.clamp_min(hist - clip, 0.0), dim=-1, keepdim=True)
    hist = torch.clamp_max(hist, clip) + excess / n_bins

    cdf = torch.cumsum(hist, dim=-1)
    cdf_min = cdf[..., :1]
    denom = torch.clamp_min(cdf[..., -1:] - cdf_min, 1.0)
    lut = (cdf - cdf_min) / denom * 255.0  # [N, G, G, B]

    # per-pixel bilinear interpolation of the 4 neighbouring tile LUTs
    dev = l_channel.device
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    gy = torch.clamp((yy - th / 2) / th, 0.0, G - 1.0)
    gx = torch.clamp((xx - tw / 2) / tw, 0.0, G - 1.0)
    y0 = torch.floor(gy).to(torch.int64)
    x0 = torch.floor(gx).to(torch.int64)
    y1 = torch.clamp_max(y0 + 1, G - 1)
    x1 = torch.clamp_max(x0 + 1, G - 1)
    fy = gy - y0
    fx = gx - x0

    pix_bin = _bins(x_all, n_bins).to(torch.int64).reshape(N, H * W)
    flat_lut = lut.reshape(N, G * G * n_bins)

    def look(ty, tx):
        tile = ((ty * G + tx) * n_bins).reshape(1, H * W)
        return torch.gather(flat_lut, 1, tile + pix_bin).reshape(N, H, W)

    v00, v01, v10, v11 = look(y0, x0), look(y0, x1), look(y1, x0), look(y1, x1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = top * (1 - fy) + bot * fy
    return out[0] if single else out


# ---------------------------------------------------------------------------
# brightness normalisation (the full reference chain)
# ---------------------------------------------------------------------------

def adjust_brightness(
    image: torch.Tensor,
    bright_threshold: float = 230.0,
    dark_threshold: float = 30.0,
    bright_reduction: float = 0.7,
    dark_enhancement: float = 1.5,
    clip_limit: float = 2.0,
    grid_size: int = 8,
    unsharp_alpha: float = 0.3,
) -> torch.Tensor:
    """Frames ``[H, W, 3]`` or ``[N, H, W, 3]`` uint8/float RGB → normalised
    uint8 RGB.

    The 5-step reference chain: CLAHE on L → attenuate over-bright pixels →
    boost over-dark pixels → adaptive gamma by mean brightness (per frame) →
    3x3 sharpen blended at α=0.3.
    """
    single = image.ndim == 3
    batch = image[None] if single else image
    lab = rgb_to_lab(batch)
    L, A, B = lab[..., 0], lab[..., 1], lab[..., 2]

    l_clahe = clahe(L, clip_limit, grid_size)
    # over-bright pixels use the attenuated ORIGINAL L (the reference keeps
    # the pre-CLAHE value there)
    l_result = torch.where(L > bright_threshold, torch.clamp(L * bright_reduction, 0, 255),
                           l_clahe)
    l_result = torch.where(L < dark_threshold,
                           torch.clamp(l_result * dark_enhancement, 0, 255), l_result)

    mean_b = torch.mean(l_result, dim=(1, 2), keepdim=True)
    gamma = torch.where(mean_b < 100.0, 0.8, torch.where(mean_b > 150.0, 1.2, 1.0))
    l_result = ((l_result / 255.0) ** gamma) * 255.0

    # 3x3 sharpen (the [[-1]*3,[-1,9,-1],[-1]*3] kernel) on the edge-padded
    # plane, + α-blend; full f32 (no TF32 in cuDNN)
    k = _const(((-1.0, -1.0, -1.0), (-1.0, 9.0, -1.0), (-1.0, -1.0, -1.0)), l_result)
    l_pad = F.pad(l_result[:, None], (1, 1, 1, 1), mode="replicate")
    with highest_precision():
        sharp = F.conv2d(l_pad, k[None, None])[:, 0]
    sharp = torch.clamp(sharp, 0.0, 255.0)
    l_final = (1 - unsharp_alpha) * l_result + unsharp_alpha * sharp

    out = lab_to_rgb(torch.stack([torch.clamp(l_final, 0, 255), A, B], dim=-1))
    out = torch.clamp(torch.round(out * 255.0), 0, 255).to(torch.uint8)
    return out[0] if single else out


# ---------------------------------------------------------------------------
# crop + batch pipeline
# ---------------------------------------------------------------------------

def crop_square(
    images: torch.Tensor,
    ratio: float = 0.8,
    x_offset: int = 20,
    y_offset: int = 0,
) -> torch.Tensor:
    """Batched ratio-square crop ``[N, H, W, 3]`` → ``[N, S, S, 3]`` with the
    reference's offset + boundary clamps (a view of the input)."""
    N, H, W, _ = images.shape
    # the reference sizes the square from the height alone; portrait inputs
    # (H*ratio > W) must clamp to the width or the slice is unsatisfiable
    S = min(int(H * ratio), W)
    left = (W - S) // 2 + x_offset
    top = int(H * (1 - ratio) / 2) + y_offset
    left = min(max(left, 0), W - S)
    top = min(max(top, 0), H - S)
    return images[:, top:top + S, left:left + S]


def preprocess_batch(
    frames: torch.Tensor,
    crop_ratio: float = 0.8,
    x_offset: int = 20,
    out_hw: tuple[int, int] | None = None,
    grid_size: int = 8,
    normalize: bool = True,
) -> torch.Tensor:
    """The ingest pipeline over a frame batch: crop → brightness-normalise →
    resize → ImageNet-normalise (f32), or with ``normalize=False`` the
    resized uint8 frames."""
    x = adjust_brightness(crop_square(frames, crop_ratio, x_offset), grid_size=grid_size)
    if out_hw is None:
        out_hw = (x.shape[1], x.shape[2])
    if normalize:
        return resize_normalize(x, out_hw)
    return resize_bilinear(x.to(torch.float32), out_hw).to(torch.uint8)
