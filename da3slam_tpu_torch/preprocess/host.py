"""Host-side preprocessing (counterpart of ``da3slam_tpu/preprocess/host.py``):
video decode and the folder passes, the pixel math on ``device`` in batches.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

# dataset crop presets from the reference
CROP_PRESETS = {
    "uka1": {"ratio": 0.8, "x_offset": 20},
    "c3vd2": {"ratio": 0.65, "x_offset": -30},
}

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".tif"}


def video_to_frames(
    video_path: str | Path,
    output_dir: str | Path,
    stride: int = 1,
    quality: int = 95,
) -> int:
    """Decode a video to ``%06d.jpg`` frames at a sample stride.  Needs
    imageio's ffmpeg plugin; raises a clear error when unavailable."""
    from PIL import Image

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = 0
    try:
        import imageio.v3 as iio

        # imiter is lazy: decode errors surface on iteration, keep it inside
        for i, frame in enumerate(iio.imiter(str(video_path))):
            if i % stride:
                continue
            Image.fromarray(np.asarray(frame)).save(out / f"{n:06d}.jpg", quality=quality)
            n += 1
    except Exception as e:
        raise RuntimeError(
            "video decoding failed — it needs imageio's ffmpeg backend "
            "(pip install imageio[ffmpeg]); alternatively extract frames "
            f"externally and start from an image directory. Underlying error: {e}"
        ) from e
    print(f"extracted {n} frames to {out}")
    return n


def _list_images(folder: str | Path) -> list[Path]:
    return sorted(p for p in Path(folder).iterdir() if p.suffix.lower() in IMAGE_EXTS)


def crop_images_in_folder(
    input_folder: str | Path,
    output_folder: str | Path,
    dataset: str = "uka1",
    ratio: float | None = None,
    x_offset: int | None = None,
    device: str | torch.device = "cuda",
) -> int:
    """Ratio-square crop every image (output files keep the reference's
    ``cropped_`` prefix)."""
    from PIL import Image

    from da3slam_tpu_torch.preprocess.device import crop_square

    preset = CROP_PRESETS.get(dataset, CROP_PRESETS["uka1"])
    ratio = preset["ratio"] if ratio is None else ratio
    x_offset = preset["x_offset"] if x_offset is None else x_offset

    out = Path(output_folder)
    out.mkdir(parents=True, exist_ok=True)
    n = 0
    for p in _list_images(input_folder):
        img = torch.from_numpy(np.array(Image.open(p).convert("RGB"))).to(device)
        cropped = crop_square(img[None], ratio, x_offset)[0].cpu().numpy()
        Image.fromarray(cropped).save(out / f"cropped_{p.name}")
        n += 1
    print(f"cropped {n} images → {out}")
    return n


def adjust_brightness_in_folder(
    input_folder: str | Path,
    output_folder: str | Path,
    batch_size: int = 16,
    device: str | torch.device = "cuda",
    **brightness_kwargs,
) -> int:
    """Brightness-normalise a folder in batches of ``batch_size`` frames on
    ``device``."""
    from PIL import Image

    from da3slam_tpu_torch.preprocess.device import adjust_brightness

    out = Path(output_folder)
    out.mkdir(parents=True, exist_ok=True)
    files = _list_images(input_folder)
    n = 0
    for start in range(0, len(files), batch_size):
        chunk = files[start:start + batch_size]
        imgs = np.stack([np.asarray(Image.open(p).convert("RGB")) for p in chunk])
        adjusted = adjust_brightness(torch.from_numpy(imgs).to(device),
                                     **brightness_kwargs).cpu().numpy()
        for p, a in zip(chunk, adjusted):
            Image.fromarray(a).save(out / p.name)
            n += 1
    print(f"brightness-normalised {n} images → {out}")
    return n
