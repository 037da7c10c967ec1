"""The nested tier's order of work on the card (``da3slam_tpu_torch/models/nested.py``):
both branches enqueued with no host wait between them, the scale found and
applied on the device, the chunk fetched once.  ``old_order`` is the order of
work it replaced (each branch fetched, the scale and the rescale on the host);
``tests/test_torch_nested.py`` holds the port to it on the CPU, and this file
(marker ``cuda``, skipped without one; no JAX) on the card, bit for bit:

    python -m pytest --noconftest -m cuda tests/test_torch_nested_cuda.py
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from da3slam_tpu_torch.models import camera
from da3slam_tpu_torch.models.da3 import DepthAnything3, _load_images
from da3slam_tpu_torch.models.nested import DepthAnything3Nested, metric_scale_from_mono

IMGS = np.random.default_rng(0).integers(0, 256, size=(3, 56, 70, 3)).astype(np.uint8)
FIELDS = ("processed_images", "depth", "conf", "extrinsics", "intrinsics", "frame_desc")


def old_order(nested: DepthAnything3Nested, image, process_res: int,
              ref_view_strategy: str = "first"):
    """The any-view branch fetched, the metric branch fetched,
    ``metric_scale_from_mono`` on the numpy arrays (on the host), the rescale
    in numpy."""
    pred = nested.anyview.inference(image, process_res=process_res,
                                    ref_view_strategy=ref_view_strategy)
    if isinstance(image, torch.Tensor):
        ref_idx = camera.ref_view_index(image.shape[0], ref_view_strategy)
        ref_raw = image[ref_idx][None]
    else:
        raw = _load_images(image)
        ref_idx = camera.ref_view_index(raw.shape[0], ref_view_strategy)
        ref_raw = raw[ref_idx][None]
    mono = nested.metric.inference(ref_raw, process_res=process_res)
    s = metric_scale_from_mono(pred.depth[ref_idx], pred.conf[ref_idx],
                               mono.depth[0], mono.conf[0])
    sf = np.float32(s.item())
    ext = np.array(pred.extrinsics, np.float32)
    ext[:, :, 3] *= sf
    return dataclasses.replace(pred, depth=pred.depth * sf, extrinsics=ext,
                               metric_scale=float(sf))


def assert_equals_old_order(got, want) -> None:
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert isinstance(got.metric_scale, float) and got.metric_scale == want.metric_scale
    assert got.metric_scale != 1.0  # the scale was recovered, not the fallback


@pytest.fixture(scope="module")
def nested_on_card():
    """Two SMALL networks (nested-tiny's head width, 16, is not one the
    card's attention kernels are built for)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return DepthAnything3Nested(DepthAnything3.from_pretrained("small", seed=3, device="cuda"),
                                DepthAnything3.from_pretrained("small", seed=4, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [False, True], ids=["list", "staged"])
def test_default_call_equals_the_old_order(nested_on_card, staged):
    image = torch.from_numpy(IMGS).cuda() if staged else list(IMGS)
    assert_equals_old_order(nested_on_card.inference(image, process_res=70),
                            old_order(nested_on_card, image, 70))


@pytest.mark.cuda
def test_the_scale_on_the_card_equals_the_scale_on_the_host(nested_on_card):
    """f32 both: the same sorts and the same divisions, so the same median."""
    pred = nested_on_card.anyview.inference(list(IMGS), process_res=70, keep_on_device=True)
    mono = nested_on_card.metric.inference(IMGS[:1], process_res=70, keep_on_device=True)
    args = (pred.depth[0], pred.conf[0], mono.depth[0], mono.conf[0])
    on_card = metric_scale_from_mono(*args)
    on_host = metric_scale_from_mono(*(a.cpu() for a in args))
    assert on_card.device.type == "cuda" and on_card.dtype == on_host.dtype == torch.float32
    assert torch.equal(on_card.cpu(), on_host) and float(on_host) != 1.0


@pytest.mark.cuda
def test_a_staged_chunk_kept_on_the_device_waits_for_no_host_sync(nested_on_card):
    """Both branches, the scale and the rescale are enqueued without a host
    wait; only the fetch waits."""
    image = torch.from_numpy(IMGS).cuda()
    nested_on_card.inference(image, process_res=70, keep_on_device=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pred = nested_on_card.inference(image, process_res=70, keep_on_device=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert pred.depth.is_cuda and pred.metric_scale.ndim == 0
