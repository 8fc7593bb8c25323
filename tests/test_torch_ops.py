"""reftr_torch ops and output decoding against reftr_tpu (float32, CPU).

Tolerance: atol 1e-6 for the box arithmetic and image normalisation
(elementwise f32), 1e-5 for the sine position encoding (sin/cos of
arguments up to 2*pi).
"""

import numpy as np
import pytest

from reftr_tpu.models import postprocess as jax_post
from reftr_tpu.ops import boxes as jax_boxes
from reftr_tpu.ops.image import normalize_images as jax_normalize
from reftr_tpu.ops.posenc import sine_position_embedding as jax_sine
from reftr_torch.models import postprocess
from reftr_torch.ops import boxes
from reftr_torch.ops.image import normalize_images
from reftr_torch.ops.posenc import sine_position_embedding
from torch_parity_utils import close, t


def random_cxcywh(rng, *shape):
    c = rng.uniform(0.2, 0.8, shape + (2,))
    wh = rng.uniform(0.05, 0.5, shape + (2,))
    return np.concatenate([c, wh], -1).astype(np.float32)


@pytest.mark.parametrize("name", ["box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh",
                                  "box_area"])
def test_box_conversions_match_jax(name):
    b = random_cxcywh(np.random.default_rng(0), 3, 5)
    close(getattr(boxes, name)(t(b)),
          getattr(jax_boxes, name)(b), 1e-6)


@pytest.mark.parametrize("name", ["box_iou_aligned",
                                  "generalized_box_iou_aligned"])
def test_aligned_iou_matches_jax(name):
    rng = np.random.default_rng(1)
    b1 = jax_boxes.box_cxcywh_to_xyxy(random_cxcywh(rng, 4, 3))
    b2 = jax_boxes.box_cxcywh_to_xyxy(random_cxcywh(rng, 4, 3))
    b1, b2 = np.array(b1), np.array(b2)
    b2[0, 0] = b1[0, 0]  # identical boxes: IoU 1
    got = getattr(boxes, name)(t(b1), t(b2))
    want = getattr(jax_boxes, name)(b1, b2)
    for g, w in zip(got, want) if isinstance(got, tuple) else [(got, want)]:
        close(g, w, 1e-6)


def test_sine_position_embedding_matches_jax():
    valid = np.ones((2, 9, 11), bool)
    valid[0, 6:] = False
    valid[1, :, 4:] = False
    for feats in (16, 128):
        close(sine_position_embedding(t(valid), feats),
              jax_sine(valid, feats), 1e-5)


def test_normalize_images_matches_jax():
    img = np.random.default_rng(2).integers(0, 256, (2, 5, 6, 3),
                                            dtype=np.uint8)
    close(normalize_images(t(img)), jax_normalize(img), 1e-6)


def test_decode_boxes_and_rec_metrics_match_jax():
    rng = np.random.default_rng(3)
    pred = random_cxcywh(rng, 4, 2, 3)  # [B, P, k, 4]
    target = random_cxcywh(rng, 4, 2)
    target[0, 0] = pred[0, 0, 0]  # a sure hit
    valid = np.array([[1, 1], [1, 0], [0, 0], [1, 1]], bool)
    sizes = np.array([[480, 640], [100, 50], [64, 64], [7, 9]], np.float32)
    close(postprocess.decode_boxes(t(pred)), jax_post.decode_boxes(pred),
          1e-6)
    close(postprocess.decode_boxes(t(pred), t(sizes), True),
          jax_post.decode_boxes(pred, sizes, True), 1e-4)
    got = postprocess.rec_metrics(t(pred), t(target), t(valid))
    want = jax_post.rec_metrics(pred, target, valid)
    assert set(got) == set(want)
    for key in want:
        close(got[key], want[key], 1e-5)
    with pytest.raises(ValueError):
        postprocess.decode_boxes(t(pred), None, True)
