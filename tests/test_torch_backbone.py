"""reftr_torch ResNet backbone against reftr_tpu (float32, CPU, 64 px).

Tolerance: 1e-5. Convolutions sum in another order in XLA and in
PyTorch's CPU kernels; after 53 of them the seeded activations reach about
7 and the summation error grows with them, so the stage outputs are held
to 1e-5 times their largest magnitude (close_to_scale), single layers to an
absolute 1e-5.
"""

import numpy as np
import pytest
import torch

from reftr_tpu.nn.resnet import FrozenBatchNorm as JaxFrozenBN
from reftr_tpu.nn.resnet import ResNet as JaxResNet
from reftr_tpu.nn.resnet import downsample_mask as jax_downsample_mask
from reftr_torch.nn.resnet import FrozenBatchNorm, ResNet, downsample_mask
from torch_parity_utils import (close, close_to_scale, load_port,
                                random_flax_params, t)

ATOL = 1e-5


@pytest.mark.parametrize("dilation", [False, True])
def test_resnet50_matches_jax(dilation):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    jnet = JaxResNet("resnet50", dilation=dilation)
    params = random_flax_params(jnet, x)
    (want,) = jnet.apply({"params": params}, x)
    port = load_port(ResNet("resnet50", dilation), params)
    with torch.no_grad():
        got = port(t(x))
    assert tuple(got.shape) == want.shape
    close_to_scale(got, want, ATOL)


def test_frozen_bn_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 6, 8)).astype(np.float32)  # NHWC
    jbn = JaxFrozenBN(8)
    params = random_flax_params(jbn, x)
    want = jbn.apply({"params": params}, x)
    port = load_port(FrozenBatchNorm(8), params)
    close(port(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1), want, ATOL)


@pytest.mark.parametrize("hw,out_hw", [((64, 64), (2, 2)), ((37, 50), (5, 7)),
                                       ((640, 640), (20, 20))])
def test_downsample_mask_matches_jax(hw, out_hw):
    rng = np.random.default_rng(2)
    valid = rng.random((2,) + hw) > 0.3
    want = np.asarray(jax_downsample_mask(valid, out_hw))
    got = downsample_mask(t(valid), out_hw).numpy()
    np.testing.assert_array_equal(got, want)
