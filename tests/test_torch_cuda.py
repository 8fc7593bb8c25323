"""reftr_torch's CUDA flash-attention kernel against its plain version.

These tests need an NVIDIA card (the kernel has no CPU mode) and skip
without one. They import neither JAX nor the shared parity helpers, so on
a machine without JAX they run with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, against the plain version in float32 on the same inputs:
1e-5 max abs in float32 (sums in another order), 2e-2 in bfloat16 (the
kernel's output is rounded to bf16).
"""

import pytest
import torch

from reftr_torch.kernels.attention import attention_plain, flash_attention
from reftr_torch.nn.attention import MultiHeadAttention, set_plain_attention

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def inputs(gen, b, sq, sk, h, d, dtype):
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen)
               .to(dtype) for s in (sq, sk, sk))
    lens = torch.randint(1, sk + 1, (b,), device="cuda", generator=gen)
    valid = torch.arange(sk, device="cuda")[None] < lens[:, None]
    valid[0] = False  # every key masked: a uniform average
    return q, k, v, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (8, 440, 440, 8, 32), (8, 1, 1, 8, 32), (8, 1, 440, 8, 32),
    (8, 40, 40, 12, 64), (3, 70, 130, 4, 16), (2, 129, 65, 2, 64),
    (2, 5, 3, 2, 16)])
def test_kernel_matches_plain(gen, shape, dtype):
    q, k, v, valid = inputs(gen, *shape, dtype)
    out, lse = flash_attention(q, k, v, valid, return_lse=True)
    want, want_lse = attention_plain(q.float(), k.float(), v.float(), valid,
                                     return_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), want, atol=TOL[dtype], rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-6)


def test_kernel_without_mask(gen):
    q, k, v, _ = inputs(gen, 2, 33, 47, 4, 32, torch.float32)
    torch.testing.assert_close(flash_attention(q, k, v),
                               attention_plain(q, k, v), atol=1e-5, rtol=0)


def test_launch_counter_counts_kernel_launches(gen):
    q, k, v, valid = inputs(gen, 2, 8, 8, 2, 16, torch.float32)
    before = flash_attention.launches
    flash_attention(q, k, v, valid)
    attention_plain(q, k, v, valid)
    assert flash_attention.launches == before + 1


def test_wrapper_rejects_what_the_kernel_does_not_take(gen):
    q, k, v, valid = inputs(gen, 2, 8, 8, 2, 16, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                        valid)
    with pytest.raises(ValueError, match="head_dim"):
        w = torch.zeros(2, 8, 2, 48, device="cuda")
        flash_attention(w, w, w, valid)
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q, k, v, valid.cpu())


def test_mha_on_the_card_matches_the_plain_path(gen):
    torch.manual_seed(0)
    mha = MultiHeadAttention(256, 8).cuda().eval()
    x = torch.randn(4, 440, 256, device="cuda", generator=gen)
    valid = torch.arange(440, device="cuda")[None] < torch.tensor(
        [[440], [300], [41], [1]], device="cuda")
    with torch.no_grad():
        got = mha(x, x, x, valid)
        set_plain_attention(mha, True)
        want = mha(x, x, x, valid)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
