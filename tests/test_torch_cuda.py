"""The CUDA kernels against their plain versions, on the card.

Odd shapes the serving path does not hit — ragged M/N/K, ranks that are
not multiples of 8 or 16, large ranks, every decode GQA group size, both
head dims, non-causal and S != T attention — so each kernel's masking and
load paths are exercised. Marked ``cuda``: skipped without a CUDA device
of compute capability >= 9.0. Run on the card with

    python -m pytest -q tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances: bf16 linears 1e-2 (one bf16 ulp from another f32 summation
order); attention 2e-2 (p rounded to bf16 unnormalised by the kernel,
normalised by the plain version).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import tt_linear as ttl

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA device of compute capability >= 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rn(dev, *shape, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + sum(shape))
    return (torch.randn(*shape, generator=g, device=dev) * scale
            ).to(torch.bfloat16)


def _close(got, want, tol):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("m,k,n,r", [(37, 72, 48, 4), (37, 69, 45, 8),
                                     (1, 2048, 2048, 13), (130, 256, 96, 200),
                                     (64, 2048, 2048, 16)])
def test_tt_linear(dev, m, k, n, r):
    x, w = _rn(dev, m, k), _rn(dev, k, n, scale=k ** -0.5)
    a, b = _rn(dev, k, r, scale=k ** -0.5), _rn(dev, r, n, scale=r ** -0.5)
    _close(ttl.tt_linear(x, w, a, b, 4.0),
           ttl.tt_linear_plain(x, w, a, b, 4.0), 1e-2)


@pytest.mark.parametrize("m,k,n,r", [(1, 2048, 2048, 8), (4, 69, 45, 4),
                                     (17, 512, 96, 8), (64, 256, 130, 8),
                                     (5, 128, 64, 100)])
def test_tt_linear_batched_a(dev, m, k, n, r):
    x, w = _rn(dev, m, k), _rn(dev, k, n, scale=k ** -0.5)
    a, b = _rn(dev, m, k, r, scale=k ** -0.5), _rn(dev, r, n, scale=r ** -0.5)
    _close(ttl.tt_linear_batched_a(x, w, a, b, 2.0),
           ttl.tt_linear_batched_a_plain(x, w, a, b, 2.0), 1e-2)


@pytest.mark.parametrize("b,t,s,h,kv,d,causal", [
    (2, 70, 70, 8, 2, 64, True), (1, 33, 100, 4, 4, 128, False),
    (3, 5, 5, 4, 1, 64, True), (1, 300, 300, 2, 2, 64, True)])
def test_flash_attention(dev, b, t, s, h, kv, d, causal):
    q, k, v = _rn(dev, b, t, h, d), _rn(dev, b, s, kv, d), _rn(dev, b, s, kv, d)
    _close(tfa.flash_attention(q, k, v, causal),
           tfa.flash_attention_plain(q, k, v, causal), 2e-2)


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_decode_attention(dev, g, d):
    b, s, kv = 5, 300, 2
    q, k, v = _rn(dev, b, kv * g, d), _rn(dev, b, s, kv, d), _rn(dev, b, s, kv, d)
    pos = torch.tensor([0, 1, 150, 298, 299], dtype=torch.int32, device=dev)
    _close(tfa.decode_attention(q, k, v, pos),
           tfa.decode_attention_plain(q, k, v, pos), 2e-2)


def test_launch_counts_and_cpu_leg(dev):
    from repro_torch import kernels
    kernels.reset_launch_counts()
    x, w = _rn(dev, 4, 64), _rn(dev, 64, 32)
    a, b = _rn(dev, 64, 8), _rn(dev, 8, 32)
    ttl.tt_linear(x, w, a, b)
    ttl.tt_linear(x.cpu(), w.cpu(), a.cpu(), b.cpu())   # plain: not counted
    assert kernels.launch_counts()["tt_linear"] == 1
    with pytest.raises(TypeError):
        ttl.tt_linear(x.float(), w.float(), a.float(), b.float())
