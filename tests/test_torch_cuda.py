"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips on a host without a GPU (a CUDA
kernel has no CPU mode). The file imports neither JAX nor the JAX package, so
on a GPU host without JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from vit_project_torch.ops import attention as tattn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(B, S, H, dh, seed):
    rs = np.random.RandomState(seed)
    qkv = rs.randn(B, S, 3 * H * dh).astype(np.float32)
    qkv[..., :H * dh] *= dh ** -0.5      # q lanes prescaled, as the blocks do
    return torch.from_numpy(qkv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("S,causal", [(257, False), (77, True), (17, True),
                                      (64, False), (65, True)])
def test_flash3_kernel_matches_plain(cuda_device, dtype, atol, S, causal):
    """Ragged and whole tiles, both masks; tolerances as chip_smoke.py states
    them (bf16: one bf16 spacing of o)."""
    H = 4
    qkv = _qkv(3, S, H, 64, seed=S).to(cuda_device, dtype)
    tattn.reset_launch_counts()
    o, lse = tattn.flash3_fwd(qkv, H, causal)
    assert tattn.LAUNCHES["flash3_fwd"] == 1
    ro, rl = tattn.flash_mha_packed_qkv_reference(qkv, H, causal)
    torch.testing.assert_close(o.float(), ro.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_flash3_kernel_rejects_what_it_has_no_template_for(cuda_device):
    with pytest.raises(ValueError, match="head width"):
        tattn.flash3_fwd(torch.zeros(1, 8, 3 * 2 * 32, device=cuda_device), 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tattn.flash3_fwd(torch.zeros(1, 8, 192, device=cuda_device,
                                     dtype=torch.float16), 1)
    # with a gradient to record the forward still launches the kernel; its
    # backward is flash3_bwd (tested below)
    x = torch.zeros(1, 8, 192, device=cuda_device, requires_grad=True)
    tattn.reset_launch_counts()
    tattn.flash_mha_packed_qkv(x, num_heads=1).sum().backward()
    assert tattn.LAUNCHES == {"flash3_fwd": 1, "flash3_bwd": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("B,S,H,causal", [(64, 257, 16, False),
                                          (66, 77, 12, True),
                                          (3, 17, 4, True), (2, 64, 2, False),
                                          (2, 65, 2, True), (1, 130, 2, True)])
def test_flash3_bwd_kernel_matches_plain(cuda_device, dtype, tol, B, S, H,
                                         causal):
    """dq, dk, dv against the plain backward, max |err| over max |ref| per
    gradient, as chip_smoke.py states it: f32 1e-5 (another order of
    summation), bf16 2^-7 (one bf16 spacing of the largest value). The
    shapes are the training step's image and text shapes and ragged tiles;
    two launches give identical bits (no atomics)."""
    D = H * 64
    qkv = _qkv(B, S, H, 64, seed=S).to(cuda_device, dtype)
    do = torch.from_numpy(np.random.RandomState(S + 1).randn(B, S, D)
                          .astype(np.float32)).to(cuda_device, dtype)
    _, lse = tattn.flash3_fwd(qkv, H, causal)
    tattn.reset_launch_counts()
    got = tattn.flash3_bwd(qkv, do, lse, H, causal)
    assert tattn.LAUNCHES["flash3_bwd"] == 1
    ref = tattn.flash_mha_packed_qkv_bwd_reference(qkv, do, lse, H, causal)
    for i in range(3):
        a, r = got[..., i * D:(i + 1) * D].float(), ref[..., i * D:(i + 1) * D]
        r = r.float()
        assert float((a - r).abs().max()) <= tol * float(r.abs().max())
    assert torch.equal(got, tattn.flash3_bwd(qkv, do, lse, H, causal))


@pytest.mark.cuda
def test_flash3_bwd_kernel_rejects_what_it_has_no_template_for(cuda_device):
    qkv = torch.zeros(1, 8, 192, device=cuda_device)
    lse = torch.zeros(1, 8, 1, device=cuda_device)
    with pytest.raises(ValueError, match="do must be"):
        tattn.flash3_bwd(qkv, torch.zeros(1, 8, 64, device=cuda_device,
                                          dtype=torch.bfloat16), lse, 1)
    with pytest.raises(ValueError, match="lse must be"):
        tattn.flash3_bwd(qkv, torch.zeros(1, 8, 64, device=cuda_device),
                         lse[..., :0], 1)
    with pytest.raises(ValueError, match="head width"):
        tattn.flash3_bwd(torch.zeros(1, 8, 3 * 2 * 32, device=cuda_device),
                         torch.zeros(1, 8, 64, device=cuda_device),
                         torch.zeros(1, 8, 2, device=cuda_device), 2)
