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
    x = torch.zeros(1, 8, 192, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        tattn.flash3_fwd(x, 1)
