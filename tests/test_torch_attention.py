"""The port's flash3 attention forward (vit_project_torch/ops/attention.py)
against the JAX package's packed-qkv flash kernel, run in interpret mode.

Inputs are drawn with numpy from a fixed seed and given to both packages.
On CPU tensors the port's wrapper takes its plain PyTorch version; the
CUDA kernel itself is checked on the card by tests/test_torch_cuda.py
(marker `cuda`) and by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_project_tpu.ops import attention as jattn
from vit_project_torch.ops import attention as tattn
from vit_project_torch.ops import cuda_build


def _qkv(B, S, H, dh, seed=0):
    rs = np.random.RandomState(seed)
    qkv = rs.randn(B, S, 3 * H * dh).astype(np.float32)
    qkv[..., :H * dh] *= dh ** -0.5      # q lanes prescaled, as the blocks do
    return qkv


def _jax_fwd(qkv, H, causal, dtype="float32"):
    B, S, D3 = qkv.shape
    fwd, _ = jattn._flash3_calls(B, S, D3, H, causal, dtype, True)
    o, lse = fwd(jnp.asarray(qkv, dtype))
    return np.asarray(o, np.float32), np.asarray(lse)[:, :S]


@pytest.mark.parametrize("S", [17, 77])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_jax_flash3(S, causal):
    """o and lse[:, :S] of the JAX kernel (interpret mode), f32, 1e-5."""
    H, dh = 2, 64
    qkv = _qkv(2, S, H, dh, seed=S)
    want_o, want_lse = _jax_fwd(qkv, H, causal)
    o, lse = tattn.flash3_fwd(torch.from_numpy(qkv), H, causal)
    assert o.shape == (2, S, H * dh) and lse.shape == (2, S, H)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), want_o, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_public_entry_matches_jax(causal):
    H, dh = 3, 64
    qkv = _qkv(2, 33, H, dh, seed=5)
    want = np.asarray(jattn.flash_mha_packed_qkv(
        jnp.asarray(qkv), num_heads=H, causal=causal, interpret=True))
    got = tattn.flash_mha_packed_qkv(torch.from_numpy(qkv), num_heads=H,
                                     causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_plain_bf16_matches_jax_bf16():
    """bf16: both round p to bf16 before the PV product; o is bf16. The
    tolerance is a few bf16 roundings of |o| <= ~3."""
    H, dh, S = 2, 64, 77
    qkv = _qkv(2, S, H, dh, seed=11)
    want_o, want_lse = _jax_fwd(qkv, H, True, "bfloat16")
    x = torch.from_numpy(np.asarray(jnp.asarray(qkv, jnp.bfloat16),
                                    np.float32)).to(torch.bfloat16)
    o, lse = tattn.flash3_fwd(x, H, True)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), want_o, atol=3e-2)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-4)


def test_cpu_path_launches_nothing():
    tattn.reset_launch_counts()
    tattn.flash_mha_packed_qkv(torch.from_numpy(_qkv(1, 9, 1, 64)),
                               num_heads=1)
    assert tattn.LAUNCHES["flash3_fwd"] == 0


@pytest.mark.parametrize("width,heads", [(64, 4), (60, 8), (192, 5)])
def test_rejects_misaligned_width(width, heads):
    with pytest.raises(ValueError, match="3\\*D"):
        tattn.flash_mha_packed_qkv(torch.zeros(1, 8, width), num_heads=heads)


def test_rejects_device_without_a_version():
    with pytest.raises(ValueError, match="no version"):
        tattn.flash3_fwd(torch.zeros(1, 8, 192, device="meta"), 1)


def test_build_targets_hopper_from_package_sources(tmp_path):
    cmd = cuda_build.nvcc_command("nvcc", "flash3_fwd", tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == str(cuda_build.CSRC_DIR / "flash3_fwd.cu")
    assert (cuda_build.CSRC_DIR / "flash3_fwd.cu").is_file()
    # the library is named by content: same source, same path
    p = cuda_build.library_path("flash3_fwd")
    assert p == cuda_build.library_path("flash3_fwd")
    assert p.parent == cuda_build.BUILD_DIR and p.suffix == ".so"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cuda_build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build(["flash3_fwd"])
