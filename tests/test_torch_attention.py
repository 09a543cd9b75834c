"""The port's flash3 attention, forward and backward
(vit_project_torch/ops/attention.py), against the JAX package's packed-qkv
flash kernels, run in interpret mode.

Inputs are drawn with numpy from a fixed seed and given to both packages.
On CPU tensors the port's wrapper takes its plain PyTorch version; the
CUDA kernel itself is checked on the card by tests/test_torch_cuda.py
(marker `cuda`) and by chip_smoke.py."""
import jax
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


def _jax_vjp(qkv, do, H, causal, dtype=jnp.float32):
    """dqkv of the JAX public entry (Pallas backward in interpret mode)."""
    fn = lambda x: jattn.flash_mha_packed_qkv(x, num_heads=H, causal=causal,
                                              interpret=True)
    _, vjp = jax.vjp(fn, jnp.asarray(qkv, dtype))
    return np.asarray(vjp(jnp.asarray(do, dtype))[0], np.float32)


@pytest.mark.parametrize("S", [17, 77])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_jax_vjp(S, causal):
    """dq, dk and dv of the plain backward against jax.vjp of the JAX
    kernel, f32, 1e-5: both replay the forward's lse and take the same
    products in another order of summation."""
    H, dh = 2, 64
    qkv = _qkv(2, S, H, dh, seed=100 + S)
    do = np.random.RandomState(S).randn(2, S, H * dh).astype(np.float32)
    want = _jax_vjp(qkv, do, H, causal)
    x = torch.from_numpy(qkv)
    _, lse = tattn.flash3_fwd(x, H, causal)
    got = tattn.flash3_bwd(x, torch.from_numpy(do), lse, H, causal)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_plain_backward_bf16_matches_jax_bf16():
    """bf16: both round p and ds to bf16 before the products and dqkv at the
    end, so they differ by a few bf16 roundings of the largest gradient
    (|dq| <= ~20 here: 2^-7 * 20 = 0.16 per rounding)."""
    H, dh, S = 2, 64, 77
    qkv = _qkv(2, S, H, dh, seed=12)
    do = np.random.RandomState(13).randn(2, S, H * dh).astype(np.float32)
    want = _jax_vjp(qkv, do, H, True, jnp.bfloat16)
    bf = lambda a: torch.from_numpy(
        np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)).to(torch.bfloat16)
    x = bf(qkv)
    _, lse = tattn.flash3_fwd(x, H, True)
    got = tattn.flash3_bwd(x, bf(do), lse, H, True)
    assert got.dtype == torch.bfloat16
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=3 * 2 ** -7 * scale)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_matches_autograd_of_plain_forward(causal):
    """The autograd function's gradient (flash3_bwd) against torch autograd
    through the plain forward, f32: the same exact softmax gradient in
    another order, 1e-5 relative to the largest |grad|."""
    H, dh, S = 3, 64, 29
    qkv = torch.from_numpy(_qkv(2, S, H, dh, seed=21))
    w = torch.from_numpy(
        np.random.RandomState(22).randn(2, S, H * dh).astype(np.float32))
    a = qkv.clone().requires_grad_(True)
    (tattn.flash_mha_packed_qkv(a, num_heads=H, causal=causal) * w).sum() \
        .backward()
    b = qkv.clone().requires_grad_(True)
    (tattn.flash_mha_packed_qkv_reference(b, H, causal)[0] * w).sum() \
        .backward()
    scale = float(b.grad.abs().max())
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                               atol=1e-5 * scale, rtol=0)


def test_no_grad_path_skips_the_autograd_function():
    """Serving (inference mode) calls the forward alone: no saved tensors."""
    x = torch.from_numpy(_qkv(1, 9, 1, 64)).requires_grad_(True)
    with torch.inference_mode():
        o = tattn.flash_mha_packed_qkv(x, num_heads=1)
    assert o.grad_fn is None
    o = tattn.flash_mha_packed_qkv(x, num_heads=1)
    assert type(o.grad_fn).__name__ == "FlashPackedQKVBackward"


def test_cpu_path_launches_nothing():
    tattn.reset_launch_counts()
    x = torch.from_numpy(_qkv(1, 9, 1, 64)).requires_grad_(True)
    tattn.flash_mha_packed_qkv(x, num_heads=1).sum().backward()
    assert tattn.LAUNCHES == dict.fromkeys(
        ("flash3_fwd", "flash3_bwd", "flash_fwd", "flash_bwd", "mha_fwd",
         "mha_bwd"), 0)


@pytest.mark.parametrize("width,heads", [(64, 4), (60, 8), (192, 5)])
def test_rejects_misaligned_width(width, heads):
    with pytest.raises(ValueError, match="3\\*D"):
        tattn.flash_mha_packed_qkv(torch.zeros(1, 8, width), num_heads=heads)


def test_rejects_device_without_a_version():
    with pytest.raises(ValueError, match="no version"):
        tattn.flash3_fwd(torch.zeros(1, 8, 192, device="meta"), 1)
    with pytest.raises(ValueError, match="no version"):
        tattn.flash3_bwd(torch.zeros(1, 8, 192, device="meta"),
                         torch.zeros(1, 8, 64, device="meta"),
                         torch.zeros(1, 8, 1, device="meta"), 1)


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


def test_backward_source_is_built_for_hopper(tmp_path):
    assert cuda_build.SOURCES["flash3_bwd"] == "flash3_bwd.cu"
    cmd = cuda_build.nvcc_command("nvcc", "flash3_bwd", tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    src = cuda_build.CSRC_DIR / "flash3_bwd.cu"
    assert cmd[-1] == str(src) and src.is_file()
    text = src.read_text()
    # one packed cotangent, no float atomics (run-to-run identical gradients)
    assert 'extern "C" int flash3_bwd(' in text
    assert "atomicAdd" not in text
