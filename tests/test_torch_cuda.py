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
    assert tattn.LAUNCHES == {"flash3_fwd": 1, "flash3_bwd": 1, "flash_fwd": 0,
                              "flash_bwd": 0, "mha_fwd": 0, "mha_bwd": 0}


# S of the backward's card tests: one row, ragged and whole 16- and 64-row
# tiles, the ViT-B/16 (197) and CLIP image (257) lengths, and 433, the first
# past the bf16 whole-head route's limit (the streamed route)
BWD_LENGTHS = [1, 8, 63, 64, 65, 197, 200, 257,
               tattn.BWD_WHOLE_HEAD_MAX_S + 1]


def _assert_grads_close(got, ref, tol, S):
    """Each of dq, dk, dv within tol of its largest |value| in the plain
    version. At S = 1, p = 1 and ds = p (dp - c) = 0, so dq and dk are zero in
    exact arithmetic and both versions give float32 cancellation noise there:
    they are held to tol of the largest |value| of the three gradients."""
    whole = max(float(r.float().abs().max()) for r in ref)
    for a, r in zip(got, ref):
        scale = whole if S == 1 else float(r.float().abs().max())
        assert float((a.float() - r.float()).abs().max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -7)])
@pytest.mark.parametrize("B,S,H,causal", [(64, 257, 16, False),
                                          (66, 77, 12, True),
                                          (3, 17, 4, True), (2, 64, 2, False),
                                          (2, 65, 2, True), (1, 130, 2, True)]
                         + [(2, S, 2, c) for S in BWD_LENGTHS
                            for c in (False, True)])
def test_flash3_bwd_kernel_matches_plain(cuda_device, dtype, tol, B, S, H,
                                         causal):
    """dq, dk, dv against the plain backward, max |err| over max |ref| per
    gradient, as chip_smoke.py states it: f32 1e-5 (another order of
    summation), bf16 2^-7 (one bf16 spacing of the largest value). The
    shapes are the training step's image and text shapes, ragged tiles and
    BWD_LENGTHS (both bf16 routes); two launches give identical bits (no
    atomics)."""
    D = H * 64
    qkv = _qkv(B, S, H, 64, seed=S).to(cuda_device, dtype)
    do = torch.from_numpy(np.random.RandomState(S + 1).randn(B, S, D)
                          .astype(np.float32)).to(cuda_device, dtype)
    _, lse = tattn.flash3_fwd(qkv, H, causal)
    tattn.reset_launch_counts()
    got = tattn.flash3_bwd(qkv, do, lse, H, causal)
    assert tattn.LAUNCHES["flash3_bwd"] == 1
    ref = tattn.flash_mha_packed_qkv_bwd_reference(qkv, do, lse, H, causal)
    _assert_grads_close(got.split(D, -1), ref.split(D, -1), tol, S)
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


# -- the strided attention kernels: flash_fwd / flash_bwd (flash_mha_packed),
#    mha_fwd / mha_bwd (attention_core(_bshd) with use_kernel=True) ------------

def _rand(shape, seed, dtype, device, scale=1.0):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(device, dtype)


def _run_kernel(kernel, B, S, H, causal, dtype, device, seed):
    """(kernel outputs, plain outputs, launches) of one strided kernel on
    fresh inputs: flash_* on [B, S, D] (q prescaled), mha_* on
    [B, H, S, 64]."""
    if kernel.startswith("flash"):
        q, k, v, do = (_rand((B, S, H * 64), seed + i, dtype, device,
                             0.125 if i == 0 else 1.0) for i in range(4))
        _, lse = tattn.flash_mha_packed_reference(q, k, v, H, causal)
        calls = {"flash_fwd": (lambda: tattn.flash_fwd(q, k, v, H, causal),
                               lambda: tattn.flash_mha_packed_reference(
                                   q, k, v, H, causal)),
                 "flash_bwd": (lambda: tattn.flash_bwd(q, k, v, do, lse, H,
                                                       causal),
                               lambda: tattn.flash_mha_packed_bwd_reference(
                                   q, k, v, do, lse, H, causal))}
    else:
        q, k, v, do = (_rand((B, H, S, 64), seed + i, dtype, device)
                       for i in range(4))
        calls = {"mha_fwd": (lambda: (tattn.mha_fwd(q, k, v, causal),),
                             lambda: (tattn.mha_reference(q, k, v,
                                                          causal=causal),)),
                 "mha_bwd": (lambda: tattn.mha_bwd(q, k, v, do, causal),
                             lambda: tattn.mha_bwd_reference(q, k, v, do,
                                                             causal))}
    kernel_fn, plain_fn = calls[kernel]
    tattn.reset_launch_counts()
    got = kernel_fn()
    launches = dict(tattn.LAUNCHES)
    again = kernel_fn()
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics
    return got, plain_fn(), launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [13, 77, 197, 257])
@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd", "mha_fwd",
                                    "mha_bwd"])
def test_strided_attention_kernels_match_plain(cuda_device, kernel, S, causal,
                                               dtype):
    """Each kernel against its plain version at ragged S, as chip_smoke.py
    states the tolerances: forwards max |err| on o of 1e-5 in f32 and 2e-2
    (one bf16 spacing) in bf16, lse 1e-4; backwards max |err| over max |ref|
    per gradient of 1e-5 in f32 and 2^-7 in bf16. One launch per call, and
    two launches give identical bits."""
    got, ref, launches = _run_kernel(kernel, 2, S, 3, causal, dtype,
                                     cuda_device, seed=S)
    assert launches == {**dict.fromkeys(launches, 0), kernel: 1}
    bf16 = dtype == torch.bfloat16
    if kernel.endswith("fwd"):
        torch.testing.assert_close(got[0].float(), ref[0].float(), rtol=0,
                                   atol=2e-2 if bf16 else 1e-5)
        if kernel == "flash_fwd":
            torch.testing.assert_close(got[1], ref[1], atol=1e-4, rtol=0)
    else:
        for a, r in zip(got, ref):
            assert a.dtype == dtype
            err = float((a.float() - r.float()).abs().max())
            assert err <= (2 ** -7 if bf16 else 1e-5) * float(r.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_kernels_read_views_as_copies(cuda_device, dtype):
    """Operands read in place by strides give the bits of contiguous copies:
    q, k, v as slices of one packed [B, S, 3D] tensor (which also equal the
    packed flash3 kernels bit for bit, the same body), and [B, S, H, dh]
    tensors seen as [B, H, S, dh] by attention_core_bshd."""
    B, S, H, D = 2, 77, 3, 192
    qkv = _rand((B, S, 3 * D), 1, dtype, cuda_device)
    qkv[..., :D] *= 0.125
    do = _rand((B, S, D), 2, dtype, cuda_device)
    q, k, v = (qkv[..., i * D:(i + 1) * D] for i in range(3))
    assert not q.is_contiguous()
    o, lse = tattn.flash_fwd(q, k, v, H, True)
    oc, lsec = tattn.flash_fwd(q.contiguous(), k.contiguous(),
                               v.contiguous(), H, True)
    o3, lse3 = tattn.flash3_fwd(qkv, H, True)
    assert torch.equal(o, oc) and torch.equal(o, o3)
    assert torch.equal(lse, lsec) and torch.equal(lse, lse3)
    grads = tattn.flash_bwd(q, k, v, do, lse, H, True)
    gradsc = tattn.flash_bwd(q.contiguous(), k.contiguous(), v.contiguous(),
                             do, lse, H, True)
    assert all(torch.equal(a, b) for a, b in zip(grads, gradsc))
    assert torch.equal(torch.cat(grads, -1), tattn.flash3_bwd(qkv, do, lse, H,
                                                               True))

    bshd = [_rand((B, S, H, 64), 3 + i, dtype, cuda_device) for i in range(4)]
    views = [x.transpose(1, 2) for x in bshd]           # [B, H, S, dh] views
    copies = [x.contiguous() for x in views]
    o = tattn.mha_fwd(*views[:3])
    assert o.transpose(1, 2).is_contiguous()             # q's layout
    assert torch.equal(o, tattn.mha_fwd(*copies[:3]))
    assert all(torch.equal(a, b) for a, b in zip(tattn.mha_bwd(*views),
                                                 tattn.mha_bwd(*copies)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", BWD_LENGTHS)
def test_flash_bwd_reads_views_at_every_length(cuda_device, S, causal, dtype):
    """flash_bwd with q, k, v as slices of one packed [B, S, 3D] tensor and
    do as a [B, S, H, dh] tensor seen as [B, S, D]: within the backward's
    tolerance of the plain version, the bits of contiguous copies and of
    flash3_bwd on the packed tensor, and the same bits on a second launch."""
    B, H = 2, 3
    D = H * 64
    qkv = _rand((B, S, 3 * D), S, dtype, cuda_device)
    qkv[..., :D] *= 0.125
    q, k, v = (qkv[..., i * D:(i + 1) * D] for i in range(3))
    do = _rand((B, S, H, 64), S + 1, dtype, cuda_device).flatten(2)
    _, lse = tattn.flash_mha_packed_reference(q, k, v, H, causal)
    tattn.reset_launch_counts()
    grads = tattn.flash_bwd(q, k, v, do, lse, H, causal)
    assert tattn.LAUNCHES["flash_bwd"] == 1
    ref = tattn.flash_mha_packed_bwd_reference(q, k, v, do, lse, H, causal)
    assert all(a.dtype == dtype for a in grads)
    _assert_grads_close(grads, ref, 2 ** -7 if dtype == torch.bfloat16
                        else 1e-5, S)
    again = tattn.flash_bwd(q, k, v, do, lse, H, causal)
    copies = tattn.flash_bwd(q.contiguous(), k.contiguous(), v.contiguous(),
                             do.contiguous(), lse, H, causal)
    packed = tattn.flash3_bwd(qkv, do.contiguous(), lse, H, causal)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    assert all(torch.equal(a, b) for a, b in zip(grads, copies))
    assert torch.equal(torch.cat(grads, -1), packed)


@pytest.mark.cuda
def test_strided_kernels_reject_what_they_cannot_read(cuda_device):
    x = torch.zeros(1, 8, 2 * 32, device=cuda_device)
    with pytest.raises(ValueError, match="head width"):
        tattn.flash_fwd(x, x, x, 2)
    with pytest.raises(ValueError, match="head width"):
        tattn.mha_fwd(*(torch.zeros(1, 2, 8, 32, device=cuda_device),) * 3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tattn.mha_fwd(*(torch.zeros(1, 1, 8, 64, device=cuda_device,
                                    dtype=torch.float16),) * 3)
    buf = torch.zeros(1 * 8 * 64 + 1, device=cuda_device)
    shifted = buf[1:].view(1, 1, 8, 64)                  # 4-byte aligned only
    with pytest.raises(ValueError, match="16-byte"):
        tattn.mha_fwd(shifted, shifted, shifted)
    odd_rows = torch.zeros(1, 8, 65, device=cuda_device)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):    # row stride 65 floats
        tattn.flash_fwd(odd_rows, odd_rows, odd_rows, 1)
    lanes = torch.zeros(1, 1, 64, 8, device=cuda_device).transpose(-1, -2)
    with pytest.raises(ValueError, match="last dim contiguous"):
        tattn.mha_fwd(lanes, lanes, lanes)
    q = torch.zeros(1, 1, 8, 64, device=cuda_device)
    with pytest.raises(ValueError, match="do must be"):
        tattn.mha_bwd(q, q, q, q[:, :, :4])
    with pytest.raises(ValueError, match="lse must be"):
        tattn.flash_bwd(x[..., :64], x[..., :64], x[..., :64], x[..., :64],
                        torch.zeros(1, 8, 2, device=cuda_device), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["flash_mha_packed", "attention_core",
                                   "attention_core_bshd"])
def test_entry_points_launch_one_forward_and_one_backward(cuda_device, entry):
    """A user's call with a gradient: one forward launch, one backward
    launch, and the gradients of the plain versions."""
    B, S, H = 2, 33, 2
    if entry == "flash_mha_packed":
        shape, fwd, bwd = (B, S, H * 64), "flash_fwd", "flash_bwd"
        call = lambda *a: tattn.flash_mha_packed(*a, num_heads=H)
    else:
        shape = (B, H, S, 64) if entry == "attention_core" else (B, S, H, 64)
        fwd, bwd = "mha_fwd", "mha_bwd"
        call = lambda *a: getattr(tattn, entry)(*a, use_kernel=True)
    q_scale = 0.125 if entry == "flash_mha_packed" else 1.0  # q prescaled
    xs = [_rand(shape, i, torch.float32, cuda_device,
                q_scale if i == 0 else 1.0).requires_grad_(True)
          for i in range(3)]
    do = _rand(shape, 9, torch.float32, cuda_device)
    tattn.reset_launch_counts()
    o = call(*xs)
    grads = torch.autograd.grad(o, xs, do)
    assert tattn.LAUNCHES == {**dict.fromkeys(tattn.LAUNCHES, 0), fwd: 1,
                              bwd: 1}
    ys = [x.detach().cpu().requires_grad_(True) for x in xs]
    want = torch.autograd.grad(call(*ys), ys, do.cpu())
    for g, w in zip(grads, want):     # f32: another order of summation
        assert float((g.cpu() - w).abs().max()) <= 1e-5 * float(w.abs().max())


# S of mha_bwd's card tests: ragged tiles, the text (77), ViT-B/16 (197) and
# CLIP image (257) lengths, and both sides of the bf16 whole-head route's edge
MHA_BWD_LENGTHS = [13, 77, 197, 257, tattn.BWD_WHOLE_HEAD_MAX_S,
                   tattn.BWD_WHOLE_HEAD_MAX_S + 1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", MHA_BWD_LENGTHS)
def test_mha_bwd_routes_match_plain(cuda_device, S, causal, dtype):
    """mha_bwd on [B, S, H, dh] tensors seen as [B, H, S, dh] (the views of
    attention_core_bshd) on both bf16 routes: the whole-head route (p and ds
    enter the products as two bf16 terms) up to BWD_WHOLE_HEAD_MAX_S, the FMA
    route past it, and float32 on the FMA route. Each gradient within 2^-7
    (bf16; one bf16 spacing of the largest value) or 1e-5 (f32) of its
    largest |value| in the plain float32 version; one launch; the bits of
    contiguous copies; the same bits on a second launch."""
    B, H = 2, 2
    views = [_rand((B, S, H, 64), S + i, dtype, cuda_device).transpose(1, 2)
             for i in range(4)]
    tattn.reset_launch_counts()
    got = tattn.mha_bwd(*views, causal)
    assert tattn.LAUNCHES["mha_bwd"] == 1
    ref = tattn.mha_bwd_reference(*views, causal)
    assert all(a.dtype == dtype for a in got)
    _assert_grads_close(got, ref, 2 ** -7 if dtype == torch.bfloat16
                        else 1e-5, S)
    again = tattn.mha_bwd(*views, causal)
    copies = tattn.mha_bwd(*(x.contiguous() for x in views), causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, copies))


# S of the forwards' card tests: one row, both sides of 16 and 64 rows, the
# ViT-B/16 and CLIP image lengths, and both sides of the bf16 whole-head
# route's edge
FWD_LENGTHS = [1, 15, 16, 17, 63, 64, 65, 197, 257,
               tattn.FWD_WHOLE_HEAD_MAX_S, tattn.FWD_WHOLE_HEAD_MAX_S + 1]


def _assert_o_close(got, ref, dtype):
    """Each element of o within 1e-5 (f32) or, in bf16, within the larger of
    2e-2 and one bf16 spacing at its magnitude (chip_smoke.py's rule: both
    versions round one float32 value to bf16 once)."""
    diff = (got.float() - ref.float()).abs()
    tol = torch.full_like(diff, 1e-5 if dtype == torch.float32 else 2e-2)
    if dtype == torch.bfloat16:
        big = torch.maximum(got.float().abs(), ref.float().abs())
        tol = torch.maximum(tol, torch.exp2(torch.floor(torch.log2(
            big.clamp_min(2.0 ** -126))) - 7))
    assert bool(torch.isfinite(diff).all() and (diff <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", FWD_LENGTHS)
def test_forward_routes_match_plain(cuda_device, S, causal, dtype):
    """The three forward entries on both bf16 routes (whole head up to
    FWD_WHOLE_HEAD_MAX_S, streamed past it) and in float32: flash3_fwd on a
    packed qkv, flash_fwd on its q, k, v slices (strided views) and mha_fwd
    on [B, S, H, dh] tensors seen as [B, H, S, dh]. o as _assert_o_close
    says, lse within 1e-4; the strided entries give the packed one's bits
    and contiguous copies' bits; a second launch gives the same bits."""
    B, H = 2, 3
    D = H * 64
    qkv = _rand((B, S, 3 * D), S, dtype, cuda_device)
    qkv[..., :D] *= 0.125
    tattn.reset_launch_counts()
    o, lse = tattn.flash3_fwd(qkv, H, causal)
    assert tattn.LAUNCHES["flash3_fwd"] == 1
    ro, rl = tattn.flash_mha_packed_qkv_reference(qkv, H, causal)
    _assert_o_close(o, ro, dtype)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=0)
    again = tattn.flash3_fwd(qkv, H, causal)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    q, k, v = (qkv[..., i * D:(i + 1) * D] for i in range(3))
    o2, lse2 = tattn.flash_fwd(q, k, v, H, causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)

    views = [_rand((B, S, H, 64), S + 10 + i, dtype, cuda_device)
             .transpose(1, 2) for i in range(3)]
    om = tattn.mha_fwd(*views, causal)
    _assert_o_close(om, tattn.mha_reference(*views, causal=causal), dtype)
    assert torch.equal(om, tattn.mha_fwd(*views, causal))
    assert torch.equal(om, tattn.mha_fwd(*(x.contiguous() for x in views),
                                         causal))


# -- the fused dW + db kernel --------------------------------------------------

def _xg(N, Din, Dout, seed):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randn(N, Din).astype(np.float32)),
            torch.from_numpy(rs.randn(N, Dout).astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Din,Dout,x_off", [
    (197, 64, 1000, 0), (50, 768, 2304, 0), (300, 256, 768, 0), (33, 13, 7, 0),
    (1000, 130, 250, 0), (256, 768, 1000, 0), (4096, 768, 768, 0),
    # the ViT-B/16 block's four shapes (qkv, fc1, fc2; proj above) at N = 4,096
    # and at the training step's 50,432 rows
    (4096, 768, 2304, 0), (4096, 768, 3072, 0), (4096, 3072, 768, 0),
    (50432, 768, 2304, 0), (50432, 768, 768, 0), (50432, 768, 3072, 0),
    (50432, 3072, 768, 0),
    # x's base one element past a 16-byte boundary: bf16 takes the mma route
    (1000, 256, 768, 1)])
def test_dw_db_kernel_matches_plain(cuda_device, dtype, N, Din, Dout, x_off):
    """dW and db against the plain version on the same (rounded) inputs, max
    |err| over the largest |value| of each output: 1e-5 up to 4,096 rows
    (both are float32 sums of exact products in another order; the rounding
    stays near sqrt(N) * 2^-24 = 4e-6), chip_smoke.py's DWDB_TOLERANCE of
    1e-4 at 50,432 rows.
    Ragged N, Din and Dout, a Din and Dout that are not multiples of 8 and an
    unaligned base (the mma route, element-wise loads), the TMA route at
    every ViT shape, the float32 route, and the split rows; two launches
    give identical bits (no atomics)."""
    from vit_project_torch.ops import fused_dw as tfdw
    x, g = (t.to(cuda_device, dtype) for t in _xg(N, Din, Dout, N + Din))
    if x_off:
        buf = torch.empty(N * Din + x_off, device=cuda_device, dtype=dtype)
        buf[x_off:].copy_(x.reshape(-1))
        x = buf[x_off:].view(N, Din)
    want = ("fma" if dtype == torch.float32 else
            "tma" if Din % 8 == 0 and Dout % 8 == 0 and not x_off else "mma")
    assert tfdw.route(x, g) == want
    tfdw.reset_launch_counts()
    dw, db = tfdw.dw_db(x, g)
    assert tfdw.LAUNCHES["dw_db"] == 1
    assert dw.shape == (Din, Dout) and db.shape == (Dout,)
    assert dw.dtype == db.dtype == torch.float32
    rdw, rdb = tfdw.dw_db_reference(x, g)
    tol = 1e-5 if N <= 4096 else 1e-4
    for a, r in ((dw, rdw), (db, rdb)):
        assert float((a - r).abs().max()) <= tol * float(r.abs().max())
    dw2, db2 = tfdw.dw_db(x, g)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


@pytest.mark.cuda
def test_dw_db_kernel_rejects_what_it_does_not_take(cuda_device):
    from vit_project_torch.ops import fused_dw as tfdw
    x = torch.zeros(8, 16, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfdw.dw_db(x.half(), x.half())
    with pytest.raises(TypeError, match="share a dtype"):
        tfdw.dw_db(x, x.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        tfdw.dw_db(x.t(), torch.zeros(16, 4, device=cuda_device))
    with pytest.raises(ValueError, match="expected x2d"):
        tfdw.dw_db(x, x[:4])


# -- the LayerNorm kernels: ln_fwd / ln_bwd (layer_norm_fused) -----------------

def _ln_inputs(N, D, dtype, device, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(N, D) + rs.randn(N, 1)            # rows off centre
    dy = rs.randn(N, D)
    scale, bias = 1 + 0.1 * rs.randn(D), 0.1 * rs.randn(D)
    return [torch.from_numpy(a.astype(np.float32)).to(device, t)
            for a, t in ((x, dtype), (scale, torch.float32),
                         (bias, torch.float32), (dy, dtype))]


def _check_ln(x, scale, bias, dy):
    """Both kernels against their plain versions, as chip_smoke.py states
    the tolerances: y 1e-5 in f32 and one bf16 spacing at the element in
    bf16; mean and rstd 1e-5 relative; dx 1e-5 (f32) or 2^-7 (bf16) of the
    largest |dx|; dscale and dbias 1e-4 of their largest value. One launch
    each, and repeat launches give equal bits (no atomics)."""
    from vit_project_torch.ops import layernorm as tln
    bf16 = x.dtype == torch.bfloat16
    tln.reset_launch_counts()
    y, mean, rstd = tln.ln_fwd(x, scale, bias)
    dx, dsc, dbi = tln.ln_bwd(x, scale, mean, rstd, dy)
    assert tln.LAUNCHES == {"ln_fwd": 1, "ln_bwd": 1}
    ry, rmean, rrstd = tln.ln_fwd_reference(x, scale, bias)
    rdx, rdsc_p, rdbi_p = tln.ln_bwd_reference(x, scale, mean, rstd, dy)
    assert y.dtype == dx.dtype == x.dtype
    diff = (y.float() - ry.float()).abs()
    if bf16:
        big = torch.maximum(y.float().abs(), ry.float().abs())
        tol = torch.exp2(torch.floor(torch.log2(big.clamp_min(2.0 ** -126)))
                         - 7).clamp_min(1e-5)
    else:
        tol = torch.full_like(diff, 1e-5)
    assert bool((diff <= tol).all()), float(diff.max())
    torch.testing.assert_close(mean, rmean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rrstd, atol=0, rtol=1e-5)
    err = float((dx.float() - rdx.float()).abs().max())
    assert err <= (2 ** -7 if bf16 else 1e-5) * float(rdx.float().abs().max())
    for got, parts in ((dsc, rdsc_p), (dbi, rdbi_p)):
        want = tln.sum_partials(parts)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())
    y2, mean2, rstd2 = tln.ln_fwd(x, scale, bias)
    again = tln.ln_bwd(x, scale, mean, rstd, dy)
    assert torch.equal(y, y2) and torch.equal(mean, mean2)
    assert torch.equal(rstd, rstd2)
    assert all(torch.equal(a, b) for a, b in zip((dx, dsc, dbi), again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 768, 1024])
@pytest.mark.parametrize("N", [1, 255, 256, 257, 5082, 50432, 67584])
def test_ln_kernels_match_plain(cuda_device, N, D, dtype):
    """Ragged last blocks (255, 257, 5,082 = 19 x 256 + 218 rows), a block
    with one row, the ViT-B/16 step's 50,432 rows and 264 x 256 rows (the
    backward's blocks of 32, 128 and 256 rows), and the widths of the tests
    and the models."""
    _check_ln(*_ln_inputs(N, D, dtype, cuda_device, seed=N + D))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 1032, 2048, 4096])
def test_ln_kernels_match_plain_at_the_width_limits(cuda_device, D, dtype):
    """The narrowest row, and rows read by two and four warps."""
    _check_ln(*_ln_inputs(300, D, dtype, cuda_device, seed=D))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_fused_launches_once_each_way(cuda_device, dtype):
    """A user's call with a gradient: one ln_fwd and one ln_bwd launch; the
    zero-stride cotangent of .sum() and a sliced one give the gradients of
    contiguous copies; the gradients equal the plain versions' on the CPU."""
    from vit_project_torch.ops import layernorm as tln
    x, scale, bias, _ = _ln_inputs(2 * 77, 768, dtype, cuda_device, seed=5)
    x = x.reshape(2, 77, 768)
    xs = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    tln.reset_launch_counts()
    y = tln.layer_norm_fused(*xs)
    got = torch.autograd.grad(y.sum(), xs)
    assert tln.LAUNCHES == {"ln_fwd": 1, "ln_bwd": 1}
    want = torch.autograd.grad(tln.layer_norm_fused(*xs), xs,
                               torch.ones_like(y))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    big = _rand((2, 77, 1536), 6, dtype, cuda_device)
    got = torch.autograd.grad(tln.layer_norm_fused(*xs), xs, big[..., ::2])
    want = torch.autograd.grad(tln.layer_norm_fused(*xs), xs,
                               big[..., ::2].contiguous())
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    ys = [t.detach().cpu().requires_grad_(True) for t in xs]
    cpu = torch.autograd.grad(tln.layer_norm_fused(*ys), ys, big[..., ::2].cpu())
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for g, w in zip(got, cpu):
        assert g.dtype == w.dtype
        assert float((g.cpu().float() - w.float()).abs().max()) <= tol * max(
            1.0, float(w.float().abs().max()))


@pytest.mark.cuda
def test_ln_kernels_reject_what_they_do_not_take(cuda_device):
    from vit_project_torch.ops import layernorm as tln
    v = torch.ones(64, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tln.layer_norm_fused(torch.zeros(4, 64, device=cuda_device,
                                         dtype=torch.float16), v, v)
    for D in (100, 8192):
        w = torch.ones(D, device=cuda_device)
        with pytest.raises(ValueError, match="multiple of 8 from 8 to 4096"):
            tln.layer_norm_fused(torch.zeros(4, D, device=cuda_device), w, w)
    with pytest.raises(ValueError, match=r"expected \[D\]"):
        tln.ln_fwd(torch.zeros(4, 64, device=cuda_device), v[:8], v)
    tln.reset_launch_counts()
    assert tln.LAUNCHES == {"ln_fwd": 0, "ln_bwd": 0}


# -- the checkpoint copy-out and the fork axis on the card ---------------------

@pytest.mark.cuda
def test_hostcopy_pinned_copy_equals_the_tensors(cuda_device):
    """prefetch_to_host copies CUDA leaves into pinned host memory on a side
    stream that waits for the work queued before it: the values and dtypes
    of a tensor still being computed, with later work queued behind."""
    from vit_project_torch.core import hostcopy
    a = torch.randn(2048, 2048, device=cuda_device)
    x = a
    for _ in range(8):
        x = x @ a / 45.0
    tree = {"x": x, "i": torch.arange(7, device=cuda_device),
            "h": x[:3, :3].to(torch.float16), "cpu": torch.ones(2),
            "n": None}
    (copy,) = hostcopy.prefetch_to_host(tree)
    assert copy._tree["x"].is_pinned()
    later = a @ a    # queued behind the copy's wait, not waited for by it
    got = copy.get()
    want = {k: v.cpu().numpy() for k, v in tree.items() if v is not None}
    for k, v in want.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)
    assert got["n"] is None and later.shape == (2048, 2048)


@pytest.mark.cuda
def test_fork_axis_launches_the_solo_step_kernels(cuda_device):
    """R = 8 forks of 64 rows (R*B = 512) in one lock-step batch: the solo
    step's flash3_fwd count and one flash3_bwd, on the full tower and from
    the cache; each fork's loss within bf16 rounding of its solo step's."""
    from vit_project_torch.adapters import dora as tadora
    from vit_project_torch.core.prng import Key
    from vit_project_torch.models import clip as tclip
    from vit_project_torch.train import clip_loop as tloop
    cfg = tclip.tiny_clip_config(width=128, layers=3, heads=2, patch=16,
                                 image_size=64, embed_dim=32, vocab=49408,
                                 context=16)
    model = tclip.init_clip_weights_(
        tclip.empty_clip(cfg, cuda_device),
        torch.Generator(device=cuda_device).manual_seed(0))
    init, static, acfg = tadora.apply_dora(
        model, tadora.dora_spec(3, 3, 2, 1), r=4, alpha=16, dropout=0.1,
        generator=torch.Generator(device=cuda_device).manual_seed(1))
    prompts = np.random.RandomState(0).randint(1, 400, (66, 16))
    tr = tloop.ClipHBATrainer(cfg, model, acfg, static, prompts, lr=1e-3,
                              compute_dtype=torch.bfloat16)
    rs = np.random.RandomState(2)
    imgs, tgts = tr.upload_dataset(
        rs.randint(0, 255, (512, 64, 64, 3)).astype(np.uint8),
        rs.rand(512, 66).astype(np.float32))
    idxs = [np.arange(64) + 64 * f for f in range(8)]
    tr.text_prefix_cache  # noqa: B018  (built before the counted steps)
    for cached in (False, True):
        src = tr.build_prefix_cache(imgs) if cached else imgs
        counts, solo = [], []
        for f in range(8):
            t = tadora.make_trainable(init, cuda_device)
            tattn.reset_launch_counts()
            solo.append(tr.train_step(t, tr.init_optimizer(t), src, tgts,
                                      idxs[f], Key((5, 0, 0)),
                                      cached=cached)[0])
            counts.append(dict(tattn.LAUNCHES))
        trs = [tadora.make_trainable(init, cuda_device) for _ in range(8)]
        tattn.reset_launch_counts()
        losses, oks = tr.train_step_forks(
            trs, [tr.init_optimizer(t) for t in trs], src, tgts, idxs,
            [Key((5, 0, 0))] * 8, cached=cached)
        assert tattn.LAUNCHES == counts[0]
        assert counts[0]["flash3_fwd"] == (3 if cached else 6)
        assert counts[0]["flash3_bwd"] == 1 and all(oks)
        np.testing.assert_allclose(losses, solo, rtol=2e-2, atol=1e-3)


# -- int8 serving and the AOT artifacts on the card --------------------------------

@pytest.mark.cuda
def test_int8_dense_on_the_card_equals_the_cpu(cuda_device):
    """The int8 product is an exact int32 sum (cuBLASLt here, the CPU's
    there) and the rescale the same IEEE f32 operations: equal bits."""
    from vit_project_torch.ops import quant as tquant
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(4, 50, 768).astype(np.float32))
    w = torch.from_numpy(rs.randn(2304, 768).astype(np.float32))
    b = torch.from_numpy(rs.randn(2304).astype(np.float32))
    wq = tquant.quantize_weight(w)
    want = tquant.int8_dense(x, wq, b)
    got = tquant.int8_dense(x.to(cuda_device), wq.to(cuda_device),
                            b.to(cuda_device))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_artifact_on_the_card_equals_the_live_engine(cuda_device, tmp_path,
                                                     quantize):
    """A ViT exported on the card (dh 64: the kernel's template) serves the
    live engine's bits, and every block's attention launches the kernel."""
    from vit_project_torch.models import vit as tvit
    from vit_project_torch.serve import export as sexport
    from vit_project_torch.serve import vit_classifier_engine
    cfg = tvit.ViTConfig(patch=8, width=128, layers=2, heads=2,
                         image_size=32, num_classes=10)
    model = tvit.init_vit_params(tvit.empty_vit(cfg, cuda_device),
                                 torch.Generator(device=cuda_device)
                                 .manual_seed(0))
    live = vit_classifier_engine(model, buckets=(4, 32), quantize=quantize,
                                 param_dtype=torch.bfloat16,
                                 device=cuda_device)
    sexport.export_serving(live, (32, 32, 3), str(tmp_path / "art"))
    aot = sexport.load_serving(str(tmp_path / "art"), device=cuda_device)
    imgs = np.random.RandomState(1).rand(37, 32, 32, 3).astype(np.float32)
    tattn.reset_launch_counts()
    got = aot(imgs)                       # chunks of 32 and 5 -> 4
    assert tattn.LAUNCHES["flash3_fwd"] == 2 * cfg.layers
    np.testing.assert_array_equal(got, live(imgs))
