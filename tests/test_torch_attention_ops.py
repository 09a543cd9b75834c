"""The port's attention library entry points (vit_project_torch/ops/attention.py:
``flash_mha_packed``, ``attention_core`` and ``attention_core_bshd``, with their
kernel wrappers and plain versions) against the JAX package's
``ops/attention.py``.

Inputs are drawn with numpy from a fixed seed, rounded to the working type
once, and given to both packages. The JAX side runs its Pallas kernels in
interpret mode (its default off the TPU) at the "highest" matmul precision
that tests/conftest.py sets. On CPU tensors the port's wrappers take their
plain PyTorch versions; the CUDA kernels are checked on the card by
tests/test_torch_cuda.py (marker `cuda`) and by chip_smoke.py.

Tolerances: float32 2e-5 (both sides exact f32 arithmetic in another order of
summation); bfloat16 2e-2 on outputs of |value| <= ~3 (both round p, and in
the flash backward ds, to bf16 at the same points, so they differ by about one
bf16 spacing), and on gradients 2e-2 of the largest |gradient|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_project_tpu.ops import attention as jattn
from vit_project_torch.ops import attention as tattn

B, S, H = 2, 13, 2          # S = 13 leaves ragged tiles and masked columns
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _arrays(n, shape, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(n)]


def _pair(a, dtype):
    """(torch tensor in `dtype`, the same values as a JAX array)."""
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy(), getattr(jnp, dtype))


def _close(got, want, dtype, grad=False):
    """got (torch) against want (JAX): absolute for outputs, relative to the
    largest |value| for bf16 gradients."""
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    tol = TOL[dtype]
    if grad and dtype == "bfloat16":
        tol *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _torch_vjp(fn, xs, do):
    xs = [x.clone().requires_grad_(True) for x in xs]
    out = fn(*xs)
    return out, torch.autograd.grad(out, xs, do)


CASES = [pytest.param(dh, causal, dtype, id=f"dh{dh}-{'causal' if causal else 'full'}-{dtype}")
         for dh in (16, 64) for causal in (False, True)
         for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("dh,causal,dtype", CASES)
def test_flash_mha_packed_matches_jax(dh, causal, dtype):
    """(a) o and autograd's dq, dk, dv against JAX flash_mha_packed and its
    custom VJP (the Pallas kernels _flash_fwd_kernel / _flash_bwd_kernel)."""
    q, k, v, do = _arrays(4, (B, S, H * dh), seed=dh + 2 * causal)
    q *= dh ** -0.5                       # q prescaled, as the callers do
    (tq, jq), (tk, jk), (tv, jv), (tdo, jdo) = (_pair(a, dtype)
                                                for a in (q, k, v, do))
    want, vjp = jax.vjp(lambda *a: jattn.flash_mha_packed(
        *a, num_heads=H, causal=causal, interpret=True), jq, jk, jv)
    got, grads = _torch_vjp(lambda *a: tattn.flash_mha_packed(
        *a, num_heads=H, causal=causal), (tq, tk, tv), tdo)
    assert got.dtype == tq.dtype
    _close(got, want, dtype)
    for g, w in zip(grads, vjp(jdo)):
        assert g.dtype == tq.dtype
        _close(g, w, dtype, grad=True)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("dh,causal,dtype", CASES)
def test_attention_core_kernel_path_matches_jax_pallas(layout, dh, causal,
                                                       dtype):
    """(b) attention_core(use_kernel=True) and attention_core_bshd against
    JAX's with use_pallas=True (_mha_pallas_raw forward, _mha_bwd_pallas
    backward), output and gradients."""
    shape = (B, H, S, dh) if layout == "bhsd" else (B, S, H, dh)
    jfn, tfn = ((jattn.attention_core, tattn.attention_core)
                if layout == "bhsd" else
                (jattn.attention_core_bshd, tattn.attention_core_bshd))
    (tq, jq), (tk, jk), (tv, jv), (tdo, jdo) = (
        _pair(a, dtype) for a in _arrays(4, shape, seed=10 + dh + causal))
    want, vjp = jax.vjp(lambda *a: jfn(*a, causal=causal, use_pallas=True),
                        jq, jk, jv)
    got, grads = _torch_vjp(lambda *a: tfn(*a, causal=causal, use_kernel=True),
                            (tq, tk, tv), tdo)
    assert got.shape == shape and got.dtype == tq.dtype
    _close(got, want, dtype)
    for g, w in zip(grads, vjp(jdo)):
        _close(g, w, dtype, grad=True)


@pytest.mark.parametrize("dh,causal,dtype", CASES)
def test_mha_bwd_matches_jax_pallas_backward(dh, causal, dtype):
    """(c) mha_bwd alone (no lse from a forward) against JAX
    _mha_bwd_pallas with the same do: both keep p and ds in f32 and round
    only the outputs."""
    (tq, jq), (tk, jk), (tv, jv), (tdo, jdo) = (
        _pair(a, dtype) for a in _arrays(4, (B, H, S, dh), seed=20 + dh))
    want = jattn._mha_bwd_pallas(jq, jk, jv, jdo, causal)
    got = tattn.mha_bwd(tq, tk, tv, tdo, causal)
    for g, w in zip(got, want):
        assert g.dtype == tq.dtype
        _close(g, w, dtype, grad=True)


@pytest.mark.parametrize("causal", [False, True])
def test_default_paths_and_references_match_jax(causal):
    """(d) the fused plain paths (use_kernel None or False) against JAX
    mha_fused_xla(_bshd), forward and gradients, and mha_reference /
    mha_bwd_reference against JAX's, float32 to 1e-5."""
    dh = 16
    q, k, v, do = _arrays(4, (B, H, S, dh), seed=30 + causal)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))

    def check(got, want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)

    for use_kernel in (None, False):
        want, vjp = jax.vjp(lambda *a: jattn.attention_core(
            *a, causal=causal, use_pallas=use_kernel), jq, jk, jv)
        got, grads = _torch_vjp(lambda *a: tattn.attention_core(
            *a, causal=causal, use_kernel=use_kernel), (tq, tk, tv), tdo)
        check(got, want)
        for g, w in zip(grads, vjp(jdo)):
            check(g, w)
    bshd = [x.transpose(1, 2).contiguous() for x in (tq, tk, tv)]
    check(tattn.attention_core_bshd(*bshd, causal=causal),
          jattn.mha_fused_xla_bshd(*(jnp.asarray(x.numpy()) for x in bshd),
                                   causal=causal))
    check(tattn.mha_fused_bshd(*bshd, causal=causal),
          jattn.attention_core_bshd(*(jnp.asarray(x.numpy()) for x in bshd),
                                    causal=causal))
    check(tattn.mha_reference(tq, tk, tv, causal=causal),
          jattn.mha_reference(jq, jk, jv, causal=causal))
    for g, w in zip(tattn.mha_bwd_reference(tq, tk, tv, tdo, causal),
                    jattn.mha_bwd_reference(jq, jk, jv, jdo, causal)):
        check(g, w)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_mha_packed_matches_packed_qkv(causal):
    """(e) the three-tensor entry against the single-tensor one on the
    concatenation, output and gradients, to 1e-6."""
    Bq, Sq, Hq, dh = 3, 16, 4, 8
    q, k, v, do = (torch.from_numpy(a) for a in
                   _arrays(4, (Bq, Sq, Hq * dh), seed=40 + causal))
    q = q * dh ** -0.5
    a, ga = _torch_vjp(lambda *x: tattn.flash_mha_packed(
        *x, num_heads=Hq, causal=causal), (q, k, v), do)
    b, gb = _torch_vjp(lambda *x: tattn.flash_mha_packed_qkv(
        torch.cat(x, dim=-1), num_heads=Hq, causal=causal), (q, k, v), do)
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                               atol=1e-6, rtol=0)
    for x, y in zip(ga, gb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6, rtol=0)


def test_flash_mha_packed_rejects_indivisible_heads():
    """(f) JAX's guard: a partial head would leave output lanes unwritten."""
    q = torch.zeros(1, 8, 20)
    with pytest.raises(ValueError, match="not divisible"):
        tattn.flash_mha_packed(q, q, q, num_heads=3)
    with pytest.raises(ValueError, match="not divisible"):
        tattn.flash_fwd(q, q, q, 3)
    with pytest.raises(TypeError, match="share a dtype"):
        tattn.flash_mha_packed(q, q.bfloat16(), q, num_heads=2)


def test_cpu_wrappers_take_the_plain_versions():
    """(g) on CPU tensors every kernel wrapper returns its plain version's
    result, the entry points differentiate through them, and nothing is
    counted as a launch."""
    tattn.reset_launch_counts()
    dh = 64
    q, k, v, do = (torch.from_numpy(a) for a in
                   _arrays(4, (B, S, H * dh), seed=50))
    o, lse = tattn.flash_fwd(q, k, v, H, True)
    ro, rlse = tattn.flash_mha_packed_reference(q, k, v, H, True)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    for a, b in zip(tattn.flash_bwd(q, k, v, do, lse, H, True),
                    tattn.flash_mha_packed_bwd_reference(q, k, v, do, lse, H,
                                                         True)):
        assert torch.equal(a, b)
    q4, k4, v4, do4 = (_heads_view(x) for x in (q, k, v, do))
    assert torch.equal(tattn.mha_fwd(q4, k4, v4, True),
                       tattn.mha_reference(q4, k4, v4, causal=True))
    for a, b in zip(tattn.mha_bwd(q4, k4, v4, do4, True),
                    tattn.mha_bwd_reference(q4, k4, v4, do4, True)):
        assert torch.equal(a, b)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    tattn.flash_mha_packed(*xs, num_heads=H).sum().backward()
    tattn.attention_core(*(_heads_view(x) for x in xs),
                         use_kernel=True).sum().backward()
    tattn.attention_core_bshd(*(x.reshape(B, S, H, dh) for x in xs),
                              use_kernel=True).sum().backward()
    assert all(x.grad is not None for x in xs)
    assert set(tattn.LAUNCHES) == {"flash3_fwd", "flash3_bwd", "flash_fwd",
                                   "flash_bwd", "mha_fwd", "mha_bwd"}
    assert all(n == 0 for n in tattn.LAUNCHES.values())


def _heads_view(x):
    """[B, S, H*dh] -> [B, H, S, dh], a strided view."""
    return x.reshape(B, S, H, -1).transpose(1, 2)


def test_autograd_functions_save_what_jax_saves():
    """FlashPacked keeps (qs, k, v, lse); MhaWhole keeps only (q, k, v), as
    JAX's _mha_fwd does, and its backward recomputes the statistics."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in
               _arrays(3, (1, 9, 64), seed=60))
    o = tattn.flash_mha_packed(q, k, v, num_heads=1)
    assert type(o.grad_fn).__name__ == "FlashPackedBackward"
    assert len(o.grad_fn.saved_tensors) == 4
    o = tattn.attention_core(*(x[:, None] for x in (q, k, v)), use_kernel=True)
    assert type(o.grad_fn).__name__ == "MhaWholeBackward"
    assert len(o.grad_fn.saved_tensors) == 3
    with torch.inference_mode():
        assert tattn.flash_mha_packed(q, k, v, num_heads=1).grad_fn is None
        assert tattn.attention_core(*(x[:, None] for x in (q, k, v)),
                                    use_kernel=True).grad_fn is None


def test_strided_operand_checks():
    """The checks the strided kernels' wrappers make before a launch (plain
    Python, so they run here on CPU tensors): views of one packed tensor and
    [B, S, H, dh] tensors seen as [B, H, S, dh] pass; a misaligned address,
    a row stride off the 16-byte grid, a non-contiguous last dim, another
    head width or dtype, and mismatched operands raise, never copy."""
    D = 3 * 64
    qkv = torch.zeros(2, 9, 3 * D)
    q, k, v = (tattn._heads(qkv[..., i * D:(i + 1) * D], 3) for i in range(3))
    assert tattn._check_views("flash_fwd", {"q": q, "k": k, "v": v}) == (2, 3, 9)
    bshd = torch.zeros(2, 9, 3, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert tattn._check_views("mha_fwd", {"q": bshd}) == (2, 3, 9)
    shifted = torch.zeros(9 * 64 + 1)[1:].view(1, 1, 9, 64)
    odd_rows = torch.zeros(1, 1, 9, 65)[..., :64]
    lanes = torch.zeros(1, 1, 64, 9).transpose(-1, -2)
    for bad in (shifted, odd_rows, lanes):
        with pytest.raises(ValueError, match="reads q by strides"):
            tattn._check_views("mha_fwd", {"q": bad})
    with pytest.raises(ValueError, match="head width"):
        tattn._check_views("mha_fwd", {"q": torch.zeros(1, 1, 9, 32)})
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tattn._check_views("mha_fwd", {"q": torch.zeros(1, 1, 9, 64).half()})
    with pytest.raises(ValueError, match="do must be"):
        tattn._check_views("mha_bwd", {"q": q, "do": q[:, :, :4]})
    # size-1 dims may carry any stride: they are never stepped over
    one = torch.zeros(1, 1, 9, 64).as_strided((1, 1, 9, 64), (7, 3, 64, 1))
    assert tattn._check_views("mha_fwd", {"q": one}) == (1, 1, 9)


@pytest.mark.parametrize("S,dtype,whole_head", [
    (1, torch.bfloat16, True), (197, torch.bfloat16, True),
    (257, torch.bfloat16, True), (432, torch.bfloat16, True),
    (433, torch.bfloat16, False), (197, torch.float32, False),
    (1, torch.float32, False)])
def test_bwd_route_and_scratch_follow_the_kernel(S, dtype, whole_head):
    """The wrappers' route choice for flash3_bwd / flash_bwd: bf16 up to the
    kernel's whole-head limit takes one launch and no row-sum scratch (a
    null pointer); f32, and bf16 past the limit, get a float32 [B, S, H]
    scratch. The limit is the CUDA source's kWholeHeadMaxS."""
    assert tattn.bwd_whole_head(S, dtype) is whole_head
    scratch = tattn._row_sum_scratch(2, S, 3, dtype, torch.device("cpu"))
    if whole_head:
        assert scratch is None and tattn._address(scratch) == 0
    else:
        assert scratch.shape == (2, S, 3) and scratch.dtype == torch.float32
        assert tattn._address(scratch) == scratch.data_ptr() != 0
    from vit_project_torch.ops import cuda_build
    source = (cuda_build.CSRC_DIR / "flash3_bwd.cu").read_text()
    assert (f"constexpr int kWholeHeadMaxS = {tattn.BWD_WHOLE_HEAD_MAX_S};"
            in source)


@pytest.mark.parametrize("S,dtype,whole_head", [
    (1, torch.bfloat16, True), (77, torch.bfloat16, True),
    (197, torch.bfloat16, True), (257, torch.bfloat16, True),
    (432, torch.bfloat16, True), (433, torch.bfloat16, False),
    (197, torch.float32, False)])
def test_mha_bwd_route_and_scratch_follow_the_kernel(S, dtype, whole_head,
                                                     monkeypatch):
    """mha_bwd takes the backward's whole-head route by the same predicate as
    flash3_bwd / flash_bwd (bwd_whole_head, the source's kWholeHeadMaxS): its
    wrapper then hands the kernel null lse and row-sum pointers, and
    allocates the two float32 [B, S, H] scratch tensors only on the other
    routes. The source selects the route for every entry by dtype and S
    alone."""
    calls = []
    monkeypatch.setattr(tattn, "_launch_strided",
                        lambda *a: calls.append(a))
    q = torch.zeros(2, 3, S, 64, dtype=dtype)
    grads = tattn._launch_mha_bwd(q, q, q, q, False)
    assert [g.shape for g in grads] == [q.shape] * 3
    (lib, entry, ptrs, views, B, S_, H, causal, dt), = calls
    assert (lib, entry, (B, S_, H), dt) == ("flash3_bwd", "mha_bwd",
                                             (2, S, 3), dtype)
    assert len(ptrs) == 9 and all(p != 0 for p in ptrs[:7])
    assert tattn.bwd_whole_head(S, dtype) is whole_head
    if whole_head:
        assert ptrs[7:] == [0, 0]
    else:
        assert 0 not in ptrs[7:] and ptrs[8] - ptrs[7] == 2 * S * 3 * 4
    from vit_project_torch.ops import cuda_build
    source = (cuda_build.CSRC_DIR / "flash3_bwd.cu").read_text()
    assert "if (dtype == 1 && S <= kWholeHeadMaxS) {" in source


@pytest.mark.parametrize("S,dtype,whole_head", [
    (1, torch.bfloat16, True), (77, torch.bfloat16, True),
    (257, torch.bfloat16, True), (288, torch.bfloat16, True),
    (289, torch.bfloat16, False), (197, torch.float32, False)])
def test_fwd_route_follows_the_kernel(S, dtype, whole_head):
    """The forwards' whole-head route (one block per head, its q, k and v
    read once) takes bf16 up to FWD_WHOLE_HEAD_MAX_S, the source's
    kFwdWholeHeadMaxS, for all three entries (one launch function)."""
    assert tattn.fwd_whole_head(S, dtype) is whole_head
    from vit_project_torch.ops import cuda_build
    source = (cuda_build.CSRC_DIR / "flash3_fwd.cu").read_text()
    assert (f"constexpr int kFwdWholeHeadMaxS = "
            f"{tattn.FWD_WHOLE_HEAD_MAX_S};" in source)
    assert ("if (S <= kFwdWholeHeadMaxS) return launch_fwd_whole_head(a, B, H, "
            "cs);" in source)


@pytest.mark.parametrize("S", [197, 257])
def test_two_term_split_keeps_float32_products(S):
    """The bf16 mha_bwd kernel multiplies its float32 operands (p, ds) as two
    bf16 terms, hi = bf16(x) and lo = bf16(x - hi), each product exact in
    float32 and both summed in one float32 accumulator. On float32 softmax
    rows p and bf16 do (dv = p^T do's operands, seeded numpy inputs at the
    ViT-B/16 and CLIP image lengths), every element of the two-term product
    lies within 2^-15 of sum |p| |do| of a float64 reference (2^-16 from the
    split, the rest from float32 accumulation). Rounding p to bf16 once, the
    flash entries' choice and another function, errs by more."""
    rs = np.random.RandomState(S)
    s = (rs.randn(S, S) * 2).astype(np.float32)
    e = np.exp(s - s.max(-1, keepdims=True))
    p = torch.from_numpy((e / e.sum(-1, keepdims=True)).astype(np.float32))
    do = torch.from_numpy(rs.randn(S, 64).astype(np.float32)).bfloat16()
    hi = p.bfloat16()
    lo = (p - hi.float()).bfloat16()
    assert torch.equal(p - hi.float(), (p.double() - hi.double()).float())
    two = torch.cat([hi, lo], 1).float() @ torch.cat([do, do], 0).float()
    one = hi.float() @ do.float()
    ref = p.double() @ do.double()
    scale = p.double().abs() @ do.double().abs()
    worst = {name: float(((x.double() - ref).abs() / scale).max())
             for name, x in (("two", two), ("one", one))}
    assert worst["two"] <= 2.0 ** -15
    assert worst["one"] > worst["two"] and worst["one"] > 2.0 ** -15
