"""The port's ``layer_norm_fused`` (vit_project_torch/ops/layernorm.py)
against the JAX package's ``ops/layernorm.layer_norm_fused``.

Inputs are drawn with numpy from a fixed seed, rounded to the working type
once, and given to both packages. The JAX side runs its Pallas kernels in
interpret mode (its default off the TPU); the port's wrappers take their
plain PyTorch versions for CPU tensors. The CUDA kernels are checked on the
card by tests/test_torch_cuda.py (marker `cuda`) and by chip_smoke.py.

Tolerances are those of the JAX package's own test of the kernel
(tests/test_ops.py, TestFusedLayerNorm): the forward 2e-6 in float32 and
2e-2 in bfloat16; the gradients rtol 1e-5 with atol 1e-4 in float32 and
5e-2 in bfloat16 (dscale and dbias sum hundreds of rows in another order)."""
import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_project_tpu.ops import layernorm as jln
from vit_project_torch.ops import cuda_build
from vit_project_torch.ops import layernorm as tln
from vit_project_torch.ops import nn as tnn

REPO = Path(__file__).resolve().parents[1]
FWD_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
GRAD_ATOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _inputs(shape, dtype, param_dtype, seed=0):
    """(JAX arrays, torch tensors) of x, scale, bias and the f32 cotangent
    do, with equal values: x and the parameters are rounded in JAX first."""
    rs = np.random.RandomState(seed)
    D = shape[-1]
    jx = jnp.asarray(rs.randn(*shape), getattr(jnp, dtype))
    js = jnp.asarray(1.0 + 0.1 * rs.randn(D), getattr(jnp, param_dtype))
    jb = jnp.asarray(0.1 * rs.randn(D), getattr(jnp, param_dtype))
    do = rs.randn(*shape).astype(np.float32)

    def to_torch(a, dt):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            getattr(torch, dt))
    return ((jx, js, jb, jnp.asarray(do)),
            (to_torch(jx, dtype), to_torch(js, param_dtype),
             to_torch(jb, param_dtype), torch.from_numpy(do)))


def _jax_run(jx, js, jb, jdo):
    y = jln.layer_norm_fused(jx, js, jb)

    def loss(x, s, b):
        return jnp.sum(jln.layer_norm_fused(x, s, b).astype(jnp.float32) * jdo)
    return y, jax.grad(loss, argnums=(0, 1, 2))(jx, js, jb)


def _torch_run(tx, ts, tb, tdo):
    xs = [t.clone().requires_grad_(True) for t in (tx, ts, tb)]
    y = tln.layer_norm_fused(*xs)
    grads = torch.autograd.grad((y.float() * tdo).sum(), xs)
    return y, grads


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("shape,dtype,param_dtype", [
    ((3, 9, 64), "float32", "float32"),       # 27 rows: one ragged block
    ((2, 300, 128), "float32", "float32"),    # 600 rows: 3 blocks
    ((4, 16, 256), "bfloat16", "float32"),
    ((3, 257, 768), "float32", "float32"),    # 771 rows: 4 blocks, last of 3
    ((4, 16, 256), "bfloat16", "bfloat16"),   # gradients come back in bf16
])
def test_layer_norm_fused_matches_jax(shape, dtype, param_dtype):
    jargs, targs = _inputs(shape, dtype, param_dtype)
    jy, jgrads = _jax_run(*jargs)
    ty, tgrads = _torch_run(*targs)
    assert ty.shape == shape and ty.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np32(ty), _np32(jy), atol=FWD_TOL[dtype],
                               rtol=0)
    for name, t, j, want_dtype in zip(("dx", "dscale", "dbias"), tgrads,
                                      jgrads, (dtype, param_dtype,
                                               param_dtype)):
        assert t.dtype == getattr(torch, want_dtype), name
        assert str(j.dtype) == want_dtype, name
        np.testing.assert_allclose(_np32(t), _np32(j), rtol=1e-5,
                                   atol=GRAD_ATOL[dtype], err_msg=name)


@pytest.mark.parametrize("shape,dtype", [((3, 9, 64), torch.float32),
                                         ((5, 257, 768), torch.float32),
                                         ((4, 16, 256), torch.bfloat16)])
def test_forward_matches_the_ports_layer_norm(shape, dtype):
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)
    scale = torch.from_numpy(1 + 0.1 * rs.randn(shape[-1]).astype(np.float32))
    bias = torch.from_numpy(0.1 * rs.randn(shape[-1]).astype(np.float32))
    got = tln.layer_norm_fused(x, scale, bias)
    want = tnn.layer_norm(x, scale, bias)
    assert got.dtype == want.dtype == dtype
    tol = 2e-6 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("N", [1, 255, 256, 257, 771])
def test_plain_partials_one_row_per_block_and_sum_to_the_full_sum(N):
    rs = np.random.RandomState(N)
    D = 64
    x, dy = (torch.from_numpy(rs.randn(N, D).astype(np.float32))
             for _ in range(2))
    scale = torch.from_numpy(1 + 0.1 * rs.randn(D).astype(np.float32))
    _, mean, rstd = tln.ln_fwd_reference(x, scale, torch.zeros(D))
    dx, dsc_p, dbi_p = tln.ln_bwd_reference(x, scale, mean, rstd, dy)
    n_b = -(-N // 256)
    assert dx.shape == (N, D)
    assert dsc_p.shape == dbi_p.shape == (n_b, D)
    assert dsc_p.dtype == dbi_p.dtype == torch.float32
    xhat = (x - mean) * rstd
    torch.testing.assert_close(tln.sum_partials(dsc_p), (dy * xhat).sum(0),
                               atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(tln.sum_partials(dbi_p), dy.sum(0),
                               atol=1e-4, rtol=1e-5)
    # each partial covers its own 256 rows and no padding
    torch.testing.assert_close(dbi_p[-1], dy[(n_b - 1) * 256:].sum(0),
                               atol=1e-5, rtol=1e-5)


_CAP = tln.BWD_MAX_BLOCKS
_CAP_ROWS = tln.BWD_MAX_BLOCKS * tln.BWD_MIN_ROWS   # the least N at the cap


@pytest.mark.parametrize("D,dtype", [(768, torch.bfloat16),
                                     (1024, torch.float32)])
@pytest.mark.parametrize("N", [1, 7, 8, 9, _CAP - 1, _CAP, _CAP + 1,
                               _CAP_ROWS - 1, _CAP_ROWS, _CAP_ROWS + 1,
                               5082, 16448, 50432, 67584, 10 ** 6])
def test_backward_partition_covers_every_row_once_in_order(N, D, dtype):
    """bwd_schedule's partition: every row in exactly one block, the blocks'
    ranges contiguous and in order (the last one ragged, none empty), at
    most BWD_MAX_BLOCKS blocks, and one partial row per block: the scratch
    is [blocks, 2D] float32 and nothing else."""
    sch = tln.bwd_schedule(N, D, dtype)
    assert 1 <= sch.blocks <= min(_CAP, -(-N // tln.BWD_MIN_ROWS))
    starts = [b * sch.rows for b in range(sch.blocks)]
    ends = [min(N, s + sch.rows) for s in starts]
    assert starts[0] == 0 and ends[-1] == N
    assert all(e == s for e, s in zip(ends, starts[1:]))      # contiguous
    assert all(s < e for s, e in zip(starts, ends))           # none empty
    owner = np.repeat(np.arange(sch.blocks), np.diff([*starts, N]))
    assert owner.shape == (N,) and (np.diff(owner) >= 0).all()
    assert sch.scratch == sch.blocks * 2 * D
    # the partition is a function of N alone: other widths and types agree
    assert tln.bwd_schedule(N, 64, torch.float32)[:2] == sch[:2]


@pytest.mark.parametrize("D,dtype,stages", [
    (768, torch.bfloat16, 4), (1024, torch.bfloat16, 3),
    (768, torch.float32, 2), (1024, torch.float32, 1),
    (8, torch.float32, 4), (2048, torch.float32, 1),
    (4096, torch.bfloat16, 3), (4096, torch.float32, 1)])
def test_backward_ring_leaves_room_for_two_blocks_an_sm(D, dtype, stages):
    """The ring of stages per row group fills at most BWD_RING_BYTES, and the
    dynamic shared memory (the ring, the row groups' sums or the final
    sum's staging) stays at most that, so two blocks fit in an H100 SM's
    228 KB."""
    sch = tln.bwd_schedule(50432, D, dtype)
    assert sch.stages == stages
    assert sch.smem <= tln.BWD_RING_BYTES
    assert sch.smem >= 8 * tln.BWD_MAX_BLOCKS * 16      # the final staging
    assert 2 * (sch.smem + 1024 + 512) <= 228 * 1024


def test_backward_schedule_constants_follow_the_kernel():
    """The Python mirror's constants are csrc/layernorm.cu's, and both
    compute the partition by the same formulas (the C entry
    ln_bwd_schedule is held to bwd_schedule on the card)."""
    source = (cuda_build.CSRC_DIR / "layernorm.cu").read_text()
    for name, value in (("kBwdMaxBlocks", tln.BWD_MAX_BLOCKS),
                        ("kBwdMinRows", tln.BWD_MIN_ROWS),
                        ("kBwdMaxStages", tln.BWD_MAX_STAGES)):
        assert f"constexpr int {name} = {value};" in source, name
    assert tln.BWD_RING_BYTES == 96 * 1024
    assert "constexpr int kBwdRingBytes = 96 * 1024;" in source
    assert "constexpr int kWarps = kThreads / 32;" in source
    assert "constexpr int kThreads = 256;" in source and tln._WARPS == 8
    for line in ("const int blocks = b < kBwdMaxBlocks ? b : kBwdMaxBlocks;",
                 "s.rows = N < 1 ? 1 : (N + blocks - 1) / blocks;",
                 "s.blocks = N < 1 ? 0 : (N + s.rows - 1) / s.rows;",
                 "s.scratch_floats = (long)s.blocks * 2 * D;"):
        assert line in source, line
    # ln_bwd: one cooperative launch, which sums the partials after a grid
    # barrier; the plain launch and the sum kernel only where the grid does
    # not fit. No atomics of any kind, no memset.
    assert source.count("cudaLaunchCooperativeKernel(") == 1
    assert "cooperative_groups::this_grid().sync();" in source
    assert source.count("<<<") == 3      # ln_fwd; the fallback's two kernels
    for word in ("atomicAdd", "atomicCAS", "red.global", "cudaMemset"):
        assert word not in source, word


def test_backward_launch_hands_the_kernel_the_schedules_scratch(monkeypatch):
    """What _launch_bwd gives the C entry: contiguous f32 mean and rstd as
    they come (no copy), the scratch of bwd_schedule's size, the dtype code,
    the device index and the stream; one ln_bwd launch counted."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(tln, "_entry", lambda name: entry)
    monkeypatch.setattr(tln, "_stream", lambda index: 12345)
    rs = np.random.RandomState(4)
    N, D = 771, 64
    x = torch.from_numpy(rs.randn(N, D).astype(np.float32)).bfloat16()
    dy = torch.from_numpy(rs.randn(N, D).astype(np.float32))   # f32: cast
    stats = torch.zeros(2 * N, 1)
    mean, rstd = stats[:N], stats[N:]
    tln.reset_launch_counts()
    seen = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        seen.append(t)
        return t
    monkeypatch.setattr(tln.torch, "empty", empty)
    dx, dsc, dbi = tln._launch_bwd(x, torch.ones(D), mean, rstd, dy)
    (args,) = calls
    assert args[1:4] != () and args[2] == mean.data_ptr()
    assert args[3] == rstd.data_ptr()          # no copy of the statistics
    assert args[8:] == (N, D, 1, x.device.index, 12345)
    scratch = next(t for t in seen if t.data_ptr() == args[6])
    assert scratch.numel() == tln.bwd_schedule(N, D, x.dtype).scratch
    assert scratch.dtype == torch.float32
    assert dx.dtype == x.dtype and dsc.shape == dbi.shape == (D,)
    assert tln.LAUNCHES == {"ln_fwd": 0, "ln_bwd": 1}
    tln.reset_launch_counts()


def _fake_entry(monkeypatch):
    """Replace the C entries by a recorder (the kernels need the card): the
    wrappers' host paths run on CPU tensors."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(tln, "_entry", lambda name: entry)
    monkeypatch.setattr(tln, "_stream", lambda index: 777)
    return calls


def test_forward_launch_passes_the_tensors_as_they_are(monkeypatch):
    """_launch_fwd's one pass of checks: contiguous, aligned x and f32 scale
    and bias go to the C entry as they are; mean and rstd are [N, 1] f32;
    one ln_fwd launch is counted."""
    calls = _fake_entry(monkeypatch)
    x = torch.randn(37, 64).bfloat16()
    scale, bias = torch.randn(64), torch.randn(64)
    tln.reset_launch_counts()
    y, mean, rstd = tln._launch_fwd(x, scale, bias, 1e-5)
    (args,) = calls
    assert args[:3] == (x.data_ptr(), scale.data_ptr(), bias.data_ptr())
    assert args[3:6] == (y.data_ptr(), mean.data_ptr(), rstd.data_ptr())
    assert args[6:] == (37, 64, 1e-5, 1, x.get_device(), 777)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert mean.shape == rstd.shape == (37, 1)
    assert mean.dtype == rstd.dtype == torch.float32
    assert tln.LAUNCHES == {"ln_fwd": 1, "ln_bwd": 0}
    tln.reset_launch_counts()


@pytest.mark.parametrize("case", ["misaligned", "strided", "bf16_params"])
def test_forward_launch_copies_only_what_the_kernel_cannot_read(monkeypatch,
                                                                case):
    """A view starting off a 16-byte boundary or a strided x is copied to
    contiguous rows; bf16 scale and bias become f32 copies; the pointers the
    C entry gets are the copies', aligned."""
    calls = _fake_entry(monkeypatch)
    flat = torch.randn(33 * 64 + 4)
    x = {"misaligned": flat[1:1 + 32 * 64].view(32, 64),
         "strided": torch.randn(32, 128)[:, ::2],
         "bf16_params": torch.randn(32, 64)}[case]
    scale, bias = torch.randn(64), torch.randn(64)
    if case == "bf16_params":
        scale, bias = scale.bfloat16(), bias.bfloat16()
    tln._launch_fwd(x, scale, bias, 1e-5)
    (args,) = calls
    assert all(p % 16 == 0 for p in args[:4])
    assert (args[0] == x.data_ptr()) == (case == "bf16_params")
    assert (args[1] == scale.data_ptr()) == (case != "bf16_params")
    tln.reset_launch_counts()


@pytest.mark.parametrize("bad,error,match", [
    ("dtype", TypeError, "float32 or bfloat16"),
    ("width", ValueError, "multiple of 8 from 8 to 4096"),
    ("scale", ValueError, r"expected \[D\]"),
    ("rank", ValueError, r"expected x2d \[N, D\]")])
def test_forward_launch_raises_before_launching(monkeypatch, bad, error,
                                                match):
    calls = _fake_entry(monkeypatch)
    x = {"dtype": torch.zeros(4, 64, dtype=torch.float16),
         "width": torch.zeros(4, 100), "scale": torch.zeros(4, 64),
         "rank": torch.zeros(2, 2, 64)}[bad]
    D = x.shape[-1]
    scale = torch.ones(8 if bad == "scale" else D)
    with pytest.raises(error, match=match):
        tln._launch_fwd(x, scale, torch.zeros(D), 1e-5)
    assert calls == []


def test_cpu_call_launches_nothing_and_never_builds(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU call reached cuda_build")
    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(cuda_build, "build", refuse)
    tln.reset_launch_counts()
    x = torch.randn(2, 5, 16, requires_grad=True)
    scale = torch.ones(16, requires_grad=True)
    bias = torch.zeros(16, requires_grad=True)
    tln.layer_norm_fused(x, scale, bias).sum().backward()
    assert tln.LAUNCHES == {"ln_fwd": 0, "ln_bwd": 0}
    assert x.grad.shape == x.shape and scale.grad.shape == (16,)


def test_zero_stride_and_sliced_cotangents_give_the_gradients_of_copies():
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(6, 40).astype(np.float32))
    scale = torch.from_numpy(1 + 0.1 * rs.randn(40).astype(np.float32))
    bias = torch.zeros(40)
    xs = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    got = torch.autograd.grad(tln.layer_norm_fused(*xs).sum(), xs)
    ys = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    want = torch.autograd.grad(tln.layer_norm_fused(*ys), ys,
                               torch.ones(6, 40))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    # a slice of y: a non-contiguous cotangent
    big = torch.from_numpy(rs.randn(6, 80).astype(np.float32))
    got = torch.autograd.grad(tln.layer_norm_fused(*xs), xs, big[:, ::2])
    want = torch.autograd.grad(tln.layer_norm_fused(*ys), ys,
                               big[:, ::2].contiguous())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_other_devices_and_shapes_raise():
    with pytest.raises(ValueError, match="no version for device"):
        tln.layer_norm_fused(torch.empty(2, 8, device="meta"),
                             torch.empty(8, device="meta"),
                             torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match=r"expected \[D\]"):
        tln.layer_norm_fused(torch.zeros(2, 8), torch.ones(4), torch.zeros(8))
    x, v = torch.zeros(2, 8), torch.ones(8)
    _, mean, rstd = tln.ln_fwd(x, v, v)
    with pytest.raises(ValueError, match="mean, rstd of 2 rows"):
        tln.ln_bwd(x, v, mean[:1], rstd, x)
    with pytest.raises(ValueError, match="mean, rstd of 2 rows"):
        tln.ln_bwd(x, v, mean, rstd, x[:1])


def test_the_no_jax_import_check_covers_the_module():
    from test_torch_clip import _port_modules
    path = REPO / "vit_project_torch" / "ops" / "layernorm.py"
    assert path in _port_modules()
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "torch" in names
    assert not {n.split(".")[0] for n in names} & {"jax", "jaxlib",
                                                     "vit_project_tpu"}
    code = ("import sys\nimport vit_project_torch.ops.layernorm\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'vit_project_tpu')]\nassert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
