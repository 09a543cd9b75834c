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


@pytest.mark.parametrize("N,rows", [(1, 32), (5082, 32), (16448, 32),
                                    (16896, 64), (50432, 128),
                                    (67584, 256), (10 ** 6, 256)])
def test_backward_kernel_blocks_fill_the_card(N, rows):
    """The backward kernel's rows per block: 256 where that still gives 264
    blocks (two per SM of an H100), else fewer, down to 32."""
    assert tln.bwd_block_rows(N) == rows


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
