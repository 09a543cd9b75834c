"""The port's step profiler (vit_project_torch/cli/profile.py) against the
JAX package's (vit_project_tpu/cli/profile.py): tests/test_profile.py's
bucketing cases carried over to the kernels the port launches, the table
each package renders from the same numbers, the --memory rows against
JAX's analyze_memory on its 8-device virtual mesh (tests/conftest.py),
and the refusals in JAX's words.

The device trace needs the card; here the CLI's trace mode runs the step
on the CPU and must raise for want of CUDA device time, leaving no
temporary directory behind."""
import glob
import json
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vit_project_torch.cli import profile as prof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _row(name, count, self_us):
    return (name, count, self_us)


# Rows named as torch.profiler names the port's ViT step's kernels (one of
# each kind), with tests/test_profile.py's self times: the per-bucket sums
# are JAX's (the dW bucket's 18 ms split into the kernel and its fix-up)
ROWS = [
    # forward product (cuBLASLt's jit kernel on the H100)
    _row("nvjet_tst_192x192_64x4_2x1_v_bz_coopA_TNT", 36, 30000.0),
    # dx product
    _row("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_"
         "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas",
         36, 9000.0),
    # the dW+db kernel and its fix-up
    _row("dw_db_tma_kernel(CUtensorMap, CUtensorMap, float*, int, int, int, "
         "Schedule)", 147, 15000.0),
    _row("dw_db_fixup_kernel(float const*, float*, int, int, int, int, "
         "Schedule, int)", 147, 3000.0),
    # the flash3 kernels
    _row("void attn_fwd_head_bf16_kernel<8>(FwdArgs<__nv_bfloat16>)", 36,
         4200.0),
    _row("void attn_bwd_head_bf16_kernel<8, 2>(BwdArgs<__nv_bfloat16>)",
         36, 7800.0),
    # elementwise / reduce
    _row("void at::native::(anonymous namespace)::vectorized_layer_norm_"
         "kernel<c10::BFloat16, float, true>(int, float, c10::BFloat16 "
         "const*, float*, float*)", 75, 7200.0),
    _row("void at::native::vectorized_elementwise_kernel<4, at::native::"
         "GeluCUDAKernelImpl(at::TensorIteratorBase&, at::native::"
         "GeluType)::{lambda()#1}, std::array<char*, 2ul> >(int, ...)",
         36, 1100.0),
    # copies
    _row("Memcpy HtoD (Pageable -> Device)", 4, 700.0),
    _row("Memset (Device)", 4, 10.0),
    # other
    _row("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage"
         "<4096ul>)", 1, 50.0),
]
ROW_BUCKETS = [0, 0, 1, 1, 2, 3, 4, 4, 5, 5, 6]


class TestBucketing:
    def test_each_row_lands_in_its_bucket(self):
        assert [prof.bucket_of(r[0]) for r in ROWS] == [
            prof.BUCKETS[i] for i in ROW_BUCKETS]

    @pytest.mark.parametrize("name,bucket", [
        ("attn_fwd_bf16_kernel(FwdArgs<__nv_bfloat16>)", 2),
        ("attn_fwd_f32_kernel(FwdArgs<float>)", 2),
        ("attn_bwd_dq_bf16_kernel(BwdArgs<__nv_bfloat16>)", 3),
        ("void attn_bwd_dkv_fma_kernel<float>(BwdArgs<float>)", 3),
        ("dw_db_mma_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*, "
         "float*, int, int, int, Schedule, int)", 1),
        ("dw_db_fma_kernel(float const*, float const*, float*, int, int, "
         "int, Schedule)", 1),
        ("void gemv2T_kernel_val<int, int, __nv_bfloat16, __nv_bfloat16, "
         "float, float, 128, 16, 4, 4, false, false>(...)", 0),
        ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_"
         "bf16_64x64_64x4_tn_align8>(cutlass_80_tensorop_bf16_s16816gemm_"
         "relu_bf16_64x64_64x4_tn_align8::Params)", 0),
        ("void cublasLt::splitKreduce_kernel<32, 16, int, float, "
         "__nv_bfloat16, float, __nv_bfloat16, true, false, false>(...)", 0),
        ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel"
         "<at::native::(anonymous namespace)::TensorListMetadata<2>, "
         "at::native::(anonymous namespace)::BinaryOpListAlphaFunctor<float,"
         " 2, 2, 0>, std::plus<float>, float>(...)", 4),
        ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float,"
         " at::native::func_wrapper_t<float, at::native::sum_functor<float, "
         "float, float>::operator()(at::TensorIterator&)::{lambda(float, "
         "float)#1}>, unsigned int, float, 4, 4> >(...)", 4),
        ("void at::native::unrolled_elementwise_kernel<at::native::direct_"
         "copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::"
         "operator()() const::{lambda()#7}::operator()() const::{lambda("
         "float)#1}, std::array<char*, 2ul>, 4, ...>(...)", 4),
        ("void ln_fwd_kernel<__nv_bfloat16>(...)", 4),
        ("void (anonymous namespace)::softmax_warp_backward<float, float, "
         "float, 10, true, false>(float*, float const*, float const*, int, "
         "int, int, bool const*)", 4),
        ("Memcpy DtoD (Device -> Device)", 5),
        ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
         6),
        ("triton_poi_fused_add_0", 6),
    ])
    def test_kernel_names(self, name, bucket):
        assert prof.bucket_of(name) == prof.BUCKETS[bucket]

    def test_every_kernel_of_the_sources_has_its_bucket(self):
        """The rules follow the kernels' own names in csrc/*.cu: the
        forward's and backward's entries (the whole-head kernels at
        flash3_fwd.cu:265 and flash3_bwd.cu:570 among them), dw_db's
        routes and fix-up, and LayerNorm's."""
        want = {"attn_fwd": 2, "attn_bwd": 3, "dw_db": 1, "ln_": 4}
        names = []
        for path in glob.glob(os.path.join(ROOT, "vit_project_torch", "csrc",
                                           "*.cu")):
            src = open(path).read()
            names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                r"\([^)]*\)\s+)?(\w+)\s*\(", src)
        assert {"attn_fwd_head_bf16_kernel", "attn_bwd_head_bf16_kernel",
                "dw_db_fixup_kernel"} <= set(names)
        for name in names:
            prefix = next(p for p in want if name.startswith(p))
            assert prof.bucket_of(f"void {name}<8>(...)") == \
                prof.BUCKETS[want[prefix]], name

    def test_summarize_per_step_ms_and_totals(self):
        table, tops = prof.summarize(ROWS, steps=3)
        # dense: (30 + 9) ms total self over 3 steps -> 13 ms/step
        assert abs(table[prof.BUCKETS[0]]["ms"] - 13.0) < 1e-9
        assert abs(table[prof.BUCKETS[1]]["ms"] - 6.0) < 1e-9
        assert abs(table[prof.BUCKETS[2]]["ms"] - 1.4) < 1e-9
        assert abs(table[prof.BUCKETS[3]]["ms"] - 2.6) < 1e-9
        # the dW+db kernel and its fix-up, LayerNorm and GELU, memcpy and
        # memset: two kernels each
        assert table[prof.BUCKETS[1]]["ops"] == 2
        assert table[prof.BUCKETS[4]]["ops"] == 2
        assert table[prof.BUCKETS[5]]["ops"] == 2
        total = sum(v["ms"] for v in table.values())
        assert abs(total - sum(r[2] for r in ROWS) / 1000.0 / 3) < 1e-9
        assert [t[0] for t in tops] == sorted([t[0] for t in tops],
                                              reverse=True)
        assert tops[0][3] == ROWS[0][0] and tops[0][1] == 36

    def test_render_table_and_throughput_bound(self):
        table, tops = prof.summarize(ROWS, steps=3)
        out = prof.render(table, tops, steps=3, batch=256, top_k=3)
        assert "| bucket | ms/step |" in out
        assert "**total**" in out
        assert "device-bound throughput bound" in out
        assert "[cuBLAS GEMMs] nvjet_tst_192x192" in out

    def test_summarize_handles_null_cells(self):
        table, tops = prof.summarize([("nvjet_x", None, None)], steps=1)
        assert table[prof.BUCKETS[0]]["ms"] == 0.0
        assert tops == [(0.0, 0, prof.BUCKETS[0], "nvjet_x")]

    def test_rows_roundtrip_json(self, tmp_path):
        # the --raw dump is plain JSON of the rows
        p = tmp_path / "raw.json"
        p.write_text(json.dumps([{"name": n, "count": c, "self_device_us": us}
                                 for n, c, us in ROWS]))
        back = [(r["name"], r["count"], r["self_device_us"])
                for r in json.loads(p.read_text())]
        assert prof.summarize(back, 3) == prof.summarize(ROWS, 3)

    def test_device_rows_keep_the_cuda_events(self):
        """key_averages() -> rows: the CUDA-side events only (a CPU op's
        device time repeats its kernels')."""
        cuda, cpu = (torch.autograd.DeviceType.CUDA,
                     torch.autograd.DeviceType.CPU)
        events = [SimpleNamespace(key="aten::mm", count=3, device_type=cpu,
                                  self_device_time_total=900.0),
                  SimpleNamespace(key="nvjet_a", count=3, device_type=cuda,
                                  self_device_time_total=900.0),
                  SimpleNamespace(key="Memset (Device)", count=2,
                                  device_type=cuda,
                                  self_device_time_total=4.5)]
        assert prof.device_rows(events) == [("nvjet_a", 3, 900.0),
                                            ("Memset (Device)", 2, 4.5)]


def test_render_prints_jax_lines_under_the_label_map():
    """For the same bucket table, the port renders JAX's lines with each
    JAX bucket label replaced by the port's label at the same place (long
    labels in the table, short ones in the top list)."""
    from vit_project_tpu.cli import profile as jprof
    assert len(jprof.BUCKETS) == len(prof.BUCKETS)
    nums = [(13.0, 2), (6.0, 1), (1.4, 1), (2.6, 1), (2.766, 2), (0.2366, 2),
            (0.0, 0)]
    names = ["fusion.1", "multiply_subtract_fusion.4", "jvp__.3",
             "transpose_jvp___.15", "reduce_sum.5", "copy-done.839"]
    for buckets, mod in ((jprof.BUCKETS, jprof), (prof.BUCKETS, prof)):
        table = {b: {"ms": ms, "ops": ops}
                 for b, (ms, ops) in zip(buckets, nums)}
        tops = sorted([(nums[i][0], 12, buckets[i], names[i])
                       for i in range(6)], reverse=True)
        out = mod.render(table, tops, steps=3, batch=256, top_k=4)
        if mod is jprof:
            want = out
        else:
            got = out
    for jb, pb in zip(jprof.BUCKETS, prof.BUCKETS):
        want = want.replace(f"| {jb} |", f"| {pb} |").replace(
            f"[{jb.split(' (')[0]}]", f"[{pb.split(' (')[0]}]")
    assert got.splitlines() == want.splitlines()


# -- --memory ------------------------------------------------------------------

# test-tiny at 4 images a rank: 32,554 float32 parameters (130,216 bytes),
# an image 32 x 32 x 3 bytes and an int64 label
PARAM_BYTES = 130_216
BATCH_BYTES = 4 * (32 * 32 * 3 + 8)
# the port's per-rank (params, momentum) bytes, rank 0's share, fixed by
# its sharding rules. ZeRO-1 splits the momentum of every leaf whose
# leading axis ([out, in]: the output rows) the ranks divide: cls_token
# [1, 1, 32] and pos_embed [1, 17, 32] (576 floats) stay whole, and at N =
# 8 the head [10, 32] and its bias too (906); the other 31,978 (31,648)
# floats split, (576 + 31,978 / 2) x 4 and (906 + 31,648 / 8) x 4 bytes.
# FSDP2 splits every leaf's leading axis into ceil(d0 / N) rows a rank:
# rank 0 holds cls_token and pos_embed whole, and at N = 8 two of the
# head's 10 rows, (576 + 3,956 + 66) x 4 bytes. JAX keeps 1-D leaves and
# leaves the ranks do not divide whole on every device
PINNED = {(2, "zero1"): (PARAM_BYTES, 66_260),
          (8, "zero1"): (PARAM_BYTES, 19_448),
          (2, "fsdp"): (66_260, 66_260),
          (8, "fsdp"): (18_392, 18_392)}


def _plan(n, mode):
    return prof.plan_memory("test-tiny", 4, n, fsdp=mode == "fsdp",
                            zero1=mode == "zero1")


def test_dp_arguments_equal_jax_analyze_memory():
    """At dp the per-rank arguments are JAX's per-device arguments on its
    8-device mesh, less JAX's f32 learning-rate argument (a Python float
    in the port's step) and plus 4 bytes a label (int64 here, int32
    there)."""
    from vit_project_tpu.cli import profile as jprof
    ma, n_dev, gb = jprof.analyze_memory("test-tiny", 4,
                                         compute_dtype="float32")
    stats, n, global_bytes = _plan(8, "dp")
    assert n == n_dev == 8
    assert stats["params"] == stats["momentum"] == gb["params"] == \
        gb["momentum"] == PARAM_BYTES
    assert stats["arguments"] == ma.argument_size_in_bytes - 4 + 4 * 4
    assert global_bytes["params"] == gb["params"]
    assert global_bytes["batch (uint8 images + labels)"] == \
        gb["batch (uint8 images + labels)"] + 4 * 4 * 8


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_sharded_arguments_pinned(n, mode):
    stats, _, _ = _plan(n, mode)
    assert (stats["params"], stats["momentum"]) == PINNED[(n, mode)]
    assert stats["batch"] == BATCH_BYTES
    assert stats["arguments"] == sum(PINNED[(n, mode)]) + BATCH_BYTES


@pytest.mark.parametrize("n", [2, 8])
def test_fsdp_and_zero1_shrink_per_rank_arguments(n):
    # dp: params + momentum whole on every rank; zero1: the momentum's
    # split leaves 1/n; fsdp: both split (the batch is a rank's in all three)
    dp, z1, fs = (_plan(n, m)[0]["arguments"] for m in ("dp", "zero1",
                                                         "fsdp"))
    assert fs < z1 < dp, (fs, z1, dp)


def test_fsdp_ranks_hold_the_whole_tree_once():
    """The ranks' FSDP2 shares add up to the tree (no leaf counted twice,
    none lost), rank 0's the largest."""
    shares = [prof.plan_memory("test-tiny", 4, 8, fsdp=True, rank=r)[0]
              ["params"] for r in range(8)]
    assert sum(shares) == PARAM_BYTES and shares[0] == max(shares)


def test_render_memory_rows():
    stats, n, gb = _plan(8, "fsdp")
    out = prof.render_memory(stats, n, gb)
    assert "per-rank memory of one step (one process a device, over 8 " \
        "rank(s); rank 0's share)" in out
    assert "| buffer class | bytes/rank |" in out
    assert "global (unsharded) tree sizes for reference:" in out
    assert "peak" not in out           # no step measured
    out = prof.render_memory({**stats, "peak_allocated": 3 << 30,
                              "peak_reserved": 4 << 30}, n, gb)
    assert "| **peak allocated** (max_memory_allocated) | **3,072.0 MiB** |" \
        in out


def test_cli_virtual_devices_prints_table(capsys):
    rc = prof.main(["--memory", "--model", "test-tiny", "--batch", "4",
                    "--compute_dtype", "float32", "--fsdp",
                    "--virtual_devices", "8"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "global batch 32, float32, fsdp" in out
    assert "| buffer class | bytes/rank |" in out and "meta device" in out


def test_cli_memory_on_the_cpu_reads_what_it_holds(tmp_path, capsys):
    """Alone on the CPU: the dp trainer's tensors (no step), equal to the
    plan for one rank, and the note that the peak needs the card."""
    raw = tmp_path / "mem.json"
    assert prof.main(["--memory", "--device", "cpu", "--model", "test-tiny",
                      "--batch", "4", "--compute_dtype", "float32",
                      "--raw", str(raw)]) == 0
    got = json.loads(raw.read_text())
    plan = _plan(1, "dp")[0]
    assert got["n_ranks"] == 1 and got["peak_allocated"] is None
    for k in ("params", "momentum", "batch", "arguments"):
        assert got[k] == plan[k]
    assert "peak needs the card" in capsys.readouterr().out


# -- refusals and the device rule ------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--fsdp", "--model", "test-tiny"],
    ["--zero1", "--model", "test-tiny"],
    ["--virtual_devices", "4", "--model", "test-tiny"],
])
def test_refusals_in_jax_words(argv):
    from vit_project_tpu.cli import profile as jprof
    with pytest.raises(SystemExit) as want:
        jprof.main(argv)
    with pytest.raises(SystemExit) as got:
        prof.main(argv)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("flag", ["--zero1", "--fsdp"])
def test_sharded_memory_without_torchrun_is_the_trainers_refusal(flag):
    # no process group of its own: zero1 / fsdp need torchrun's, as in the
    # trainer; --virtual_devices plans without one
    with pytest.raises(ValueError, match="launch with torchrun"):
        prof.main(["--memory", flag, "--device", "cpu", "--model",
                   "test-tiny", "--batch", "4", "--compute_dtype",
                   "float32"])


def _trace_argv(*extra):
    return ["--model", "test-tiny", "--batch", "2", "--steps", "1",
            "--compute_dtype", "float32", "--device", "cpu", *extra]


def test_trace_without_device_time_raises_and_leaves_no_temp_dir(
        tmp_path, monkeypatch):
    made = tmp_path / "capture"

    def mkdtemp(prefix=""):
        os.makedirs(made)
        return str(made)
    monkeypatch.setattr(prof.tempfile, "mkdtemp", mkdtemp)
    with pytest.raises(RuntimeError, match="no CUDA device time"):
        prof.main(_trace_argv())
    assert not made.exists()


def test_trace_dir_is_kept(tmp_path, capsys):
    with pytest.raises(RuntimeError, match="no CUDA device time"):
        prof.main(_trace_argv("--trace_dir", str(tmp_path / "t")))
    assert glob.glob(str(tmp_path / "t" / "*.pt.trace.json"))
    assert "trace kept at" in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is visible")
@pytest.mark.parametrize("memory", [False, True])
def test_default_device_is_the_card(memory):
    argv = ["--model", "test-tiny", "--batch", "2"] + (
        ["--memory"] if memory else [])
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        prof.main(argv)
