"""The bytes each kernel must move reproduce the bounds of ``PERF.md``'s
kernel table at its shapes (bytes over 3.35 TB/s, each input read once and
each output written once)."""

import pytest

from gpubench import check_train, common, roofline

BF16 = "c10::BFloat16"


@pytest.mark.parametrize("op,shapes,dtypes,kernel,bound_ms", [
    ("fots_torch::instance_norm", [[16, 176, 320, 64], [64], [64], [], [], []],
     [BF16, "float", "float", "Scalar", "", ""], "K1'", 0.0689),
    ("fots_torch::spatial_stats", [[16, 704, 1280, 16]], [BF16], "K2'", 0.1377),
    ("fots_torch::spatial_norm", [[16, 704, 1280, 16], [16, 4, 16], [], []],
     [BF16, "float", "Scalar", "Scalar"], "K3'", 0.4132),
    ("fots_torch::pack_neighbors", [[16, 176, 320, 64]], [BF16], "K4'", 0.1722),
])
def test_bounds_of_the_kernel_table(op, shapes, dtypes, kernel, bound_ms):
    got = roofline.op_bytes(op, shapes, dtypes)
    assert list(got) == [kernel]
    assert round(roofline.bound_ms(got[kernel]), 4) == bound_ms


def test_backward_kernels_take_the_forward_call_shapes():
    x = [8, 160, 240, 64]
    b = roofline.op_bytes("fots_torch::instance_norm_stats", [x, [64], [64], [], [], []],
                          ["float"] * 3 + ["Scalar", "", ""], backward=True)
    assert list(b) == ["K1'-bwd"] and b["K1'-bwd"] >= 3 * 8 * 160 * 240 * 64 * 4
    p = roofline.op_bytes("fots_torch::pack_neighbors", [x], ["float"], backward=True)
    assert p == {"K4'-bwd": 5 * 8 * 160 * 240 * 64 * 4}


def test_share_is_bound_over_time_and_none_without_kernels():
    calls = [("fots_torch::pack_neighbors", [[1, 10, 10, 4]], ["float"])]
    need = roofline.op_bytes(*calls[0])["K4'"]
    us = roofline.bound_ms(need) * 1e3
    assert roofline.roofline_share(calls, {"K4'": 2 * us}, backward=False) == pytest.approx(50.0)
    assert roofline.roofline_share(calls, {}, backward=False) is None


@pytest.mark.parametrize("name,kernel", [
    ("void (anonymous namespace)::in_cluster_kernel<float, 4>(float const*)", "K1'"),
    ("(anonymous namespace)::in_bwd_cluster_kernel((anonymous namespace)::BwdArgs)", "K1'-bwd"),
    ("spatial_stats_kernel", "K2'"), ("spatial_norm_kernel<bf16>", "K3'"),
    ("pack_neighbors_bwd_kernel", "K4'-bwd"), ("pack_neighbors_kernel", "K4'"),
    ("sm90_xmma_fprop_implicit_gemm", None),
])
def test_kernel_names(name, kernel):
    assert roofline.kernel_of(name) == kernel


@pytest.mark.parametrize("name,shape,flops", [
    ("train-gateless-crops512-b32", (512, 512), 1146985381888),
    ("train-gated-frames640x960-b16", (640, 960), 1516490612736),
])
def test_step_flops_of_each_configuration(name, shape, flops):
    """``mfu.train``'s FLOPs of a step at the cell's image size, a batch of
    2, counted over the reference of the cell's model module: the counts
    the harness gave before the architecture was found by name."""
    cell = common.find_cell(name)
    assert check_train.step_flops(cell, {"batch": 2, "shape": shape}, "cpu") == flops
