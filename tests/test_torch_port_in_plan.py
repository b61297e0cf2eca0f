"""The plan of the two instance-norm kernels (K1', K1'-bwd): which route a
shape takes and how the cluster route cuts its plane; and the plain
emulation of the cluster route's summation order.

Pure arithmetic and CPU tensors: the kernels themselves run only on a card
(``python3 chip_smoke.py --phases build,kernels`` holds both routes there).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fots_torch.kernels import build
from fots_torch.ops import instance_norm as tin
from fots_torch.profiling import instance_norm_path_shapes

ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}

# every K1' / K1'-bwd call site of the serving, training, evaluation and
# recognition paths, as (kernel, h, w, c, itemsize)
PATH_CASES = []
for _path, (_b, _h, _w, _c), _dtype, _masked, _bwd in instance_norm_path_shapes():
    PATH_CASES.append(("instance_norm", _h, _w, _c, ITEMSIZE[_dtype]))
    if _bwd:
        PATH_CASES.append(("instance_norm_bwd", _h, _w, _c, 4))
PATH_CASES = sorted(set(PATH_CASES))


def _plan(kernel, h, w, c, itemsize):
    if kernel == "instance_norm":
        return tin.in_plan(h, w, c, itemsize)
    return tin.in_bwd_plan(h, w, c)


def _check_cluster_plan(plan, h, w, c, itemsize):
    """What every cluster plan must satisfy, whatever the shape."""
    hw = h * w
    group = tin.GROUP_BYTES // itemsize
    assert plan.cluster in tin.CLUSTER_SIZES
    assert plan.smem_bytes <= tin.SMEM_LIMIT
    assert plan.channels % group == 0 and c % plan.channels == 0
    lanes = plan.channels * itemsize // 16
    assert 1 <= lanes <= 32 and lanes & (lanes - 1) == 0
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.threads % lanes == 0
    # pixels: the ranks' shares tile [0, hw) in order, each at most a chunk
    shares = plan.shares(hw)
    assert len(shares) == plan.cluster
    covered = np.zeros(hw, np.int32)
    for p0, p1 in shares:
        assert 0 <= p0 <= p1 <= hw
        covered[p0:p1] += 1
    assert (covered == 1).all()
    chunk = -(-hw // plan.cluster)
    assert max(p1 - p0 for p0, p1 in shares) <= chunk
    # channels: c / channels clusters per sample cover every channel once
    assert (c // plan.channels) * plan.channels == c
    # bytes: the share of every held tensor, then the fold's scratch
    assert plan.block_bytes == chunk * plan.channels * itemsize * len(plan.held)
    scratch = (plan.threads // 32 + 2) * 2 * plan.channels * 4
    assert plan.smem_bytes == plan.block_bytes + scratch


@pytest.mark.parametrize("kernel,h,w,c,itemsize", PATH_CASES)
def test_path_shape_plans_fit_and_cover(kernel, h, w, c, itemsize):
    plan = _plan(kernel, h, w, c, itemsize)
    assert plan.route in ("cluster", "two_pass")
    if plan.route == "two_pass":
        # on the model paths only the backward of layer1's training shape:
        # x and g of a 64-byte group exceed sixteen blocks' shared memory
        assert (kernel, h, w, c) == ("instance_norm_bwd", 160, 240, 64)
        return
    assert plan.held == ("x" if kernel == "instance_norm" else "xg")
    _check_cluster_plan(plan, h, w, c, itemsize)


# (h, w, c, itemsize, held) -> (channels, cluster, bytes per block): the cuts
# the plan makes at the sites of the serving and training paths
PLANNED = [
    ((176, 320, 64, 2, "x"), (32, 16, 225_280)),    # serving layer1, bf16
    ((88, 160, 128, 2, "x"), (32, 16, 56_320)),     # serving layer2
    ((44, 80, 256, 2, "x"), (32, 8, 28_160)),       # serving layer3
    ((22, 40, 512, 2, "x"), (32, 2, 28_160)),       # serving layer4
    ((160, 240, 64, 4, "x"), (16, 16, 153_600)),    # training layer1, f32
    ((80, 120, 128, 4, "x"), (16, 16, 38_400)),     # training layer2
    ((11, 512, 128, 2, "x"), (32, 8, 45_056)),      # recognition head, width 512
    ((80, 120, 128, 4, "xg"), (16, 16, 76_800)),    # training layer2, backward
    ((40, 60, 256, 4, "xg"), (16, 8, 38_400)),      # training layer3, backward
]


@pytest.mark.parametrize("shape,want", PLANNED)
def test_planned_cuts(shape, want):
    h, w, c, itemsize, held = shape
    plan = tin.in_plan(h, w, c, itemsize, held=held)
    assert (plan.channels, plan.cluster, plan.block_bytes) == want
    _check_cluster_plan(plan, h, w, c, itemsize)


# cuts with one 32-byte sector per cluster, forced: (shape, channels, cluster)
# -> bytes per block; a card run times them beside the plan's own
FORCED = [
    ((176, 320, 64, 2, "x"), 16, 8, 225_280),
    ((88, 160, 128, 2, "x"), 16, 2, 225_280),
    ((88, 160, 128, 2, "x"), 16, 4, 112_640),
    ((44, 80, 256, 2, "x"), 16, 1, 112_640),
    ((22, 40, 512, 2, "x"), 16, 1, 28_160),
    ((160, 240, 64, 4, "x"), 8, 8, 153_600),
    ((11, 512, 128, 2, "x"), 16, 1, 180_224),
    ((160, 240, 64, 4, "xg"), 8, 16, 153_600),
]


@pytest.mark.parametrize("shape,channels,cluster,block_bytes", FORCED)
def test_forced_cuts(shape, channels, cluster, block_bytes):
    h, w, c, itemsize, held = shape
    plan = tin.in_plan(h, w, c, itemsize, held=held, cluster=cluster, channels=channels)
    assert (plan.route, plan.channels, plan.cluster) == ("cluster", channels, cluster)
    assert plan.block_bytes == block_bytes
    _check_cluster_plan(plan, h, w, c, itemsize)


@pytest.mark.parametrize("kwargs", [
    dict(h=640, w=960, c=16, itemsize=4, halves=2, held="xg"),   # stem CReLU backward
    dict(h=320, w=480, c=32, itemsize=4, halves=2, held="xg"),   # second CReLU backward
    dict(h=160, w=240, c=64, itemsize=4, held="xg"),             # layer1 backward: too large
    dict(h=704, w=1280, c=16, itemsize=2),                       # plane no cluster holds
    dict(h=7, w=13, c=20, itemsize=4),                           # not whole sectors
    dict(h=7, w=13, c=20, itemsize=2),
    dict(h=5, w=9, c=6, itemsize=4),
    dict(h=44, w=80, c=256, itemsize=2, aligned=False),          # unaligned pointers
    dict(h=0, w=8, c=64, itemsize=4),                            # empty plane
])
def test_shapes_that_take_two_passes(kwargs):
    assert tin.in_plan(**kwargs) == tin.TWO_PASS
    assert tin.TWO_PASS.route == "two_pass" and tin.TWO_PASS.cluster == 0


@pytest.mark.parametrize("kwargs", [
    dict(h=8, w=8, c=20, itemsize=4, cluster=2),                 # no whole sectors
    dict(h=8, w=8, c=64, itemsize=4, halves=2, cluster=1),       # CReLU mode
    dict(h=8, w=8, c=64, itemsize=4, channels=12),               # not a multiple of the group
    dict(h=8, w=8, c=64, itemsize=4, channels=24),               # 6 vectors: no power of two
    dict(h=8, w=8, c=48, itemsize=4, channels=32),               # does not divide c
    dict(h=176, w=320, c=64, itemsize=2, cluster=4),             # four blocks cannot hold it
    dict(h=8, w=8, c=64, itemsize=4, held="g"),
])
def test_forced_cuts_that_cannot_be_made_raise(kwargs):
    with pytest.raises(ValueError):
        tin.in_plan(**kwargs)


def test_wide_runs_where_the_channels_allow():
    """64 bytes of a pixel per cluster where C is a multiple of that, one
    32-byte sector where it is not."""
    assert tin.in_plan(16, 16, 64, 2).channels == 32
    assert tin.in_plan(16, 16, 64, 4).channels == 16
    assert tin.in_plan(16, 16, 48, 2).channels == 16    # 96 bytes a pixel
    assert tin.in_plan(16, 16, 24, 4).channels == 8


@settings(max_examples=300, deadline=None, database=None)
@given(h=st.integers(1, 720), w=st.integers(1, 1280),
       c=st.sampled_from([8, 16, 24, 32, 48, 64, 96, 128, 256, 512, 20, 6, 3]),
       itemsize=st.sampled_from([2, 4]), held=st.sampled_from(["x", "xg"]))
def test_plan_invariants_over_random_shapes(h, w, c, itemsize, held):
    if held == "xg" and itemsize != 4:
        itemsize = 4
    plan = tin.in_plan(h, w, c, itemsize, held=held)
    group = tin.GROUP_BYTES // itemsize
    if c % group != 0:
        assert plan == tin.TWO_PASS
        return
    if plan.route == "two_pass":
        # then not even the largest cluster holds one group's plane
        run = tin.RUN_BYTES // itemsize
        channels = run if c % run == 0 else group
        chunk = -(-h * w // tin.CLUSTER_SIZES[-1])
        assert chunk * channels * itemsize * len(held) > tin.SMEM_LIMIT - 64 * 1024
        return
    assert plan.held == held
    _check_cluster_plan(plan, h, w, c, itemsize)
    # the plan is a function of the shape alone
    assert tin.in_plan(h, w, c, itemsize, held=held) == plan


def _rel(a, b):
    return float(((a - b).abs() / (1 + b.abs())).max())


@pytest.mark.parametrize("shape,cluster", [
    ((2, 23, 39, 32), 1), ((2, 23, 39, 32), 2), ((2, 23, 39, 32), 4),
    ((2, 23, 39, 32), 8), ((2, 23, 39, 32), 16), ((1, 44, 80, 64), 8),
    ((3, 11, 64, 16), 2), ((3, 1, 32, 32), 1), ((2, 5, 3, 16), 16),
])
@pytest.mark.parametrize("masked", [False, True])
def test_cluster_fold_emulation_matches_the_plain_statistics(shape, cluster, masked):
    """Each rank sums its share in f32 and the shares are folded in rank
    order: within 1e-5 (relative to 1 + |ref|) of the plain statistics."""
    rng = np.random.default_rng(cluster + 17 * shape[1])
    b, h, w, c = shape
    x = torch.from_numpy((rng.standard_normal(shape) * 3 + 1.5).astype(np.float32))
    valid_w = (torch.from_numpy(rng.integers(1, w + 1, size=b).astype(np.int32))
               if masked else None)
    plan = tin.in_plan(h, w, c, 4, cluster=cluster)
    assert plan.cluster == cluster and len(plan.shares(h * w)) == cluster
    got = tin.cluster_fold_stats_ref(x, plan, 1e-5, valid_w)
    want = tin.instance_norm_stats_ref(x, 1e-5, valid_w)
    assert got.shape == (b, 2, c) and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5
    # a ragged remainder leaves later ranks short or empty, never double
    assert sum(p1 - p0 for p0, p1 in plan.shares(h * w)) == h * w


def test_cluster_fold_emulation_in_bf16_and_its_order():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 20, 24, 32)).astype(np.float32) * 3 + 1.5)
    xb = x.to(torch.bfloat16)
    plan = tin.in_plan(20, 24, 32, 2, cluster=4)
    assert _rel(tin.cluster_fold_stats_ref(xb, plan), tin.instance_norm_stats_ref(xb)) <= 1e-5
    # one rank holding everything is the plain sum itself
    one = tin.in_plan(20, 24, 32, 4, cluster=1)
    torch.testing.assert_close(tin.cluster_fold_stats_ref(x, one),
                               tin.instance_norm_stats_ref(x), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("route", ["cluster", "two_pass"])
def test_launchers_refuse_cpu_tensors_on_either_route(route):
    x = torch.zeros((1, 8, 8, 64))
    plan = tin.TWO_PASS if route == "two_pass" else tin.in_plan(8, 8, 64, 4)
    bwd_plan = tin.TWO_PASS if route == "two_pass" else tin.in_bwd_plan(8, 8, 64)
    assert plan.route == bwd_plan.route == route
    before = (dict(build.launch_counts), dict(build.route_counts))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tin.instance_norm_cuda(x, torch.ones(64), torch.zeros(64), plan=plan)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tin.instance_norm_bwd_cuda(x, x, torch.zeros((1, 2, 64)), torch.ones(64),
                                   torch.zeros(64), plan=bwd_plan)
    assert (dict(build.launch_counts), dict(build.route_counts)) == before


def test_route_counts_are_kept_per_kernel_and_reset():
    assert set(build.route_counts) == {
        "instance_norm/cluster", "instance_norm/two_pass",
        "instance_norm_bwd/cluster", "instance_norm_bwd/two_pass"}
    build.route_counts["instance_norm/cluster"] += 3
    build.launch_counts["instance_norm"] += 3
    build.reset_launch_counts()
    assert not any(build.route_counts.values()) and not any(build.launch_counts.values())


def test_cpu_tensors_take_the_plain_versions_whatever_the_plan():
    """The public op on a CPU tensor never reaches a launcher: same result
    as the plain version at a shape whose plan is the cluster route."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 8, 12, 64)).astype(np.float32))
    scale = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    assert tin.in_plan(8, 12, 64, 4).route == "cluster"
    y = tin.instance_norm(x, scale, bias, 1e-5, 0.01)
    torch.testing.assert_close(y, tin.instance_norm_ref(x, scale, bias, 1e-5, 0.01))
    assert not any(build.route_counts.values())
