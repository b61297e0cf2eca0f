"""The port's mesh (``fots_torch.parallel``) against ``fots.parallel`` and
against one process on the global batch, on the CPU over gloo.

- Helpers, no spawn: ``param_shardings`` makes ``fots``'s sharded /
  replicated decision for every parameter of the 87- and the 750-class
  detector at ``n_model`` 1 and 2; the batch padding and the roi chunk
  equal ``fots``'s at ``n_data`` 1, 2, 4, 8; ``shard_rois`` and
  ``global_draw`` keep a rank's rows of the global ones.
- World 2 (data 2): the losses' reductions (dice and OHEM), BatchNorm and
  CTC through a small network without kinks; then with the shipped
  snapshot on four asset scenes shrunk to 160x224 with two words each
  (8 roi slots, lr 1e-5): two steps (the second samples predicted rois
  from the all-gathered candidates), an OHEM step, and a step whose rois
  lie on the first rank's images only (the second runs a masked dummy);
  the first step also against one process whose BatchNorms add as the two
  ranks do; ``batch_call`` of 3 images (padded to 4) at 256x384;
  ``cli.serve`` over a folder with a file that reads as nothing, each rank
  decoding its own rows only.  A third spawn of 2 ranks injects a failure
  into rank 1's second step of ``Trainer.train``: the run ends.
- World 4 (data 2 x model 2), 750 classes (the snapshot's weights, a fresh
  ``conv11`` from seed 0): the reductions with the ``embedding`` split over
  'model'; two steps of the same scenes, ``conv11``'s rows on each model
  rank; a checkpoint each way between world 4 and one process, bit for
  bit; ``batch_call`` of 3 images (padded to 4) at 256x384.
- Entry points: ``train_joint -n_data 2`` without a process group is a usage
  error; ``export_serving`` refuses a meshed engine; under a 1-rank group
  ``cli.serve`` and ``train_joint`` write what they write without one.

Each world size is one spawn (``fots_torch.parallel.selfcheck``), and the
injected failure one more, over a
``FileStore`` in a temporary directory, every case of it inside; the
single-process references run in this process meanwhile.  Tolerances: the
network without kinks within 1e-5 of each tensor's largest magnitude
(``selfcheck.SMOOTH_REL``; f32 sums in another order), every rank's loss
terms too.  The detector within ``selfcheck.CPU_LIMITS``: the five loss
terms within 1e-5 of their value (+1e-6); each gradient tensor within 3e-2
of its largest magnitude and the median tensor within 1e-3, because
BatchNorm's statistics from all-reduced sums differ from one process's in
the last bits and a leaky ReLU whose input lies that close to 0 flips its
slope, moving the gradients of everything before it (measured: 9.3e-3 at
layer3.2, 1e-6 from layer3.3 on; one process against itself at another
thread count reads 2e-5; one process whose BatchNorms add as the ranks
do is within ``selfcheck.ORDER_LIMITS`` of the mesh, 1e-4 of each
tensor's largest gradient and the median 1e-5, and as far as the mesh from
one process that does not); parameters after the Adam steps within 0.1 lr
where each step's gradient exceeds ten times its tensor's largest
difference (2 lr a step anywhere); BatchNorm statistics within 1e-5 of
(1 + |value|); candidate values within 1e-4 (+1e-4 relative) for f32
packs, and the u16 pack and the boxes within ``test_parallel``'s 5e-2 px
(+2e-3 of the value); texts equal.
"""

import json
import os
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from fots.models import FOTSDetector as JaxDetector
from fots.models.detector import init_detector as jax_init_detector
from fots.parallel import make_mesh as jax_make_mesh
from fots.parallel import param_shardings as jax_param_shardings
from fots.pipeline import FOTSInference as JaxInference
from fots_torch import checkpoint as tck
from fots_torch.models.detector import FOTSDetector
from fots_torch.parallel import mesh as pmesh
from fots_torch.parallel import selfcheck as sc
from fots_torch.pipeline import FOTSInference
from fots_torch.roirotate import DUMMY_ROI, RoiBatch, shard_rois

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")
SMOKE_IMAGES = os.path.join(REPO, "fots_torch", "assets", "smoke_images_u8.npz")
TARGETS = os.path.join(REPO, "fots_torch", "assets", "train_targets.npz")
LR = 1e-5
MAX_ROIS = 8  # roi slots of the small checks (selfcheck.roi_slots)


# --------------------------------------------------------------------------
# helpers against fots
# --------------------------------------------------------------------------

def _fots_decisions(nclass, n_model):
    """{port name: sharded?} from fots's param_shardings of its detector."""
    tree = jax.eval_shape(lambda: jax_init_detector(JaxDetector(nclass=nclass),
                                                    jax.random.PRNGKey(0)))
    mesh = jax_make_mesh(n_data=8 // n_model, n_model=n_model)
    sh = jax_param_shardings(tree["params"], mesh)
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(sh)[0]:
        key = "params/" + "/".join(str(getattr(k, "key", k)) for k in path)
        out[tck.torch_key(key)] = s.spec != jax.sharding.PartitionSpec()
    return out


def _port_decisions(placements):
    from torch.distributed.tensor import Shard

    return {k: v[1] == Shard(0) for k, v in placements.items()}


@pytest.mark.parametrize("nclass", [87, 750])
@pytest.mark.parametrize("n_model", [1, 2])
def test_param_shardings_decide_as_fots(nclass, n_model):
    stand_in = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                     size=lambda i: (1, n_model)[i])
    got = _port_decisions(pmesh.param_shardings(FOTSDetector(nclass=nclass), stand_in))
    want = _fots_decisions(nclass, n_model)
    assert got == want
    assert sum(got.values()) == (2 if nclass == 750 and n_model == 2 else 0)


@pytest.mark.parametrize("n_data", [1, 2, 4, 8])
def test_padding_and_roi_chunk_equal_fots(n_data):
    jax_eng = types.SimpleNamespace(_data_parallel=n_data,
                                    CHUNK_FRAME_BUDGET=JaxInference.CHUNK_FRAME_BUDGET)
    jax_eng._pad_to_shards = lambda n: JaxInference._pad_to_shards(jax_eng, n)
    port_eng = types.SimpleNamespace(shard=pmesh.BatchShard(n_data, n_data - 1))
    for n in range(1, 20):
        assert (FOTSInference._pad_to_shards(port_eng, n)
                == JaxInference._pad_to_shards(jax_eng, n))
    for width in (8, 16, 24, 32, 48, 64, 96, 128, 256, 512, 1024):
        assert (FOTSInference._roi_chunk(width, n_data)
                == JaxInference._roi_chunk(jax_eng, width))


def test_batch_shard_rows_cover_the_padded_batch():
    for n in (1, 2, 4, 8):
        for b in (1, 3, 4, 7, 16):
            rows = [pmesh.BatchShard(n, i).rows(b) for i in range(n)]
            assert sum(r.stop - r.start for r in rows) == pmesh.BatchShard(n, 0).padded(b)
            assert [r.start for r in rows] == [i * rows[0].stop for i in range(n)]


def test_shard_rois_keep_each_rank_s_rois_and_a_dummy_for_none():
    rois = np.tile(np.asarray(DUMMY_ROI, np.float32), (8, 1))
    rois[:3, 0] = [0, 1, 1]
    rois[:3, 1] = [10, 20, 30]
    mask = np.zeros(8, np.float32)
    mask[:3] = 1
    labels = np.arange(8 * 4).reshape(8, 4).astype(np.int32)
    batch = RoiBatch(rois, labels, np.full(8, 2, np.int32), mask, 256, 0, 3)
    first, idx0 = shard_rois(batch, slice(0, 2))
    assert list(idx0) == [0, 1, 2] and list(first.rois[:, 0]) == [0, 1, 1]
    assert np.array_equal(first.labels, labels[:3]) and first.strip_width == 256
    second, idx1 = shard_rois(batch, slice(2, 4))
    assert list(idx1) == [3] and second.roi_mask.tolist() == [0.0]
    assert second.label_lengths.tolist() == [0]


def test_global_draw_keeps_the_rows_of_one_draw():
    want = torch.rand((6, 5), generator=torch.Generator().manual_seed(3))
    for rows in (slice(0, 3), slice(3, 6), [1, 4]):
        got = pmesh.global_draw((len(range(6)[rows]) if isinstance(rows, slice)
                                 else len(rows), 5),
                                pmesh.RowDraw(torch.Generator().manual_seed(3), 6, rows))
        assert torch.equal(got, want[rows])


# --------------------------------------------------------------------------
# world 2 and world 4: one spawn each, the references meanwhile
# --------------------------------------------------------------------------

def _keep_words(batch, counts):
    """``batch`` with only the first ``counts[i]`` words of image i."""
    from dataclasses import replace

    return replace(batch, gt_quads=[q[:c] for q, c in zip(batch.gt_quads, counts)],
                   labels=[lb[:c] for lb, c in zip(batch.labels, counts)])


def _serve_argv(tmp, out):
    """``cli.serve`` over three synth scenes and a file that reads as
    nothing, in chunks of 3, writing to ``tmp / out``."""
    folder = tmp / "scenes"
    if not folder.exists():
        folder.mkdir()
        for i in range(3):
            name = f"img_00{i}.jpg"
            (folder / name).write_bytes(open(os.path.join(REPO, "data", "synth", name),
                                             "rb").read())
        (folder / "img_001b.jpg").write_bytes(b"not an image" * 8)
    return ["-model", SNAPSHOT, "-test_folder", str(folder), "-batch", "3", "-height", "128",
            "-width", "192", "-f32", "-device", "cpu", "-output", str(tmp / out)]


def _cases(tmp):
    with np.load(SMOKE_IMAGES) as z:
        images = z["images"]
    with np.load(TARGETS) as z:
        targets = {k: z[k] for k in z.files}
    scenes = sc.scene_batch(images, targets, [0, 1, 2, 3], scale=4, width=224)
    two = _keep_words(scenes, [2, 2, 2, 2])
    base = dict(snapshot=SNAPSHOT, device="cpu", lr=LR, max_rois=MAX_ROIS)
    small = [images[i][::4, ::4].copy() for i in range(3)]
    world2 = [("smooth", dict(data=sc.smooth_data(nclass=87), nclass=87)),
              ("smooth", dict(data=sc.smooth_data(nclass=87), nclass=87, ohem=True)),
              ("train", dict(base, batches=[two, two])),
              ("train", dict(base, batches=[two], ohem=True)),
              ("train", dict(base, batches=[_keep_words(scenes, [2, 1, 0, 0])])),
              ("serve", dict(snapshot=SNAPSHOT, device="cpu", masked_norm=True,
                             images=small, serve_hw=(256, 384))),
              ("serve_cli", dict(argv=_serve_argv(tmp, "serve_mesh2")))]
    # 750 classes: the snapshot's weights but a fresh vocabulary head
    wide = dict(base, nclass=750, seed=0)
    one_ckpt = str(tmp / "one")
    world4 = [("smooth", dict(data=sc.smooth_data(nclass=750), nclass=750)),
              ("train", dict(wide, batches=[two, two])),
              ("save", dict(dir=str(tmp / "mesh4"))),
              ("restore", dict(wide, path=os.path.join(one_ckpt, "step_1"))),
              ("serve", dict(wide, masked_norm=True, images=small, serve_hw=(256, 384)))]
    return world2, world4, one_ckpt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    world2, world4, one_ckpt = _cases(tmp)
    train4 = world4[1][1]
    # the one-process checkpoint world 4 restores: one step of its case
    single_ckpt = sc.single([("train", dict(train4, batches=train4["batches"][:1])),
                             ("save", dict(dir=one_ckpt))])[1]
    two = world2[2][1]
    fail = dict(two, batches=two["batches"][:1] * 2, rank=1, step=1)
    ctx_fail = sc.start([("fail", fail)], str(tmp / "fail"), n_data=2)
    ctx2 = sc.start(world2, str(tmp / "w2"), n_data=2)
    ctx4 = sc.start(world4, str(tmp / "w4"), n_data=2, n_model=2)
    torch.set_num_threads(2)
    ref2 = sc.single(world2[:-1] + [("serve_cli", dict(argv=_serve_argv(tmp, "serve_one")))])
    ref4 = dict(zip((0, 1, 4), sc.single([world4[0], world4[1], world4[4]])))
    # one process whose BatchNorms add as two data ranks do: the first step
    order = sc.single([("train", dict(two, batches=two["batches"][:1], sum_shards=2))])[0]
    try:
        sc.finish(ctx_fail, str(tmp / "fail"), timeout=300)
        failed = None
    except TimeoutError:
        raise
    except Exception as e:  # what the spawn raised, and the rank's own traceback
        failed = (e, (tmp / "fail" / sc.ERROR_FILE.format(1)).read_text())
    got2 = sc.finish(ctx2, str(tmp / "w2"))
    got4 = sc.finish(ctx4, str(tmp / "w4"))
    return {"got2": got2, "ref2": ref2, "got4": got4, "ref4": ref4, "order": order,
            "single_ckpt": single_ckpt, "failed": failed, "tmp": tmp}


@pytest.mark.parametrize("case", [0, 1], ids=["dice", "ohem"])
def test_world2_reductions_equal_one_process_without_kinks(runs, case):
    assert sc.compare_smooth(runs["got2"][case], runs["ref2"][case]) == []
    assert len(runs["got2"][case]["losses"]) == 2


def test_world4_reductions_and_sharded_embedding_equal_one_process(runs):
    got = runs["got4"][0]
    assert sc.compare_smooth(got, runs["ref4"][0]) == []
    assert got["grads"]["embedding.weight"].shape == (750, 16)


@pytest.mark.parametrize("case", [2, 3, 4], ids=["dice_two_steps", "ohem", "odd_rois"])
def test_world2_training_equals_one_process(runs, case):
    got, want = runs["got2"][case], runs["ref2"][case]
    res = sc.compare_train(got, want, sc.CPU_LIMITS, LR)
    assert res["failures"] == [], res
    for step in got["steps"]:
        # every rank recognises the valid rois of its own images, and no other
        rows = step["rois"][step["roi_mask"] > 0, 0]
        assert step["local_rois"] == [int((rows < 2).sum()), int((rows >= 2).sum())]
    if case == 4:  # rois on the first rank's images only: the second runs a dummy
        assert got["steps"][0]["local_rois"][1] == 0 < got["steps"][0]["local_rois"][0]
    assert len(got["steps"]) == (2 if case == 2 else 1)


def test_world2_step_equals_one_process_adding_as_the_ranks_do(runs):
    """The second witness of ``CPU_LIMITS``: with BatchNorm's sums added in
    the ranks' order, one process is within f32 noise of the mesh (the
    first step: after it the parameters differ by that noise)."""
    res = sc.compare_train(runs["got2"][2], runs["order"], sc.ORDER_LIMITS, LR, steps=1)
    assert res["failures"] == [], res
    assert sc.compare_train(runs["order"], runs["ref2"][2], sc.CPU_LIMITS, LR,
                            steps=1)["grad"] > sc.ORDER_LIMITS.grad_rel


def test_a_step_failing_on_one_rank_ends_the_meshed_run(runs):
    assert runs["failed"] is not None, "the run went on past the failed step"
    assert sc.INJECTED in runs["failed"][1]


def test_world2_cli_serve_decodes_its_rows_and_writes_what_one_card_writes(runs):
    got, want = runs["got2"][6], runs["ref2"][6]
    assert got["n"] == want["n"] == 3
    assert want["read"] == [["img_000.jpg", "img_001.jpg", "img_001b.jpg", "img_002.jpg"]]
    # rows 0-1 of the chunk (3 padded to 4) and of the last one (1 padded to 2)
    assert got["read"] == [["img_000.jpg", "img_001.jpg", "img_002.jpg"], ["img_001b.jpg"]]
    mesh_dir, one_dir = runs["tmp"] / "serve_mesh2", runs["tmp"] / "serve_one"
    assert sorted(os.listdir(mesh_dir)) == sorted(os.listdir(one_dir)) == [
        f"img_00{i}.json" for i in range(3)]
    for name in os.listdir(one_dir):
        g, w = (json.loads((d / name).read_text()) for d in (mesh_dir, one_dir))
        assert [e["text"] for e in g] == [e["text"] for e in w], name
        for e, f in zip(g, w):
            assert np.allclose(e["box"], f["box"], rtol=2e-3, atol=5e-2), name


def test_world2_serving_equals_unmeshed_on_every_rank(runs):
    got, want = runs["got2"][5], runs["ref2"][5]
    res = sc.compare_serve(got, want, sc.CPU_LIMITS)
    assert res["failures"] == [], res
    assert len(got["results"]) == 2 and all(len(r) == 3 for r in got["results"])
    assert sum(len(r) for r in want["results"][0]) > 0


def test_world4_training_with_the_vocab_over_model_equals_one_process(runs):
    got, want = runs["got4"][1], runs["ref4"][1]
    res = sc.compare_train(got, want, sc.CPU_LIMITS, LR)
    assert res["failures"] == [], res
    assert sc.conv11_rows_hold(got, want) is None
    shards = {(d, m): w.shape for d, m, w in got["conv11_rows"]}
    assert shards == {(d, m): (375, 256, 1, 1) for d in (0, 1) for m in (0, 1)}


def test_world4_serving_equals_unmeshed_on_every_rank(runs):
    got, want = runs["got4"][4], runs["ref4"][4]
    res = sc.compare_serve(got, want, sc.CPU_LIMITS)
    assert res["failures"] == [], res
    assert len(got["results"]) == 4 and all(len(r) == 3 for r in got["results"])
    assert sum(len(r) for r in want["results"][0]) > 0


def test_checkpoint_from_world4_restores_into_one_process(runs):
    from fots_torch.train import Trainer

    path = runs["got4"][2]
    trainer = Trainer(sc.model_from_spec(dict(nclass=750, seed=0), "cpu"),
                      codec=sc.codec_from_spec(dict(nclass=750)), device="cpu")
    step = tck.restore_checkpoint(path, trainer)
    got = tck.checkpoint_payload(trainer.model, trainer.optimizer, step)
    want = runs["got4"][1]["payload"]  # what the meshed trainer held, gathered
    assert step == 2 and sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_checkpoint_from_one_process_restores_into_world4(runs):
    rec = runs["got4"][3]
    assert rec["step"] == 1 and rec["bit_equal"] == [True] * 4


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def test_train_joint_n_data_without_a_process_group_is_a_usage_error(capsys):
    from fots_torch.cli import train_joint

    assert not dist.is_initialized()
    with pytest.raises(SystemExit) as e:
        train_joint.build(["-n_data", "2", "-batch_size", "2", "-device", "cpu"])
    assert e.value.code == 2 and "torchrun" in capsys.readouterr().err


@pytest.fixture
def one_rank_group(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_export_serving_refuses_a_meshed_engine(one_rank_group, tmp_path):
    from fots_torch.export import export_serving

    model = sc.model_from_spec(dict(nclass=87, seed=0), "cpu")
    with FOTSInference(model, device="cpu", mesh=pmesh.make_mesh(1, 1)) as eng:
        assert eng.mesh is not None and eng._data_parallel == 1
        with pytest.raises(ValueError, match="single-device"):
            export_serving(eng, str(tmp_path / "b"), 1, 64, 64, platforms=("cpu",))
        with pytest.raises(ValueError):
            eng.copy_to("cpu")


def test_one_rank_group_runs_serve_and_train_joint_as_without(tmp_path):
    from fots_torch.cli import serve, train_joint

    smoke = [os.path.join(REPO, "data", "synth", f"img_00{i}.jpg") for i in range(2)]
    (tmp_path / "l.txt").write_text("".join(p + "\n" for p in smoke))
    train_args = ["-train_list", str(tmp_path / "l.txt"), "-images_npz", SMOKE_IMAGES,
                  "-batch_size", "2", "-input_size", "64", "-num_readers", "1",
                  "-max_iters", "1", "-checkpoint_every", "10", "-device", "cpu"]
    serve_args = ["-model", SNAPSHOT, "-images_npz", SMOKE_IMAGES, "-batch", "2",
                  "-height", "128", "-width", "192", "-f32", "-device", "cpu"]
    outs = {}
    for grouped in (False, True):
        tag = "group" if grouped else "plain"
        if grouped:
            dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                                    rank=0, world_size=1)
        try:
            trainer = train_joint.main(train_args + ["-save_path", str(tmp_path / tag)])
            assert trainer.mesh is None
            n = serve.main(serve_args + ["-output", str(tmp_path / f"serve_{tag}")])
        finally:
            if grouped:
                dist.destroy_process_group()
        files = sorted(os.listdir(tmp_path / f"serve_{tag}"))
        outs[tag] = (trainer.history, n, files,
                     [(tmp_path / f"serve_{tag}" / f).read_text() for f in files],
                     tck.read_checkpoint(str(tmp_path / tag)))
    (h0, n0, f0, t0, c0), (h1, n1, f1, t1, c1) = outs["plain"], outs["group"]
    assert h0 == h1 and n0 == n1 == 4 and f0 == f1 and t0 == t1
    assert sorted(c0) == sorted(c1) and all(np.array_equal(c0[k], c1[k]) for k in c0)
