"""The port's training data path against the JAX package on CPU: the ScanNet
training dataset and the threaded loader, the training tool's epoch order
and --datapath branch, the ImageNet encoder import, and ResNet-101/152.

The scenes are written here in ScanNet's training layout as
tests/test_data.py writes them: random JPEG colour through cv2, 16-bit PNG
depth, pose text. The torchvision-layout state dicts are built from
torchvision's documented naming and drawn with numpy from a seed; nothing
is downloaded.
"""

from __future__ import annotations

import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estdepth_tpu.data import scannet as jax_scannet
from estdepth_tpu.data.pipeline import TrainLoader as JaxTrainLoader
from estdepth_tpu.models.resnet import ResNetEncoder as JaxResNet
from estdepth_tpu.utils.convert import (
    convert_torchvision_resnet as jax_convert_torchvision, flatten_tree,
)
from estdepth_tpu_torch.data import io_utils, scannet
from estdepth_tpu_torch.data.pipeline import TrainLoader, prefetch_to_device
from estdepth_tpu_torch.models.resnet import ResNetEncoder
from estdepth_tpu_torch.tools import import_torchvision
from estdepth_tpu_torch.tools import train as train_tool
from estdepth_tpu_torch.utils.checkpoint import CheckpointManager
from estdepth_tpu_torch.utils.convert import (
    load_pretrained_encoder, state_dict_from_jax,
)
from test_torch_port_common import (  # noqa: F401
    H, ND, W, one_torch_thread, random_variables, scene_arrays,
    training_test_env,
)

cv2 = pytest.importorskip("cv2")

pytestmark = pytest.mark.usefixtures("training_test_env")
KEYS = ("imgs", "cam_poses", "cam_intr", "dmaps", "dmasks")
SEED = 3


def write_fake_scannet(root, scenes=("scene0000_00", "scene0001_00"),
                       n_raw=140, seed=0):
    """Scenes in ScanNet's layout as tests/test_data.py writes them: raw
    ids every 2 of n_raw, random 48x64 colour (JPEG) and depth in
    0.8-4 m (16-bit PNG), and poses that move and pitch a little."""
    rng = np.random.default_rng(seed)
    for scene in scenes:
        sp = os.path.join(root, scene)
        for sub in ("rgb", "depth", "pose"):
            os.makedirs(os.path.join(sp, sub))
        for i in range(0, n_raw, 2):
            img = rng.integers(0, 255, size=(48, 64, 3), dtype=np.uint8)
            cv2.imwrite(os.path.join(sp, "rgb", f"{i}.jpg"), img)
            depth_mm = rng.integers(800, 4000, size=(48, 64)).astype(
                np.uint16)
            cv2.imwrite(os.path.join(sp, "depth", f"{i}.png"), depth_mm)
            pose = np.eye(4)
            a = 0.002 * i
            pose[1:3, 1:3] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
            pose[:3, 3] = [0.01 * i, 0.003 * i, 0.0]
            np.savetxt(os.path.join(sp, "pose", f"{i}.txt"), pose)
    return str(root)


@pytest.fixture(scope="module")
def fake_scannet(tmp_path_factory):
    return write_fake_scannet(tmp_path_factory.mktemp("scannet"))


@pytest.fixture(scope="module")
def corrupt_scannet(tmp_path_factory, fake_scannet):
    """The same scenes with one JPEG cut inside its header: neither cv2 nor
    libjpeg decodes it, so the windows that hold it are replaced."""
    root = str(tmp_path_factory.mktemp("scannet_corrupt"))
    for scene in os.listdir(fake_scannet):
        shutil.copytree(os.path.join(fake_scannet, scene),
                        os.path.join(root, scene),
                        ignore=shutil.ignore_patterns("scene_index.json"))
    path = os.path.join(root, "scene0000_00", "rgb", "12.jpg")
    with open(path, "rb") as f:
        head = f.read(300)
    with open(path, "wb") as f:
        f.write(head)
    return root


def _datasets(root, **kw):
    kw = dict(height=32, width=40, n_frames=5, frame_interval=2,
              backend="cv2", seed=SEED, **kw)
    return (scannet.ScanNetTrainDataset(root, **kw),
            jax_scannet.ScanNetTrainDataset(root, **kw))


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w) == set(KEYS)
        for k in KEYS:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("case", ["plain", "augment", "corrupt", "shards"])
def test_batches_equal_jax_bit_for_bit(case, fake_scannet, corrupt_scannet):
    """Every batch of epochs 0 and 1 of the port's dataset + TrainLoader
    equals the JAX package's, bit for bit: as shipped, with the photometric
    augmentation on every window, with a corrupt JPEG (the same substitute
    on both sides), and over 2 shards."""
    root = corrupt_scannet if case == "corrupt" else fake_scannet
    ds, jds = _datasets(root, augment_prob=1.0 if case == "augment" else 0.0)
    assert len(ds) == len(jds) == 26
    shards = 2 if case == "shards" else 1
    for shard in range(shards):
        kw = dict(batch_size=2, shard_index=shard, num_shards=shards,
                  num_workers=2, seed=SEED)
        loader, jloader = TrainLoader(ds, **kw), JaxTrainLoader(jds, **kw)
        assert loader.steps_per_epoch() == jloader.steps_per_epoch()
        for epoch in (0, 1):
            got = list(loader.epoch(epoch))
            assert len(got) == loader.steps_per_epoch()
            _assert_batches_equal(got, list(jloader.epoch(epoch)))
    if case == "corrupt":  # the substitute differs from the window itself
        bad = next(i for i, w in enumerate(ds.index)
                   if any(p.endswith("/12.jpg") for p in w["images"]))
        with pytest.raises(IOError):
            ds._read(bad, np.random.default_rng(0))
        ds.set_epoch(0)
        assert ds[bad]["imgs"].shape == (5, 32, 40, 3)


def test_scene_index_cache_is_shared(tmp_path):
    """scene_index.json written by either package is read by the other:
    the same bytes, and read rather than rebuilt (the pose files are gone
    when the other side reads it)."""
    for writer, reader in ((scannet, jax_scannet), (jax_scannet, scannet)):
        root = write_fake_scannet(tmp_path / writer.__name__.split(".")[0],
                                  scenes=("scene0000_00",), n_raw=60)
        scene = os.path.join(root, "scene0000_00")
        info = writer._load_scan(scene, interval=2)
        assert len(info["images"]) == 15
        with open(os.path.join(scene, "scene_index.json")) as f:
            written = f.read()
        os.remove(os.path.join(scene, "scene_index.json"))
        other = reader._load_scan(scene, interval=2)
        with open(os.path.join(scene, "scene_index.json")) as f:
            assert f.read() == written
        shutil.rmtree(os.path.join(scene, "pose"))
        assert reader._load_scan(scene, interval=2) == info == other
        writer_ds = writer.ScanNetTrainDataset(root, height=32, width=40,
                                               frame_interval=2,
                                               backend="cv2")
        assert len(writer_ds) == len(range(5, 10, 2))


def test_scene_cut_at_first_nonfinite_pose(tmp_path):
    root = write_fake_scannet(tmp_path, scenes=("scene0000_00",), n_raw=40)
    np.savetxt(os.path.join(root, "scene0000_00", "pose", "16.txt"),
               np.full((4, 4), np.inf))
    for module in (scannet, jax_scannet):
        info = module._load_scan(os.path.join(root, "scene0000_00"),
                                 interval=2, use_cache=False)
        assert [os.path.basename(p) for p in info["poses"]] == [
            f"{i}.txt" for i in range(0, 16, 4)]


def test_without_opencv_the_reader_names_the_file(fake_scannet,
                                                  monkeypatch):
    monkeypatch.setattr(io_utils, "HAVE_CV2", False)
    with pytest.raises(IOError, match=r"rgb/0\.jpg.*OpenCV"):
        scannet.ScanNetTrainDataset(fake_scannet, frame_interval=2,
                                    backend="cv2")
    with pytest.raises(ValueError, match="backend"):
        scannet.ScanNetTrainDataset(fake_scannet, backend="pil")


class _Indices:
    """A dataset whose item is its index; one item raises if asked."""

    def __init__(self, n, bad=None):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise KeyError(f"item {i}")
        return {"i": np.array(i)}


@pytest.mark.parametrize("n,batch,shards", [(10, 3, 1), (11, 2, 3)])
def test_loader_order_matches_jax(n, batch, shards):
    for shard in range(shards):
        kw = dict(batch_size=batch, shard_index=shard, num_shards=shards,
                  num_workers=3, seed=SEED)
        for epoch in (0, 1):
            got = [b["i"] for b in TrainLoader(_Indices(n), **kw)
                   .epoch(epoch)]
            want = [b["i"] for b in JaxTrainLoader(_Indices(n), **kw)
                    .epoch(epoch)]
            assert len(got) == len(want) > 0
            assert all(np.array_equal(g, w) for g, w in zip(got, want))
            assert np.array_equal(
                np.concatenate(got),
                TrainLoader(_Indices(n), **kw).order(epoch))


def test_loader_raises_worker_errors_and_stops():
    before = set(threading.enumerate())
    loader = TrainLoader(_Indices(40, bad=7), batch_size=2, num_workers=2,
                         seed=SEED)
    with pytest.raises(KeyError, match="item 7"):
        list(loader.epoch(0))
    it = TrainLoader(_Indices(40), 2, num_workers=2, prefetch=1).epoch(0)
    next(it)
    it.close()  # an abandoned epoch stops its producer and its pool
    started = set(threading.enumerate()) - before
    for t in started:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in started)


def test_prefetch_to_device_keeps_order():
    batches = [{"i": np.full((2, 3), i, np.float32)} for i in range(5)]
    got = list(prefetch_to_device(iter(batches), "cpu"))
    assert [int(b["i"][0, 0]) for b in got] == list(range(5))
    assert all(isinstance(b["i"], torch.Tensor) for b in got)


def test_train_tool_epoch_order_is_the_jax_tools(tmp_path):
    """The synthetic source visits its windows in the order of the JAX
    tool's TrainLoader.epoch (np.random.default_rng(seed + epoch)), epochs
    0 and 1: the first batches of each are equal bit for bit."""
    args = train_tool.parse_args([
        "--synthetic", "--height", "32", "--width", "48", "--n-frames", "3",
        "--seed", str(SEED), "--num-workers", "2", "--batch-per-device",
        "2", "--resnet", "18", "--ndepths", "4"])
    loader = train_tool.build(args, "cpu")[1]
    jloader = JaxTrainLoader(loader.dataset, 2, num_workers=2, seed=SEED)
    for epoch in (0, 1):
        got = loader.epoch(epoch)
        want = jloader.epoch(epoch)
        for _ in range(3):
            g, w = next(got), next(want)
            for k in KEYS:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        got.close()
        want.close()


# ---- the ImageNet encoder import ---------------------------------------

_STAGES = {18: ("basic", (2, 2, 2, 2)), 50: ("bottleneck", (3, 4, 6, 3)),
           152: ("bottleneck", (3, 8, 36, 3))}


def torchvision_layout(depth):
    """{name: shape} of torchvision's resnet<depth>.state_dict(), by its
    naming: conv1/bn1, layer<L>.<i>.{convK, bnK, downsample.{0,1}} with
    the stride and the x4 expansion on Bottleneck, and the fc head."""
    kind, stages = _STAGES[depth]
    expansion = 1 if kind == "basic" else 4
    shapes = {"conv1.weight": (64, 3, 7, 7)}

    def bn(name, c):
        shapes.update({f"{name}.weight": (c,), f"{name}.bias": (c,),
                       f"{name}.running_mean": (c,),
                       f"{name}.running_var": (c,),
                       f"{name}.num_batches_tracked": ()})

    bn("bn1", 64)
    inplanes = 64
    for stage, blocks in enumerate(stages):
        planes = 64 * 2 ** stage
        for i in range(blocks):
            base = f"layer{stage + 1}.{i}"
            if kind == "basic":
                convs = [(planes, inplanes, 3), (planes, planes, 3)]
            else:
                convs = [(planes, inplanes, 1), (planes, planes, 3),
                         (planes * 4, planes, 1)]
            for k, (o, c, s) in enumerate(convs, 1):
                shapes[f"{base}.conv{k}.weight"] = (o, c, s, s)
                bn(f"{base}.bn{k}", o)
            if i == 0 and (stage > 0 or inplanes != planes * expansion):
                shapes[f"{base}.downsample.0.weight"] = (
                    planes * expansion, inplanes, 1, 1)
                bn(f"{base}.downsample.1", planes * expansion)
            inplanes = planes * expansion
    shapes["fc.weight"] = (1000, inplanes)
    shapes["fc.bias"] = (1000,)
    return shapes


def seeded_torchvision(depth, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in torchvision_layout(depth).items():
        if name.endswith("num_batches_tracked"):
            out[name] = torch.tensor(7)
        elif name.endswith("running_var"):
            out[name] = torch.from_numpy(
                rng.uniform(0.5, 1.5, shape).astype(np.float32))
        else:
            out[name] = torch.from_numpy(
                rng.normal(size=shape).astype(np.float32))
    return out


@pytest.mark.parametrize("depth", [18, 50])
def test_pretrained_encoder_matches_jax_import(depth, tmp_path):
    """A torchvision state dict, read by the port from its .pth and from
    the .npz of the JAX package's flatten_tree(convert_torchvision_resnet),
    gives the tensors state_dict_from_jax gives for the JAX subtree: every
    encoder tensor. The port's import tool writes the JAX tool's names and
    arrays."""
    sd = seeded_torchvision(depth)
    jax_tree = jax_convert_torchvision({k: v.numpy() for k, v in sd.items()})
    want = state_dict_from_jax({
        "params": {"semantic_feature": jax_tree["params"]},
        "batch_stats": {"semantic_feature": jax_tree["batch_stats"]}})
    names = {f"semanticFeature.{k}" for k in ResNetEncoder(depth).state_dict()
             if not k.endswith("num_batches_tracked")}
    assert set(want) == names

    pth, npz = tmp_path / "tv.pth", tmp_path / "jax.npz"
    torch.save(sd, pth)
    np.savez(npz, **flatten_tree(jax_tree))
    from_pth = load_pretrained_encoder(str(pth))
    from_npz = load_pretrained_encoder(str(npz))
    assert set(from_npz) == names
    assert set(from_pth) == names | {
        k.replace(".running_var", ".num_batches_tracked")
        for k in names if k.endswith("running_var")}
    for k, v in want.items():
        assert torch.equal(from_npz[k], v), k
        assert torch.equal(from_pth[k], v), k

    ours = tmp_path / "port.npz"
    import_torchvision.main(["--pth", str(pth), "--out", str(ours)])
    with np.load(ours) as got, np.load(npz) as ref:
        assert set(got.files) == set(ref.files)
        for k in ref.files:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_resnet101_matches_jax():
    """The ResNet-101 encoder through the weight bridge against JAX at
    64x96 (the encoder row of PARITY.md: rtol 1e-3, atol 2e-4)."""
    imgs, _, _ = scene_arrays(2)
    x = (2.0 * (imgs / 255.0) - 1.0).astype(np.float32)
    variables = random_variables(lambda: JaxResNet(101).init(
        jax.random.key(0), jnp.asarray(x[:1])), seed=7)
    sd = state_dict_from_jax({
        "params": {"semantic_feature": variables["params"]},
        "batch_stats": {"semantic_feature": variables["batch_stats"]}})
    assert any(k.startswith("semanticFeature.encoder.layer3.22.") for k in sd)
    encoder = ResNetEncoder(101).eval()
    prefix = "semanticFeature."
    encoder.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                            strict=True)
    want = JaxResNet(101).apply(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = encoder(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-3, atol=2e-4)


def test_resnet152_has_torchvision_layout():
    layout = torchvision_layout(152)
    got = {k: tuple(v.shape)
           for k, v in ResNetEncoder(152).encoder.state_dict().items()}
    assert got == {k: v for k, v in layout.items() if not k.startswith("fc.")}
    with pytest.raises(ValueError, match="not one of"):
        ResNetEncoder(200)


# ---- the training tool's --datapath branch -----------------------------

def test_train_tool_datapath_pretrained_resume(tmp_path, capsys):
    """--datapath trains through the loader, starts the encoder from a
    torchvision .pth, dumps images, logs the loader's wait, and --resume
    continues where an uninterrupted run would be."""
    root = write_fake_scannet(tmp_path / "data", scenes=("scene0000_00",),
                              n_raw=160)
    # the tool samples every 10th of the 80 pose ids: 8 frames, 2 windows
    # of 3 (range(3, 5, 1))
    sd = seeded_torchvision(18, seed=1)
    pth = tmp_path / "resnet18.pth"
    torch.save(sd, pth)
    argv = ["--datapath", root, "--device", "cpu", "--height", str(H),
            "--width", str(W), "--ndepths", str(ND), "--resnet", "18",
            "--n-frames", "3", "--summary-freq", "1", "--seed", str(SEED),
            "--num-workers", "2", "--image-freq", "2"]

    args = train_tool.parse_args(argv + ["--pretrained-encoder", str(pth),
                                         "--logdir", str(tmp_path / "a")])
    state, loader, steps_per_epoch = train_tool.build(args, "cpu")
    assert steps_per_epoch == len(loader.dataset) == 2
    got = state.model.state_dict()
    for k, v in sd.items():
        if not k.startswith("fc."):
            assert torch.equal(got[f"semanticFeature.encoder.{k}"], v), k
    assert "pretrained encoder loaded" in capsys.readouterr().out

    whole = train_tool.run(train_tool.parse_args(
        argv + ["--steps", "3", "--logdir", str(tmp_path / "whole")]))
    assert [r["step"] for r in whole["records"]] == [1, 2, 3]
    assert all(r["loader_seconds"] >= 0 and np.isfinite(r["loss"])
               for r in whole["records"])
    assert sorted(os.listdir(tmp_path / "whole" / "images")) == [
        "depth_0000002.jpg", "gt_0000002.jpg", "prob_0000002.jpg"]

    logdir = str(tmp_path / "parts")
    train_tool.run(train_tool.parse_args(argv + ["--steps", "2", "--logdir",
                                                 logdir]))
    assert CheckpointManager(os.path.join(logdir, "ckpt")).latest_step() == 2
    second = train_tool.run(train_tool.parse_args(
        argv + ["--steps", "1", "--resume", "--logdir", logdir]))
    assert "resumed from step 2 (epoch 1)" in capsys.readouterr().out
    assert [r["step"] for r in second["records"]] == [3]
    np.testing.assert_allclose(second["records"][0]["loss"],
                               whole["records"][2]["loss"], rtol=1e-6)
    with pytest.raises(SystemExit):  # one data source, not both
        train_tool.parse_args(argv + ["--synthetic"])
    with pytest.raises(SystemExit):
        train_tool.parse_args(["--device", "cpu"])


def test_train_tool_debug_nans_is_scoped_to_the_run(tmp_path, monkeypatch):
    """--debug-nans runs the loop's steps in autograd's anomaly mode and
    leaves the process's mode as it was (the step is a stand-in that
    records the mode: anomaly mode slows the real one several-fold)."""
    seen = []

    def make_step(*args, **kwargs):
        def step(batch, clip):
            seen.append(torch.is_anomaly_enabled())
            return {k: torch.tensor(1.0)
                    for k in ("loss", "delta_0", "thred_0")}
        return step

    monkeypatch.setattr(train_tool, "make_train_step", make_step)
    argv = ["--synthetic", "--device", "cpu", "--height", str(H), "--width",
            str(W), "--ndepths", str(ND), "--resnet", "18", "--n-frames",
            "3", "--steps", "2", "--num-workers", "1", "--logdir",
            str(tmp_path)]
    assert not torch.is_anomaly_enabled()
    train_tool.run(train_tool.parse_args(argv + ["--debug-nans"]))
    assert seen == [True, True] and not torch.is_anomaly_enabled()
    train_tool.run(train_tool.parse_args(argv))
    assert seen == [True, True, False, False]
