"""The port's loaders, its training CLIs' real-data flags and its metrics
log against the JAX package's, on the CPU.

  * `BatchLoader`: the batches and their order equal the JAX loader's
    (seeds, `drop_last`, a sampler), also with more worker threads than
    cores and a short switch interval;
  * `DeviceLoader` on the CPU: tensors equal to the host arrays, the
    passthrough leaves, a loader error raised to the consumer after the
    batches before it (as the JAX loader does), and a consumer that stops
    early stopping the prefetch thread;
  * `host_shard`: explicit ranks, no process group, a gloo group of one
    and a patched rank 1 of 3;
  * `MetricsLogger` / `build_logger`: the JAX package's records;
  * `scripts/train_setok.py --data-path` and `scripts/train_setokim.py`
    with each `--task-type`, `--cpu --tiny`: 2 updates with finite metrics
    and a `metrics.jsonl`; their first batch equal to the one the JAX data
    classes build from the same arguments (one worker, `random.seed` set
    before each); the flags that stay refused.
"""

import json
import os
import random
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

import setok_tpu.data.collator as jcollator
import setok_tpu.data.datasets as jds
import setok_tpu.data.image_processing as jip
import setok_tpu.data.loader as jloader
import setok_tpu.data.tokenizer as jtok
import setok_tpu.utils.logging as jlogging
from setok_tpu_torch import config as cfgs
from setok_tpu_torch.data import loader
from setok_tpu_torch.data.collator import Collator
from setok_tpu_torch.data.sampler import LengthGroupedSampler
from setok_tpu_torch.scripts import train_setok, train_setokim
from setok_tpu_torch.utils import logging as plogging
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


class ToyDataset:
    """Items keyed by index: an id row, an image and a passthrough."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rs = np.random.RandomState(i)
        return {"input_ids": [1, *rs.randint(10, 99, 2 + i % 4).tolist()],
                "comp_image": rs.rand(4, 4, 3), "tag": f"item{i}"}


def same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(g[k], v)
                assert g[k].dtype == v.dtype
            else:
                assert g[k] == v


@pytest.mark.parametrize("seed,drop_last,workers", [(0, True, 1),
                                                    (3, False, 2),
                                                    (5, True, 4)])
def test_batch_loader_as_jax(seed, drop_last, workers):
    ds, col = ToyDataset(11), Collator(max_len=8, k_max=2)
    got = loader.BatchLoader(ds, 3, col, num_workers=workers, seed=seed,
                             drop_last=drop_last)
    want = jloader.BatchLoader(ds, 3, jcollator.Collator(max_len=8, k_max=2),
                               num_workers=workers, seed=seed,
                               drop_last=drop_last)
    same_batches(list(got), list(want))
    assert len(got) == len(want) == 3
    assert len(list(got)) == (3 if drop_last else 4)


def test_batch_loader_with_a_sampler_as_jax():
    ds = ToyDataset(13)
    lengths = [len(ds[i]["input_ids"]) for i in range(13)]
    col = Collator(max_len=8, k_max=2)
    got = loader.BatchLoader(ds, 4, col, sampler=LengthGroupedSampler(
        4, 1, lengths, seed=2), num_workers=2)
    want = jloader.BatchLoader(ds, 4, col, sampler=LengthGroupedSampler(
        4, 1, lengths, seed=2), num_workers=2)
    same_batches(list(got), list(want))


def test_batch_loader_under_thread_stress():
    """More workers than cores, a short switch interval: the batches equal
    one worker's, in order."""
    ds, col = ToyDataset(64), Collator(max_len=8, k_max=2)
    one = list(loader.BatchLoader(ds, 4, col, num_workers=1, seed=7))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        many = list(loader.BatchLoader(ds, 4, col,
                                       num_workers=4 * os.cpu_count(),
                                       seed=7))
    finally:
        sys.setswitchinterval(old)
    same_batches(many, one)


def host_batches(n: int, fail_at=None):
    rs = np.random.RandomState(0)
    for i in range(n):
        if i == fail_at:
            raise KeyError(f"record {i} is broken")
        yield {"input_ids": rs.randint(0, 9, (2, 5)),
               "image": rs.rand(2, 3, 3).astype(np.float32),
               "mask": rs.rand(2, 5) > 0.5, "caption": [f"c{i}", "d"]}


def test_device_loader_on_the_cpu():
    want = list(host_batches(5))
    got = list(loader.DeviceLoader(host_batches(5), "cpu", prefetch=1))
    assert len(got) == 5
    for g, w in zip(got, want):
        assert g["caption"] == w["caption"]
        for k in ("input_ids", "image", "mask"):
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])
            assert g[k].dtype == torch.from_numpy(w[k]).dtype
    passed = list(loader.DeviceLoader(host_batches(3)))
    same_batches(passed, list(host_batches(3)))


@pytest.mark.parametrize("device", [None, "cpu"])
def test_device_loader_raises_loader_errors(device):
    """The batches before the error arrive, then the error, as from the
    JAX loader."""
    def drain(dl):
        seen = []
        with pytest.raises(KeyError, match="record 2 is broken"):
            for b in dl:
                seen.append(b["caption"])
        return seen

    got = drain(loader.DeviceLoader(host_batches(5, fail_at=2), device))
    want = drain(jloader.DeviceLoader(host_batches(5, fail_at=2)))
    assert got == want == [["c0", "d"], ["c1", "d"]]


def test_device_loader_stops_when_the_consumer_does():
    closed = threading.Event()

    def endless():
        try:
            while True:
                yield {"x": np.zeros(3)}
        finally:
            closed.set()

    before = set(threading.enumerate())
    it = iter(loader.DeviceLoader(endless(), "cpu", prefetch=2))
    assert next(it)["x"].shape == (3,)
    assert len(set(threading.enumerate()) - before) == 1
    t = time.monotonic()
    it.close()
    assert closed.wait(timeout=10)
    assert time.monotonic() - t < 10
    assert not [th for th in set(threading.enumerate()) - before
                if th.is_alive()]


def test_host_shard(monkeypatch):
    idx = list(range(10))
    for pi, pc in ((0, 1), (1, 3), (2, 4)):
        assert loader.host_shard(idx, pi, pc) == jloader.host_shard(idx, pi,
                                                                    pc)
    assert loader.host_shard(idx) == idx
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        assert loader.host_shard(idx) == idx
        monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 3)
        assert loader.host_shard(idx) == [1, 4, 7]
    finally:
        monkeypatch.undo()
        torch.distributed.destroy_process_group()


def test_metrics_logger_as_jax(tmp_path, capsys):
    recs = []
    for mod, name in ((plogging, "port"), (jlogging, "jax")):
        path = tmp_path / name / "metrics.jsonl"
        log = mod.MetricsLogger(str(path), print_every=2)
        for step in range(3):
            log.log(step, {"loss": np.float32(1.5 / (step + 1)),
                           "n": torch.tensor(step)}, tag="x")
        log.close()
        with open(path) as f:
            recs.append([{k: v for k, v in json.loads(x).items()
                          if k not in ("time", "step_time")} for x in f])
    assert recs[0] == recs[1] and len(recs[0]) == 3
    out = capsys.readouterr().out.splitlines()
    assert [x.split(" (")[0] for x in out[:2]] == \
        [x.split(" (")[0] for x in out[2:]]
    lg = plogging.build_logger("port_test_logger", "t.log", str(tmp_path))
    lg.info("hello")
    with open(tmp_path / "t.log") as f:
        assert "hello" in f.read()
    for h in list(lg.handlers):
        lg.removeHandler(h)


# ---------------------------------------------------------------------------
# the CLIs' real-data flags


@pytest.fixture(scope="module")
def data_files(tmp_path_factory):
    """8 PNGs of 40 x 30, a cc3m json, a LLaVA json and an edit json."""
    from PIL import Image
    root = tmp_path_factory.mktemp("cli")
    img = root / "images"
    img.mkdir()
    rs = np.random.RandomState(1)
    for i in range(8):
        Image.fromarray(rs.randint(0, 256, (30, 40, 3)).astype(np.uint8)) \
            .save(img / f"{i}.png")
    files = {"images": str(img)}
    recs = {
        "cc3m": [{"image": f"{i}.png", "caption": f"a red thing {i}"}
                 for i in range(8)],
        "llava": [{"id": i, "image": f"{i}.png", "conversations": [
            {"from": "human", "value": f"<image>\nWhat is {i}?"},
            {"from": "gpt", "value": f"Thing {i}."}]} for i in range(6)],
        "edit": [{"source_image": str(img / f"{i}.png"),
                  "target_image": str(img / f"{i + 1}.png"),
                  "instruction": f"make {i} blue"} for i in range(6)]}
    for name, r in recs.items():
        files[name] = str(root / f"{name}.json")
        with open(files[name], "w") as f:
            json.dump(r, f)
    return files


def stage1_argv(files, *extra):
    return ["--cpu", "--tiny", "--data-path", files["cc3m"],
            "--image-folder", files["images"], "--batch-size", "2",
            "--image-size", "32", "--disc-start", "0", "--num-workers", "1",
            *extra]


TASKS = {"instruction": lambda f: ["--dataset-name", "llava", "--data-path",
                                   f["llava"], "--image-folder",
                                   f["images"]],
         "pair": lambda f: ["--data-path", f["cc3m"], "--image-folder",
                            f["images"]],
         "edit": lambda f: ["--data-path", f["edit"]]}


def stage2_argv(files, task, *extra):
    return ["--cpu", "--tiny", "--task-type", task, *TASKS[task](files),
            "--batch-size", "2", "--model-max-length", "48",
            "--lora-enable", "--lora-r", "4", "--warmup-steps", "1",
            "--num-workers", "1", *extra]


def read_run(capsys, out_dir):
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        logged = [json.loads(x) for x in f]
    return lines, logged


def check_run(lines, logged):
    assert [x["step"] for x in lines] == [x["step"] for x in logged] == [0, 1]
    assert lines[-1]["updates"] == 2
    for x, y in zip(lines, logged):
        assert all(np.isfinite(v) for k, v in x.items() if k != "seconds")
        assert {k: v for k, v in x.items()
                if k not in ("seconds", "updates")} == \
            {k: v for k, v in y.items() if k not in ("time", "step_time")}


def test_train_setok_reads_files(data_files, tmp_path, capsys):
    out = str(tmp_path / "run")
    train_setok.main(stage1_argv(data_files, "--steps", "2",
                                 "--output-dir", out))
    check_run(*read_run(capsys, out))


def first_batch(stream):
    it = iter(stream)
    batch = next(it)
    it.close()                  # stop the prefetch thread (it draws too)
    return {k: v.numpy() for k, v in batch.items()}


def jax_first_batch(ds, batch: int, collate):
    b = next(iter(jloader.BatchLoader(ds, batch, collate, num_workers=1,
                                      seed=0)))
    return {k: v for k, v in b.items() if isinstance(v, np.ndarray)}


def test_train_setok_first_batch_is_jax(data_files):
    args = train_setok.parse_args(stage1_argv(data_files, "--task-type",
                                              "generation"))
    random.seed(31)
    tr, stream = train_setok.build(args)
    assert tr.use_text_encoder
    got = first_batch(stream)
    random.seed(31)
    tok = jtok.load_text_tokenizer(None, vocab_size=32000)
    ds = jds.TextImagePairDataset(
        jds.load_cc3m(data_files["cc3m"], data_files["images"]), tok,
        contrastive_tokenizer=jtok.load_text_tokenizer(None, 32000),
        task_type="generation",
        image_processor=jip.ImageProcessor(size=32, use_native=True),
        gen_processor=jip.GeneratorImageProcessor(size=32, use_native=True))
    want = jax_first_batch(ds, 2, jcollator.Collator(
        max_len=77, k_max=tr.tokenizer_cfg.k_max))
    same_batches([got], [want])
    assert "input_ids_for_contrastive" in got


@pytest.mark.parametrize("task", sorted(TASKS))
def test_train_setokim_reads_files(task, data_files, tmp_path, capsys):
    out = str(tmp_path / "run")
    train_setokim.main(stage2_argv(data_files, task, "--steps", "2",
                                   "--use-flash", "--output-dir", out))
    check_run(*read_run(capsys, out))


@pytest.mark.parametrize("task", sorted(TASKS))
def test_train_setokim_first_batch_is_jax(task, data_files):
    """The JAX CLI's dataset for each task, built from the same arguments.
    (`--image-folder` for the pair task: the JAX CLI drops it there, the
    port passes it to `load_cc3m`.)"""
    args = train_setokim.parse_args(stage2_argv(data_files, task,
                                                "--no-native-preprocess"))
    random.seed(41)
    tr, stream = train_setokim.build(args)
    got = first_batch(stream)
    cfg = cfgs.tiny_setokim()
    random.seed(41)
    tok = jtok.load_text_tokenizer(None, vocab_size=cfg.llama.vocab_size - 8)
    tok.add_tokens(["<target>"], special_tokens=True)
    assert tr.target_token_id == tok.convert_tokens_to_ids("<target>")
    size = cfg.tokenizer.vit.image_size
    kw = dict(image_processor=jip.ImageProcessor(size=size),
              gen_processor=jip.GeneratorImageProcessor(size=size),
              target_num=cfg.target_num)
    if task == "pair":
        ds = jds.TextImagePairDataset(
            jds.load_cc3m(data_files["cc3m"], data_files["images"]), tok,
            task_type="generation", **kw)
    elif task == "edit":
        with open(data_files["edit"]) as f:
            ds = jds.EditingDataset(json.load(f), tok, **kw)
    else:
        ds = jds.InstructionTuningDataset(
            ["llava"], [data_files["llava"]], tok,
            image_folders=[data_files["images"]], **kw)
    want = jax_first_batch(ds, 2, jcollator.Collator(
        max_len=48, k_max=cfg.tokenizer.k_max))
    same_batches([got], [want])
    n_target = int((got["labels"] == tr.target_token_id).sum())
    assert n_target == (0 if task == "instruction" else 2 * cfg.target_num)


def test_epochs_refuse_a_dataset_smaller_than_a_batch():
    """The CLIs' endless stream raises instead of spinning on empty
    epochs."""
    col = Collator(max_len=8, k_max=2)
    stream = loader.DeviceLoader(train_setok.epochs(loader.BatchLoader(
        ToyDataset(3), 4, col, num_workers=1), seed=0), "cpu")
    with pytest.raises(ValueError, match="3 records make no batch of 4"):
        next(iter(stream))
    two = iter(train_setok.epochs(loader.BatchLoader(ToyDataset(5), 4, col),
                                  seed=0))
    first, second = next(two), next(two)
    assert first["input_ids"].shape == second["input_ids"].shape == (4, 8)


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    """torchvision vgg16 + LPIPS heads in the HF layout, through the
    port's `vgg16` and `lpips_lins` porters into one .npz; and the
    state dict."""
    import chip_smoke
    from setok_tpu_torch.scripts import port_weights
    sd = chip_smoke.hf_vgg_lpips_state(torch.Generator().manual_seed(9))
    np_sd = {k: v.numpy() for k, v in sd.items()}
    path = tmp_path_factory.mktemp("lpips") / "lpips.npz"
    np.savez(path, **port_weights.port_vgg16(np_sd),
             **port_weights.port_lpips_lins(np_sd))
    return str(path), sd


# the names of the refusal cases are kept: both flags run now
@pytest.mark.parametrize("argv,match", [
    (["--lpips-weights", "vgg.npz"], "not ported"),
    (["--compile-cache", "cache"], "not ported")])
def test_train_setok_still_refuses(argv, match, data_files, lpips_npz,
                                   tmp_path, monkeypatch):
    """The real-data CLI's build: --lpips --lpips-weights loads the ported
    VGG and heads into the trainer's LPIPS (every tensor equal to its
    torchvision / LPIPS source), and a resume without the flag restores
    them from the checkpoint; --compile-cache sets the kernels' build
    directory. (Without --lpips the file is ignored, as in JAX: the
    synthetic case in tests/test_torch_stage1.py; trained steps with the
    flags: chip_smoke.py's `weights` phase.)"""
    import chip_smoke
    from setok_tpu_torch.kernels import _build
    from setok_tpu_torch.utils import checkpoint as ckpt
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    if argv[0] == "--compile-cache":
        train_setok.build(train_setok.parse_args(stage1_argv(
            data_files, "--compile-cache", str(tmp_path / "cache"))))
        assert _build.BUILD_DIR == tmp_path / "cache"
        assert (tmp_path / "cache").is_dir()
        return
    path, sd = lpips_npz
    out = str(tmp_path / "run")
    trainer, _ = train_setok.build(train_setok.parse_args(stage1_argv(
        data_files, "--lpips", "--lpips-weights", path)))
    sources = chip_smoke.lpips_sources(sd)
    assert chip_smoke.spliced_gap(trainer.lpips, sources)["max_abs"] == 0.0
    gen = torch.Generator().manual_seed(1)
    ckpt.save_checkpoint(os.path.join(out, "checkpoints"), 1,
                         trainer.full_state_dict({"dropout": gen}))
    args = train_setok.parse_args(stage1_argv(data_files, "--lpips",
                                              "--output-dir", out))
    fresh, _ = train_setok.build(args)
    assert chip_smoke.spliced_gap(fresh.lpips, sources)["max_abs"] > 0.0
    train_setok.resume(fresh, os.path.join(out, "checkpoints"),
                       {"dropout": torch.Generator()}, fresh.device)
    assert chip_smoke.spliced_gap(fresh.lpips, sources)["max_abs"] == 0.0


@pytest.mark.parametrize("argv", [
    ["--tensor-parallel", "2", "--sequence-parallel", "2"],
    ["--synthetic"], []])
def test_train_setokim_still_refuses(argv, data_files):
    """The parallel flags together are refused (one trunk mesh, as in
    JAX); --synthetic and --data-path are exclusive; the instruction task
    wants a --dataset-name per path."""
    base = stage2_argv(data_files, "edit")
    if not argv:
        base = stage2_argv(data_files, "instruction")
        base.remove("--dataset-name")
        base.remove("llava")
    with pytest.raises(SystemExit):
        train_setokim.parse_args([*base, *argv])


@pytest.mark.parametrize("argv", [["--tensor-parallel", "2"],
                                  ["--sequence-parallel", "2"]])
def test_train_setokim_parallel_flags_run(argv, data_files, capsys):
    """Each parallel flag runs over the real-data stream; in one process
    its mesh has size 1 (under torchrun: tests/test_torch_parallel_cli.py;
    a data rank's rows: BatchLoader(shard=))."""
    train_setokim.main(stage2_argv(data_files, "edit", "--steps", "1",
                                   *argv))
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["step"] for x in lines] == [0]


def test_batch_loader_shard_takes_a_data_ranks_rows():
    col = Collator(max_len=8, k_max=2)
    whole = list(loader.BatchLoader(ToyDataset(8), 4, col, num_workers=1))
    parts = [list(loader.BatchLoader(ToyDataset(8), 4, col, num_workers=1,
                                     shard=(r, 2))) for r in range(2)]
    for i, b in enumerate(whole):
        got = np.concatenate([parts[r][i]["input_ids"] for r in range(2)])
        np.testing.assert_array_equal(got, b["input_ids"])
    rows = loader.batch_rows({"x": np.arange(8), "s": "keep"}, 1, 4)
    assert rows["x"].tolist() == [2, 3] and rows["s"] == "keep"
    assert loader.host_shard(range(10), 1, 3) == [1, 4, 7]
