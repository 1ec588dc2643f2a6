"""The port's evaluation entry points against the JAX package's, on the CPU.

  * `frechet_distance` and `compute_fid` (numpy float64 in both) on the
    same features: within 1e-6 relative;
  * `scripts/eval_recon.py --tiny --cpu --synthetic 4 --fid` at each
    precision (at --image-size 64, for time), both packages on the same
    `.npz` checkpoint written by the JAX package's `save_subtree`: the
    mean cluster counts equal, PSNR and SSIM within 1e-4 relative and FID
    within 1e-3 at fp32, within 1e-2 and 5e-2 at bf16 and quant8 (the JAX
    kernels in interpret mode; `BARS` says why);
  * `scripts/eval_vqa.py --tiny --cpu --synthetic 4`: the predictions
    equal the JAX script's, `load_pretrained_model` monkeypatched in this
    test to hand both sides the same flax weights;
  * `VQA`, `normalize_answer` and `vqa_accuracy` on annotation and question
    files that the test writes: the JAX package's answers;
  * `ImageProcessor` and `GeneratorImageProcessor` on PNGs that the test
    writes: PIL's path equal to the JAX package's bit for bit, and the
    native path (g++) too.
"""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import setok_tpu.data.image_processing as jip
import setok_tpu.data.native as jnative
import setok_tpu.data.vqa_eval as jvqa
import setok_tpu.models.builder as jbuilder
import setok_tpu.utils.metrics as jmetrics
from setok_tpu import config as jcfg
from setok_tpu.models.setok import SeTok as JSeTok
from setok_tpu.models.setokim import Setokim as JSetokim
from setok_tpu.utils import checkpoint as jckpt
from setok_tpu_torch import config as tcfg
from setok_tpu_torch.data import image_processing as tip
from setok_tpu_torch.data import vqa_eval as tvqa
from setok_tpu_torch.models.setok import SeTok
from setok_tpu_torch.models.setokim import Setokim
from setok_tpu_torch.scripts import eval_recon, eval_vqa
from setok_tpu_torch.utils import metrics as tmetrics
from setok_tpu_torch.utils.from_flax import load_flax_params, to_flax_tree
from setok_tpu_torch.utils.init import init_random_
from tests.test_torch_builder import SETOKIM_TREE

ROOT = Path(__file__).resolve().parents[1]
IMAGE_SIZE = 64
# eval_recon's JSON fields: (PSNR and SSIM, FID) max relative gaps. FID's
# covariance of 4 images in 32 dimensions is singular, and the square
# roots of its near-zero eigenvalues amplify last-bit differences. bf16
# compute rounds differently in the two frameworks (the float forward's
# bf16 gap of tests/test_torch_param_dtype.py), and quant8 flips int8 steps
# where a product lands on a rounding edge (the int8 forward's 5e-2 bar);
# the SSIM of a random model's reconstruction is near 0 (~6e-3), so its
# relative gap is the widest (5.4e-4 measured at quant8).
BARS = {"fp32": (1e-4, 1e-3), "quant8": (1e-2, 5e-2),
        "bf16": (1e-2, 5e-2)}


def jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def test_fid_matches_jax():
    rs = np.random.RandomState(0)
    a = rs.randn(40, 16)
    b = rs.randn(40, 16) * 1.3 + 0.2
    ja, jb = jmetrics.FIDStats(16), jmetrics.FIDStats(16)
    ta, tb = tmetrics.FIDStats(16), tmetrics.FIDStats(16)
    for j, t, x in ((ja, ta, a), (jb, tb, b)):
        j.update(x[:25]), j.update(x[25:])
        t.update(x[:25]), t.update(x[25:])
    want = jmetrics.frechet_distance(*ja.finalize(), *jb.finalize())
    got = tmetrics.frechet_distance(*ta.finalize(), *tb.finalize())
    assert abs(got - want) <= 1e-6 * abs(want)
    imgs = rs.rand(12, 4, 4, 3)

    def feats(x):
        return x.reshape(len(x), -1)[:, :8] ** 2
    want = jmetrics.compute_fid(imgs, imgs[::-1] * 0.9, feats, batch_size=5)
    got = tmetrics.compute_fid(imgs, imgs[::-1] * 0.9, feats, batch_size=5)
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.fixture(scope="module")
def setok_npz(tmp_path_factory):
    """A tiny SeTok at the eval CLI's --tiny geometry for IMAGE_SIZE (patch
    IMAGE_SIZE // 4): a port model's seeded weights as a flax tree, written
    whole by the JAX package's save_subtree. The tree also stands in for
    the JAX script's `model.init` (monkeypatched in the test: the file
    overwrites every leaf, and flax's init of SeTok would compile for
    ~17 s a call)."""
    patch = IMAGE_SIZE // 4
    model = init_random_(SeTok(tcfg.tiny_tokenizer(IMAGE_SIZE, patch),
                               tcfg.tiny_detokenizer(IMAGE_SIZE, patch),
                               device="cpu"), 7)
    tree = jax.tree.map(jnp.asarray, to_flax_tree(model))
    path = str(tmp_path_factory.mktemp("eval") / "setok.npz")
    jckpt.save_subtree(path, tree, lambda name: True)
    return path, tree


@pytest.mark.parametrize("precision", ["fp32", "bf16", "quant8"])
def test_eval_recon_matches_jax(setok_npz, precision, monkeypatch, capsys):
    path, tree = setok_npz
    monkeypatch.setattr(JSeTok, "init", lambda self, *a, **k: tree)
    argv = ["--tiny", "--cpu", "--synthetic", "4", "--fid", "--batch-size",
            "2", "--image-size", str(IMAGE_SIZE), "--checkpoint", path,
            "--precision", precision]
    # the JAX CLI's persistent compilation cache stays off: turned on, it
    # would write under $HOME and stay on for the process's later tests
    monkeypatch.setattr(sys, "argv", ["eval_recon.py", *argv,
                                      "--compile-cache", "off"])
    jax_script("eval_recon").main()
    want = last_json(capsys.readouterr().out)
    got = eval_recon.main(argv)
    assert last_json(capsys.readouterr().out) == got
    assert set(got) == set(want)
    assert got["n"] == want["n"] == 4 and got["precision"] == precision
    assert got["mean_clusters"] == want["mean_clusters"]
    rel, fid_rel = BARS[precision]
    for key in ("psnr", "ssim"):
        assert abs(got[key] - want[key]) <= rel * abs(want[key]), key
    assert abs(got["fid_vitfeat"] - want["fid_vitfeat"]) <= \
        fid_rel * abs(want["fid_vitfeat"])


def test_eval_vqa_predictions_match_jax(tmp_path, monkeypatch, capsys):
    params = SETOKIM_TREE
    jm = JSetokim(jcfg.tiny_setokim(), target_token_id=3)
    monkeypatch.setattr(jbuilder, "load_pretrained_model",
                        lambda *a, **k: (jm, jax.tree.map(jnp.asarray,
                                                          params)))
    monkeypatch.setattr(eval_vqa, "load_pretrained_model", lambda *a, **k:
                        load_flax_params(Setokim(tcfg.tiny_setokim(),
                                                 target_token_id=3,
                                                 device="cpu"), params))
    argv = ["--tiny", "--cpu", "--synthetic", "4", "--batch-size", "2",
            "--max-new-tokens", "6"]
    monkeypatch.setattr(sys, "argv", ["eval_vqa.py", *argv, "--out",
                                      str(tmp_path / "jax.json")])
    jax_script("eval_vqa").main()
    got = eval_vqa.main([*argv, "--out", str(tmp_path / "port.json")])
    want = json.load(open(tmp_path / "jax.json"))
    assert json.load(open(tmp_path / "port.json")) == got
    assert got["results"] == want["results"]
    assert got["summary"] == want["summary"]
    assert last_json(capsys.readouterr().out) == want["summary"]


def test_eval_vqa_dataset_mode_raises():
    with pytest.raises(SystemExit, match="dataset mode"):
        eval_vqa.main(["--tiny", "--cpu"])


def test_vqa_api_matches_jax(tmp_path):
    anns = {"annotations": [
        {"question_id": i, "image_id": i // 2,
         "question_type": ["what is", "how many"][i % 2],
         "answer_type": ["other", "number"][i % 2],
         "answers": [{"answer": a} for a in
                     (["A dog.", "dog", "the dog", "cat"] + ["dog"] * 6)]}
        for i in range(6)]}
    qs = {"questions": [{"question_id": i, "image_id": i // 2,
                         "question": f"Q{i}?"} for i in range(6)]}
    (tmp_path / "a.json").write_text(json.dumps(anns))
    (tmp_path / "q.json").write_text(json.dumps(qs))
    j = jvqa.VQA(str(tmp_path / "a.json"), str(tmp_path / "q.json"))
    t = tvqa.VQA(str(tmp_path / "a.json"), str(tmp_path / "q.json"))
    for kw in ({}, {"img_ids": [1, 2]}, {"ques_types": ["how many"]},
               {"ans_types": ["other"]}):
        assert t.get_ques_ids(**kw) == j.get_ques_ids(**kw)
    assert t.get_img_ids([0, 3, 5]) == j.get_img_ids([0, 3, 5])
    assert t.show_qa(t.load_qa([1, 4])) == j.show_qa(j.load_qa([1, 4]))
    gts = ["dog"] * 6 + ["a dog", "Dog!", "cat", "two"]
    for pred in ("Dog", "the  dog.", "cat", "two", "horse", "A-dog"):
        assert tvqa.normalize_answer(pred) == jvqa.normalize_answer(pred)
        assert tvqa.vqa_accuracy(pred, gts) == jvqa.vqa_accuracy(pred, gts)
    assert tvqa.vqa_accuracy("x", ["x"]) == jvqa.vqa_accuracy("x", ["x"])


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    from PIL import Image
    d = tmp_path_factory.mktemp("png")
    rs = np.random.RandomState(5)
    paths = []
    for i, (h, w) in enumerate(((40, 30), (24, 24), (17, 53))):
        arr = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        paths.append(d / f"{i}.png")
        Image.fromarray(arr).save(paths[-1])
    return paths


@pytest.mark.parametrize("native", [False, True], ids=["pil", "native"])
def test_image_processors_match_jax(pngs, native):
    from PIL import Image
    if native:
        assert shutil.which("g++"), "the native path needs g++"
        assert jnative.get_lib() is not None    # no quiet PIL on either side
    imgs = [Image.open(p) for p in pngs]
    for pad in (False, True):
        kw = dict(size=32, pad_to_square=pad, use_native=native)
        jp, tp = jip.ImageProcessor(**kw), tip.ImageProcessor(**kw)
        for im in imgs:
            np.testing.assert_array_equal(tp(im), jp(im))
        np.testing.assert_array_equal(tp.preprocess_batch(imgs),
                                      jp.preprocess_batch(imgs))
    jg = jip.GeneratorImageProcessor(size=20, use_native=native)
    tg = tip.GeneratorImageProcessor(size=20, use_native=native)
    for im in imgs:
        out = tg(im)
        assert out.shape == (20, 20, 3) and out.dtype == np.float32
        np.testing.assert_array_equal(out, jg(im))
