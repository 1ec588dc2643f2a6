"""The port's datasets, their loaders, the length-grouped sampler and the
AnyRes helpers against the JAX package's, on the CPU, exactly.

Every image and annotation file is written by the test: PNG fixtures of a
few sizes, cc3m / COCO (captions and panoptic) / LLaVA / GQA / VQAv2 /
OKVQA / TextVQA / A-OKVQA files, and two HF `datasets` directories in the
InstructPix2Pix and MagicBrush layouts. Where an item draws a prompt from
`random` (the caption and generation banks, `extend_list`,
`InstructionTuningDataset`'s shuffle), `random.seed(s)` is set the same
before each package's call, on one thread. The sampler's index streams
are compared for several seeds, world sizes and `group_by_modality`.
"""

import json
import os
import random

import numpy as np
import pytest

import setok_tpu.data.anyres as janyres
import setok_tpu.data.datasets as jds
import setok_tpu.data.image_processing as jip
import setok_tpu.data.sampler as jsampler
import setok_tpu.data.tokenizer as jtok
from setok_tpu_torch.data import anyres, datasets, image_processing, sampler
from setok_tpu_torch.data.tokenizer import WordTokenizer

SIZES = [(40, 24), (24, 40), (32, 32), (50, 30), (30, 50), (36, 28)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """PNG fixtures and annotation files in every loader's layout."""
    from PIL import Image
    root = tmp_path_factory.mktemp("data")
    img_dir = root / "images"
    img_dir.mkdir()
    rs = np.random.RandomState(0)
    names = []
    for i, (w, h) in enumerate(SIZES):
        name = f"{i}.png"
        Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
            img_dir / name)
        names.append(name)
    # COCO-style files for the VQA / A-OKVQA / GQA / TextVQA name patterns
    for i, (w, h) in enumerate(SIZES[:3]):
        arr = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        Image.fromarray(arr).save(img_dir / f"COCO_train2014_{i:012d}.jpg",
                                  format="PNG")
        Image.fromarray(arr).save(img_dir / f"g{i}.jpg", format="PNG")
        Image.fromarray(arr).save(img_dir / f"t{i}.jpg", format="PNG")

    def dump(name, obj):
        with open(root / name, "w") as f:
            json.dump(obj, f)
        return str(root / name)

    out = {"root": str(root), "images": str(img_dir), "names": names}
    cc3m = [{"image": n, "caption": f"a picture of thing {i} in red"}
            for i, n in enumerate(names)]
    out["cc3m"] = dump("cc3m.json", cc3m)
    os.makedirs(root / "cc3m_dir")
    with open(root / "cc3m_dir" / "a.json", "w") as f:
        json.dump(cc3m[:3], f)
    with open(root / "cc3m_dir" / "b.json", "w") as f:
        json.dump({str(i): r for i, r in enumerate(cc3m[3:])}, f)
    out["cc3m_dir"] = str(root / "cc3m_dir")
    out["coco_caps"] = dump("captions.json", {
        "images": [{"id": i, "file_name": n} for i, n in enumerate(names)],
        "annotations": [{"image_id": i % 5, "caption": f"caption {i}"}
                        for i in range(8)]})
    out["coco_pan"] = dump("panoptic.json", {
        "categories": [{"id": 1, "name": "cat"}, {"id": 2, "name": "sky"}],
        "annotations": [{"image_id": i, "segments_info": [
            {"category_id": 1 + (j % 3)} for j in range(i + 1)]}
            for i in range(4)]})
    out["llava"] = dump("llava.json", [
        {"id": i, "image": n, "conversations": [
            {"from": "human", "value": f"<image>\nWhat is item {i}?"},
            {"from": "gpt", "value": f"It is item {i}."},
            {"from": "human", "value": "Colour?"},
            {"from": "gpt", "value": "Red."}]}
        for i, n in enumerate(names)])
    out["gqa"] = dump("gqa.json", {
        str(i): {"imageId": f"g{i}", "question": f"what is {i}?",
                 "fullAnswer": f"it is {i}."} for i in range(3)})
    qs = {"questions": [{"question_id": 10 + i, "image_id": i,
                         "question": f"how many {i}?"} for i in range(3)]}
    anns = {"annotations": [
        {"question_id": 10, "multiple_choice_answer": "two",
         "answers": [{"answer": "2"}]},
        {"question_id": 11, "answers": [{"answer": "three"}]}]}
    vqa = root / "vqa"
    os.makedirs(vqa)
    for qn, an in (("v2_OpenEnded_mscoco_train2014_questions.json",
                    "v2_mscoco_train2014_annotations.json"),
                   ("OpenEnded_mscoco_train2014_questions.json",
                    "mscoco_train2014_annotations.json")):
        with open(vqa / qn, "w") as f:
            json.dump(qs, f)
        with open(vqa / an, "w") as f:
            json.dump(anns, f)
    out["vqa_dir"] = str(vqa)
    out["vqa_pair"] = (str(vqa / "OpenEnded_mscoco_train2014_questions.json")
                       + "," + str(vqa / "mscoco_train2014_annotations.json"))
    out["textqa"] = dump("textqa.json", {"data": [
        {"image_id": f"t{i}", "question": f"what text {i}?",
         "answers": [f"word{i}"] if i else [], "question_id": i}
        for i in range(3)]})
    out["aokvqa"] = dump("aokvqa.json", [
        {"image_id": 0, "question": "which?", "choices": ["a", "b"],
         "correct_choice_idx": 1},
        {"image_id": 1, "question": "why?", "direct_answers": ["because"]},
        {"image_id": 2, "question": "what?", "question_id": 7}])
    out["edit"] = [{"source_image": str(img_dir / names[i]),
                    "target_image": str(img_dir / names[i + 1]),
                    "instruction": f"make {i} blue"} for i in range(4)]
    return out


def tokenizer_pair():
    return WordTokenizer(512), jtok.WordTokenizer(512)


def assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v)
        else:
            assert got[k] == v, k


def test_record_loaders_as_jax(files):
    f, imf = files, files["images"]
    cases = [
        (datasets.load_cc3m, jds.load_cc3m, (f["cc3m"], imf)),
        (datasets.load_cc3m, jds.load_cc3m, (f["cc3m_dir"], imf)),
        (datasets.load_cc3m, jds.load_cc3m, (f["cc3m"],)),
        (datasets.load_coco, jds.load_coco, (f["coco_caps"], f["coco_pan"],
                                             imf, 2)),
        (datasets.load_coco, jds.load_coco, (f["coco_caps"],)),
        (datasets.load_llava, jds.load_llava, ("llava", f["llava"], imf)),
        (datasets.load_gqa, jds.load_gqa, (f["gqa"], imf)),
        (datasets.load_textqa, jds.load_textqa, (f["textqa"], imf)),
        (datasets.load_aokvqa, jds.load_aokvqa, (f["aokvqa"], imf)),
        (datasets._load_vqa_dispatch, jds._load_vqa_dispatch,
         ("vqav2", f["vqa_dir"], imf)),
        (datasets._load_vqa_dispatch, jds._load_vqa_dispatch,
         ("okvqa", f["vqa_dir"], imf)),
        (datasets._load_vqa_dispatch, jds._load_vqa_dispatch,
         ("okvqa", f["vqa_pair"], imf)),
        (datasets.load_test, jds.load_test, (["a.png", "b.png"],
                                             ["one", "two"])),
    ]
    for fn, jfn, args in cases:
        got = fn(*args)
        assert got == jfn(*args), fn.__name__
        assert got, fn.__name__
    coco = datasets.load_coco(f["coco_caps"], f["coco_pan"], imf, 2)
    assert [r.get("cluster_num") for r in coco] == [1, 2, 2, 2, None]
    assert sorted(datasets.LOADERS) == sorted(jds.LOADERS)


def test_hf_edit_loaders_as_jax(tmp_path, files):
    from datasets import Dataset
    src = [r["source_image"] for r in files["edit"]]
    tgt = [r["target_image"] for r in files["edit"]]
    ins = [r["instruction"] for r in files["edit"]]
    Dataset.from_dict({"original_image": src, "edited_image": tgt,
                       "edit_prompt": ins}).save_to_disk(str(tmp_path / "p"))
    Dataset.from_dict({"source_img": src, "target_img": tgt,
                       "instruction": ins}).save_to_disk(str(tmp_path / "m"))
    for fn, jfn, d in ((datasets.load_instructpix2pix,
                        jds.load_instructpix2pix, "p"),
                       (datasets.load_magicbrush, jds.load_magicbrush, "m")):
        got = fn(str(tmp_path / d))
        assert got == jfn(str(tmp_path / d)) == files["edit"]


@pytest.mark.parametrize("multiple", [1.0, 2.5, 0.5])
def test_extend_list_as_jax(multiple):
    recs = [{"i": i} for i in range(6)]
    random.seed(4)
    got = datasets.extend_list(recs, multiple)
    random.seed(4)
    assert got == jds.extend_list(recs, multiple)
    assert len(got) == int(6 * multiple)


def test_filter_missing_and_concat(files):
    recs = [{"image": os.path.join(files["images"], n)}
            for n in (*files["names"][:2], "missing.png")] + [{"text": "x"}]
    assert datasets.filter_missing_images(recs, num_workers=2) == \
        jds.filter_missing_images(recs, num_workers=2) == \
        [recs[0], recs[1], recs[3]]
    tok, jt = tokenizer_pair()
    parts = [datasets.LazySupervisedDataset(
        datasets.load_llava("llava", files["llava"], files["images"])[a:b],
        tok) for a, b in ((0, 2), (2, 5))]
    jparts = [jds.LazySupervisedDataset(
        jds.load_llava("llava", files["llava"], files["images"])[a:b], jt)
        for a, b in ((0, 2), (2, 5))]
    got, want = datasets.concat_datasets(*parts), jds.concat_datasets(*jparts)
    assert len(got) == len(want) == 5
    assert got.modality_lengths == want.modality_lengths
    for i in (0, 1, 2, 4):
        assert_items_equal(got[i], want[i])


@pytest.mark.parametrize("task", ["caption", "generation", "qa"])
def test_pair_dataset_items_as_jax(files, task):
    tok, jt = tokenizer_pair()
    recs = datasets.load_cc3m(files["cc3m"], files["images"])
    jrecs = jds.load_cc3m(files["cc3m"], files["images"])
    if task == "qa":
        for r in (*recs, *jrecs):
            r.update(question="<image>\nwhat is it?", answer="a thing")
    kw = dict(task_type=task, target_num=3)
    got = datasets.TextImagePairDataset(
        recs, tok, contrastive_tokenizer=WordTokenizer(512),
        image_processor=image_processing.ImageProcessor(size=16),
        gen_processor=image_processing.GeneratorImageProcessor(size=16), **kw)
    want = jds.TextImagePairDataset(
        jrecs, jt, contrastive_tokenizer=jtok.WordTokenizer(512),
        image_processor=jip.ImageProcessor(size=16),
        gen_processor=jip.GeneratorImageProcessor(size=16), **kw)
    assert got.lengths == want.lengths
    assert got.modality_lengths == want.modality_lengths
    for i in range(len(recs)):
        random.seed(10 + i)
        a = got[i]
        random.seed(10 + i)
        assert_items_equal(a, want[i])
    assert a["comp_image"].shape == (16, 16, 3)
    if task == "generation":
        assert a["input_ids"].count(tok.convert_tokens_to_ids("<target>")) \
            == 3


def test_instruction_dataset_mixes_as_jax(files):
    tok, jt = tokenizer_pair()
    tok.add_tokens(["<target>"])
    jt.add_tokens(["<target>"])
    names = ["llava", "gqa", "vqav2", "textqa", "aokvqa"]
    paths = [files["llava"], files["gqa"], files["vqa_dir"], files["textqa"],
             files["aokvqa"]]
    folders = [files["images"]] * len(names)
    mult = [1.5, 1.0, 2.0, 0.7, 1.0]
    kw = dict(image_folders=folders, data_multiple=mult, target_num=2)
    random.seed(21)
    got = datasets.InstructionTuningDataset(
        names, paths, tok,
        image_processor=image_processing.ImageProcessor(size=8), **kw)
    random.seed(21)
    want = jds.InstructionTuningDataset(
        names, paths, jt, image_processor=jip.ImageProcessor(size=8), **kw)
    assert got.records == want.records and len(got) == 21
    assert got.lengths == want.lengths
    for i in range(len(got)):
        assert_items_equal(got[i], want[i])


@pytest.mark.parametrize("native", [False, True])
def test_editing_dataset_items_as_jax(files, native):
    tok, jt = tokenizer_pair()
    got = datasets.EditingDataset(
        files["edit"], tok, target_num=2,
        image_processor=image_processing.ImageProcessor(
            size=12, use_native=native),
        gen_processor=image_processing.GeneratorImageProcessor(
            size=12, use_native=native))
    want = jds.EditingDataset(
        files["edit"], jt, target_num=2,
        image_processor=jip.ImageProcessor(size=12, use_native=native),
        gen_processor=jip.GeneratorImageProcessor(size=12,
                                                  use_native=native))
    for i in range(len(got)):
        random.seed(i)
        a = got[i]
        random.seed(i)
        assert_items_equal(a, want[i])
        assert not np.array_equal(a["comp_image"], a["gen_image"])


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("by_modality", [False, True])
def test_length_grouped_sampler_as_jax(seed, world, by_modality):
    rs = np.random.RandomState(seed + world)
    lengths = rs.randint(1, 200, 37).tolist()
    if by_modality:
        lengths = [-n if i % 3 == 0 else n for i, n in enumerate(lengths)]
    got = sampler.LengthGroupedSampler(4, world, lengths,
                                       group_by_modality=by_modality,
                                       seed=seed)
    want = jsampler.LengthGroupedSampler(4, world, lengths,
                                         group_by_modality=by_modality,
                                         seed=seed)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        idx = list(got)
        assert idx == list(want)
        assert sorted(idx) == list(range(37))
    assert len(got) == 37


def test_sampler_pieces_as_jax():
    lengths = [5, 9, 2, 7, 7, 1, 3, 8]
    for chunks in (2, 3, 4):
        assert sampler.split_to_even_chunks(range(8), lengths, chunks) == \
            jsampler.split_to_even_chunks(range(8), lengths, chunks)
    g, jg = np.random.default_rng(5), np.random.default_rng(5)
    assert sampler.get_length_grouped_indices(lengths, 2, 2, g, merge=False) \
        == jsampler.get_length_grouped_indices(lengths, 2, 2, jg, merge=False)
    mixed = [3, -4, 5, -1, 2, 6, -7]
    assert sampler.get_modality_length_grouped_indices(mixed, 2, 1) == \
        jsampler.get_modality_length_grouped_indices(mixed, 2, 1)


def test_anyres_as_jax(files):
    from PIL import Image
    pins = [(32, 32), (32, 64), (64, 32), (64, 64)]
    images = [Image.open(os.path.join(files["images"], n)).convert("RGB")
              for n in files["names"]]
    proc, jproc = (image_processing.ImageProcessor(size=32),
                   jip.ImageProcessor(size=32))
    for img in images:
        assert anyres.select_best_resolution(img.size, pins) == \
            janyres.select_best_resolution(img.size, pins)
        best = anyres.select_best_resolution(img.size, pins)
        np.testing.assert_array_equal(
            np.asarray(anyres.resize_and_pad_image(img, best)),
            np.asarray(janyres.resize_and_pad_image(img, best)))
        for a, b in zip(anyres.divide_to_patches(img, 16),
                        janyres.divide_to_patches(img, 16)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        got = anyres.process_anyres_image(img, proc, str(pins))
        np.testing.assert_array_equal(
            got, janyres.process_anyres_image(img, jproc, str(pins)))
        assert got.shape[1:] == (32, 32, 3)
        assert anyres.get_anyres_image_grid_shape(img.size, pins, 32) == \
            janyres.get_anyres_image_grid_shape(img.size, pins, 32)
    for mode in ("square", "pad", "anyres"):
        got = anyres.process_images(images, proc, mode, pins)
        want = janyres.process_images(images, jproc, mode, pins)
        assert type(got) is type(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
