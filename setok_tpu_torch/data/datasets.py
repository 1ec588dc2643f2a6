"""Training datasets: text-image pairs, instruction tuning, image editing.

A copy of `setok_tpu/data/datasets.py`: `TextImagePairDataset` (cc3m /
coco / test loaders, caption or generation conversations drawn from the
prompt banks, a second tokenization for the contrastive branch),
`InstructionTuningDataset` (per-dataset loaders and `data_multiple`
mixing), `EditingDataset`, and the `lengths` / `modality_lengths` of
`LazySupervisedDataset` that the grouped sampler reads.

As in the JAX package:
  * `gen_image` is the raw [-1, 1] gold image; the trainers tokenize it
    on the card, so the loader stays host I/O only;
  * COCO panoptic segments are read from the annotation JSON, without
    pycocotools;
  * items are numpy dicts ready for `Collator` (static shapes).
PIL is imported where an image is first opened.
"""

from __future__ import annotations

import glob
import json
import os
import random
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from setok_tpu_torch.data.image_processing import (GeneratorImageProcessor,
                                                   ImageProcessor)
from setok_tpu_torch.data.preprocess import (preprocess,
                                             preprocess_multimodal)


CAPTION_INSTRUCTIONS = [
    "Describe the image.",
    "What does this picture show?",
    "Provide a caption for the photo.",
    "Summarize what appears in this image.",
    "Give a brief description of the image.",
    "What is depicted here?",
    "Write one sentence describing the picture.",
]

GENERATION_RESPONSES = [
    "Here you go.",
    "All set — take a look.",
    "Done. Let me know if it works for you.",
    "Here is the image you asked for.",
    "The generated image is ready.",
    "Voila! Here's your image.",
    "Happy to revise if needed.",
]


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def get_random_captioning_instruction() -> str:
    """Parity: pairDataset.py:227-284 prompt bank."""
    return random.choice(CAPTION_INSTRUCTIONS)


def get_random_generation_response() -> str:
    """Parity: pairDataset.py:181-225 response bank."""
    return random.choice(GENERATION_RESPONSES)


class LazySupervisedDataset:
    """Base: lazy record list + sampler length hints.

    Parity: base_dataset.py:459-538 (`lengths`, `modality_lengths`).
    """

    def __init__(self, records: List[Dict[str, Any]], tokenizer,
                 image_processor: Optional[ImageProcessor] = None,
                 gen_processor: Optional[GeneratorImageProcessor] = None,
                 version: str = "v1", target_num: int = 64,
                 mm_use_im_start_end: bool = False):
        self.records = records
        self.tokenizer = tokenizer
        self.image_processor = image_processor or ImageProcessor()
        self.gen_processor = gen_processor or GeneratorImageProcessor()
        self.version = version
        self.target_num = target_num
        self.mm_use_im_start_end = mm_use_im_start_end

    def __len__(self):
        return len(self.records)

    @staticmethod
    def _text_len(rec: Dict[str, Any]) -> int:
        if "conversations" in rec:
            return sum(len(c["value"].split()) for c in rec["conversations"])
        text = " ".join(str(rec.get(k, ""))
                        for k in ("caption", "question", "answer",
                                  "instruction"))
        return max(len(text.split()), 1)

    @property
    def lengths(self) -> List[int]:
        return [self._text_len(rec) + (128 if "image" in rec else 0)
                for rec in self.records]

    @property
    def modality_lengths(self) -> List[int]:
        return [self._text_len(rec) if "image" in rec
                else -self._text_len(rec) for rec in self.records]

    def _load_image(self, path: str):
        from PIL import Image
        return Image.open(path).convert("RGB")

    def _item_from_conversations(self, rec: Dict[str, Any]
                                 ) -> Dict[str, Any]:
        has_image = "image" in rec
        source = [dict(c) for c in rec["conversations"]]
        if has_image:
            source = preprocess_multimodal(
                [source], target_num=self.target_num,
                mm_use_im_start_end=self.mm_use_im_start_end)[0]
        out = preprocess([source], self.tokenizer, has_image=has_image,
                         version=self.version)
        item: Dict[str, Any] = {"input_ids": out["input_ids"][0],
                                "labels": out["labels"][0]}
        if has_image:
            img = self._load_image(rec["image"])
            item["comp_image"] = self.image_processor(img)
            gen_path = rec.get("gen_image", rec["image"])
            gen_img = (img if gen_path == rec["image"]
                       else self._load_image(gen_path))
            item["gen_image"] = self.gen_processor(gen_img)
        return item

    def __getitem__(self, i: int) -> Dict[str, Any]:
        return self._item_from_conversations(self.records[i])


# ---------------------------------------------------------------------------
# Stage-1/2: text-image pairs


def load_cc3m(data_path: str, image_folder: str = "") -> List[Dict]:
    """Merge a json file or a directory of json files of
    {image, caption} records. Parity: pairDataset.py:35-77."""
    paths = ([data_path] if data_path.endswith(".json")
             else sorted(glob.glob(os.path.join(data_path, "*.json"))))
    records: List[Dict] = []
    for p in paths:
        data = _read_json(p)
        if isinstance(data, dict):
            data = list(data.values())
        for rec in data:
            rec = dict(rec)
            if image_folder and "image" in rec:
                rec["image"] = os.path.join(image_folder, rec["image"])
            records.append(rec)
    return records


def load_coco(caption_json: str, panoptic_json: Optional[str] = None,
              image_folder: str = "", max_segments: int = 74) -> List[Dict]:
    """COCO captions (+ optional panoptic segment names → `phrases`,
    `cluster_num` capped at 74). Parity: pairDataset.py:80-149."""
    cap = _read_json(caption_json)
    id2file = {img["id"]: img["file_name"] for img in cap["images"]}
    id2caps: Dict[int, List[str]] = {}
    for ann in cap["annotations"]:
        id2caps.setdefault(ann["image_id"], []).append(ann["caption"])

    id2phrases: Dict[int, List[str]] = {}
    if panoptic_json:
        pan = _read_json(panoptic_json)
        cat = {c["id"]: c["name"] for c in pan.get("categories", [])}
        for ann in pan.get("annotations", []):
            names = [cat.get(s["category_id"], "thing")
                     for s in ann.get("segments_info", [])]
            id2phrases[ann["image_id"]] = names

    records = []
    for img_id, file_name in id2file.items():
        caps = id2caps.get(img_id)
        if not caps:
            continue
        rec: Dict[str, Any] = {
            "image": os.path.join(image_folder, file_name),
            "caption": caps[0],
        }
        if img_id in id2phrases:
            phrases = id2phrases[img_id][:max_segments]
            rec["phrases"] = phrases
            rec["cluster_num"] = min(len(phrases), max_segments)
        records.append(rec)
    return records


class TextImagePairDataset(LazySupervisedDataset):
    """Caption or generation conversations synthesized from (image, caption)
    pairs. Parity: pairDataset.py:289-471 (max 240k records, line 345)."""

    MAX_RECORDS = 240_000

    def __init__(self, records: List[Dict[str, Any]], tokenizer,
                 contrastive_tokenizer=None, task_type: str = "caption",
                 **kw):
        super().__init__(records[: self.MAX_RECORDS], tokenizer, **kw)
        self.task_type = task_type
        self.contrastive_tokenizer = contrastive_tokenizer

    def __getitem__(self, i: int) -> Dict[str, Any]:
        rec = self.records[i]
        if self.task_type == "caption":
            conversations = [
                {"from": "human",
                 "value": "<image>\n" + get_random_captioning_instruction()},
                {"from": "gpt", "value": rec["caption"]},
            ]
        elif self.task_type == "generation":
            conversations = [
                {"from": "human", "value": "<image>\n" + rec["caption"]},
                {"from": "gpt",
                 "value": "<target>\n" + get_random_generation_response()},
            ]
        else:
            conversations = [
                {"from": "human", "value": rec["question"]},
                {"from": "gpt", "value": rec["answer"]},
            ]
        item = self._item_from_conversations({**rec,
                                              "conversations": conversations})
        if self.contrastive_tokenizer is not None:
            text = rec.get("phrases") or rec["caption"]
            if isinstance(text, list):
                text = ", ".join(text)
            item["input_ids_for_contrastive"] = \
                self.contrastive_tokenizer.encode(text)
        item["caption"] = rec.get("caption", "")
        return item


# ---------------------------------------------------------------------------
# Stage-3: instruction tuning


def load_llava(dataset_name: str, data_path: str,
               image_folder: str = "") -> List[Dict]:
    """LLaVA-format json: records already hold `conversations`.
    Parity: instructDataset.py:17-34 (generic + llava_150k)."""
    records = _read_json(data_path)
    for rec in records:
        rec["dataset"] = dataset_name
        if image_folder and "image" in rec:
            rec["image"] = os.path.join(image_folder, rec["image"])
    return records


def load_gqa(data_path: str, image_folder: str = "") -> List[Dict]:
    """Parity: instructDataset.py:37-70."""
    data = _read_json(data_path)
    records = []
    for _, v in data.items():
        image = os.path.join(image_folder, f"{v['imageId']}.jpg")
        records.append({
            "id": image, "image": image, "dataset": "gqa",
            "conversations": [
                {"from": "human",
                 "value": f"<image>\n{v['question']} Please provide an "
                          "accurate answer consisting of only one word or "
                          "phrase."},
                {"from": "gpt", "value": v["fullAnswer"]},
            ]})
    return records


def load_vqa_pairs(questions_json: str, annotations_json: str,
                   image_folder: str = "", file_pattern: str
                   = "COCO_train2014_{:012d}.jpg",
                   dataset: str = "vqav2") -> List[Dict]:
    """VQAv2/OKVQA-style question+annotation pairs.
    Parity: instructDataset.py:73-117 (VQAv2), 185-229 (OKVQA)."""
    qs = _read_json(questions_json)["questions"]
    anns = {a["question_id"]: a
            for a in _read_json(annotations_json)["annotations"]}
    records = []
    for q in qs:
        ann = anns.get(q["question_id"])
        if ann is None:
            continue
        answer = ann.get("multiple_choice_answer") or \
            ann["answers"][0]["answer"]
        image = os.path.join(image_folder,
                             file_pattern.format(q["image_id"]))
        records.append({
            "id": q["question_id"], "image": image, "dataset": dataset,
            "conversations": [
                {"from": "human",
                 "value": f"<image>\n{q['question']} Please provide an "
                          "accurate answer consisting of only one word or "
                          "phrase."},
                {"from": "gpt", "value": answer},
            ]})
    return records


def load_textqa(data_path: str, image_folder: str = "") -> List[Dict]:
    """TextVQA-style records. Parity: instructDataset.py:120-149."""
    data = _read_json(data_path)
    data = data.get("data", data)
    records = []
    for v in data:
        image = os.path.join(image_folder, v["image_id"] + ".jpg")
        answer = v["answers"][0] if v.get("answers") else ""
        records.append({
            "id": v.get("question_id", image), "image": image,
            "dataset": "textqa",
            "conversations": [
                {"from": "human",
                 "value": f"<image>\n{v['question']} Please provide an "
                          "accurate answer consisting of only one word or "
                          "phrase."},
                {"from": "gpt", "value": answer},
            ]})
    return records


def load_aokvqa(data_path: str, image_folder: str = "") -> List[Dict]:
    """Parity: instructDataset.py:152-182."""
    data = _read_json(data_path)
    records = []
    for v in data:
        image = os.path.join(
            image_folder, "COCO_train2014_{:012d}.jpg".format(v["image_id"]))
        answer = (v["choices"][v["correct_choice_idx"]]
                  if "correct_choice_idx" in v else
                  (v.get("direct_answers") or [""])[0])
        records.append({
            "id": v.get("question_id", image), "image": image,
            "dataset": "aokvqa",
            "conversations": [
                {"from": "human",
                 "value": f"<image>\n{v['question']} Please provide an "
                          "accurate answer consisting of only one word or "
                          "phrase."},
                {"from": "gpt", "value": answer},
            ]})
    return records


def extend_list(records: List[Dict], multiple: float) -> List[Dict]:
    """Repeat/sample a dataset by a (possibly fractional) multiple.
    Parity: instructDataset.py:290-303."""
    out: List[Dict] = []
    whole = int(multiple)
    out.extend(records * whole)
    frac = multiple - whole
    if frac > 0:
        n = int(len(records) * frac)
        out.extend(random.sample(records, n))
    return out


def _load_vqa_dispatch(name: str, data_path: str, image_folder: str = ""):
    """VQAv2/OKVQA entry matching the reference's path convention: a
    directory holding the official question/annotation jsons
    (instructDataset.py:73-81 VQAv2, 185-194 OKVQA), or an explicit
    '<questions.json>,<annotations.json>' pair."""
    if "," in data_path:
        q, a = data_path.split(",", 1)
    elif name == "vqav2":
        a = os.path.join(data_path, "v2_mscoco_train2014_annotations.json")
        q = os.path.join(data_path,
                         "v2_OpenEnded_mscoco_train2014_questions.json")
    else:  # okvqa
        a = os.path.join(data_path, "mscoco_train2014_annotations.json")
        q = os.path.join(data_path,
                         "OpenEnded_mscoco_train2014_questions.json")
    return load_vqa_pairs(q, a, image_folder, dataset=name)


LOADERS = {
    # caption/instruct json datasets all share the llava record shape
    # (instructDataset.py:254-271: load_dataset/load_llava_150k)
    "llava_150k": load_llava,
    "llava": load_llava,
    "llava_cc3m": load_llava,        # LLaVA-CC3M-Pretrain-595K
    "llava_lion": load_llava,        # LLaVA-LION-Pretrain
    "sharegpt4v": load_llava,
    "allava": load_llava,            # ALLaVA-Caption/Instruct-LAION-4V
    "gqa": lambda name, dp, imf="": load_gqa(dp, imf),
    "textqa": lambda name, dp, imf="": load_textqa(dp, imf),
    "aokvqa": lambda name, dp, imf="": load_aokvqa(dp, imf),
    "vqav2": _load_vqa_dispatch,
    "okvqa": _load_vqa_dispatch,
}


class InstructionTuningDataset(LazySupervisedDataset):
    """Mixture of instruction datasets with per-dataset multiples.
    Parity: instructDataset.py:232-313."""

    def __init__(self, dataset_names: Sequence[str],
                 data_paths: Sequence[str], tokenizer,
                 image_folders: Optional[Sequence[str]] = None,
                 data_multiple: Optional[Sequence[float]] = None, **kw):
        image_folders = image_folders or [""] * len(dataset_names)
        records: List[Dict] = []
        for i, (name, path) in enumerate(zip(dataset_names, data_paths)):
            loader = LOADERS.get(name, load_llava)
            part = loader(name, path, image_folders[i])
            if data_multiple is not None:
                part = extend_list(part, data_multiple[i])
            records.extend(part)
        random.shuffle(records)
        super().__init__(records, tokenizer, **kw)


# ---------------------------------------------------------------------------
# Stage-3: image editing


class EditingDataset(LazySupervisedDataset):
    """Instruction-driven editing pairs (InstructPix2Pix / MagicBrush style).

    Parity: editDataset.py:81-284. Records: {"source_image": path,
    "target_image": path, "instruction": str}; the conversation is
    instruction → `<target>` + a random reply (editDataset.py:158-164).
    """

    def __getitem__(self, i: int) -> Dict[str, Any]:
        rec = self.records[i]
        conversations = [
            {"from": "human", "value": "<image>\n" + rec["instruction"]},
            {"from": "gpt",
             "value": "<target>\n" + get_random_generation_response()},
        ]
        full = {"image": rec["source_image"],
                "gen_image": rec["target_image"],
                "conversations": conversations}
        return self._item_from_conversations(full)


def load_test(image_paths: Sequence[str],
              captions: Sequence[str]) -> List[Dict]:
    """Tiny smoke dataset (the reference hard-codes two absolute paths on
    the author's machine, pairDataset.py:164-177; here caller-supplied)."""
    return [{"image": p, "caption": c}
            for p, c in zip(image_paths, captions)]


def load_instructpix2pix(dataset_dir: str) -> List[Dict]:
    """HF `load_from_disk` InstructPix2Pix records → editing records.
    Parity: editDataset.py:81-150. Requires the `datasets` library."""
    from datasets import load_from_disk
    ds = load_from_disk(dataset_dir)
    records = []
    for i in range(len(ds)):
        rec = ds[i]
        records.append({"source_image": rec["original_image"],
                        "target_image": rec["edited_image"],
                        "instruction": rec["edit_prompt"]})
    return records


def load_magicbrush(dataset_dir: str) -> List[Dict]:
    """MagicBrush records (source_img/target_img/instruction).
    Parity: editDataset.py:153-284."""
    from datasets import load_from_disk
    ds = load_from_disk(dataset_dir)
    records = []
    for i in range(len(ds)):
        rec = ds[i]
        records.append({"source_image": rec["source_img"],
                        "target_image": rec["target_img"],
                        "instruction": rec["instruction"]})
    return records


def filter_missing_images(records: List[Dict], num_workers: int = 8,
                          key: str = "image") -> List[Dict]:
    """Drop records whose image file is missing, in parallel.

    The reference's `src/data_preprocess.py` runs this existence filter
    over the ALLaVA json with joblib; here a thread pool does.
    """
    from concurrent.futures import ThreadPoolExecutor

    def exists(rec):
        return rec if (key not in rec or os.path.exists(rec[key])) else None

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        out = list(pool.map(exists, records))
    return [r for r in out if r is not None]


def concat_datasets(*datasets: LazySupervisedDataset):
    """ConcatDataset equivalent (editDataset.py wraps two sources)."""

    class _Concat:
        def __init__(self, parts):
            self.parts = parts
            self.offsets = np.cumsum([0] + [len(p) for p in parts])

        def __len__(self):
            return int(self.offsets[-1])

        def __getitem__(self, i):
            j = int(np.searchsorted(self.offsets, i, side="right") - 1)
            return self.parts[j][i - int(self.offsets[j])]

        @property
        def modality_lengths(self):
            out = []
            for p in self.parts:
                out.extend(p.modality_lengths)
            return out

    return _Concat(list(datasets))
