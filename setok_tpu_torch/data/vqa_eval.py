"""VQA v2 annotation index and query helper, and the standard accuracy.

A copy of `setok_tpu/data/vqa_eval.py` (it imports no JAX): the VQA API's
query surface (by question id, image id, question type and answer type)
and the official 10-annotator soft accuracy with its answer
normalisation.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Sequence

_ARTICLES = {"a", "an", "the"}
_PUNCT = re.compile(r"[;/\[\]\"{}()=+\\_\-><@`,?!.]")


class VQA:
    def __init__(self, annotation_file: Optional[str] = None,
                 question_file: Optional[str] = None):
        self.qa: Dict[int, dict] = {}
        self.qqa: Dict[int, dict] = {}
        self.img_to_qa: Dict[int, List[dict]] = {}
        if annotation_file and question_file:
            anns = json.load(open(annotation_file))["annotations"]
            questions = json.load(open(question_file))["questions"]
            self.create_index(anns, questions)

    def create_index(self, annotations: Sequence[dict],
                     questions: Sequence[dict]) -> None:
        self.qqa = {q["question_id"]: q for q in questions}
        for ann in annotations:
            self.qa[ann["question_id"]] = ann
            self.img_to_qa.setdefault(ann["image_id"], []).append(ann)

    def get_ques_ids(self, img_ids: Sequence[int] = (),
                     ques_types: Sequence[str] = (),
                     ans_types: Sequence[str] = ()) -> List[int]:
        anns = (sum((self.img_to_qa.get(i, []) for i in img_ids), [])
                if img_ids else list(self.qa.values()))
        if ques_types:
            anns = [a for a in anns if a["question_type"] in ques_types]
        if ans_types:
            anns = [a for a in anns if a["answer_type"] in ans_types]
        return [a["question_id"] for a in anns]

    def get_img_ids(self, ques_ids: Sequence[int] = ()) -> List[int]:
        if ques_ids:
            return [self.qa[q]["image_id"] for q in ques_ids if q in self.qa]
        return list(self.img_to_qa)

    def load_qa(self, ids: Sequence[int]) -> List[dict]:
        return [self.qa[i] for i in ids]

    def show_qa(self, anns: Sequence[dict]) -> List[str]:
        out = []
        for ann in anns:
            q = self.qqa[ann["question_id"]]["question"]
            answers = "; ".join(a["answer"] for a in ann["answers"])
            out.append(f"Q: {q}  A: {answers}")
        return out


def normalize_answer(ans: str) -> str:
    """Official VQA normalization (lowercase, strip articles/punct)."""
    ans = ans.lower().replace("\n", " ").replace("\t", " ").strip()
    ans = _PUNCT.sub(" ", ans)
    words = [w for w in ans.split() if w not in _ARTICLES]
    return " ".join(words)


def vqa_accuracy(prediction: str, gt_answers: Sequence[str]) -> float:
    """Soft accuracy: min(#matching annotators / 3, 1), averaged over
    leave-one-out subsets (the official metric)."""
    pred = normalize_answer(prediction)
    gts = [normalize_answer(a) for a in gt_answers]
    if len(gts) <= 1:
        return float(pred in gts)
    accs = []
    for i in range(len(gts)):
        others = gts[:i] + gts[i + 1:]
        accs.append(min(sum(1 for g in others if g == pred) / 3.0, 1.0))
    return sum(accs) / len(accs)
